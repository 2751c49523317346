"""The calibrated serve of whisper-small (encoder-decoder) against the JAX
package's, at smoke size, on the reference's own weights
(tests/test_torch_encdec.py holds the encoder and the cross block alone).

Steps, both modes: prequantize -> calibrate_decode (the encoder over the
calibration frames, then token by token, every step's cross blocks
projecting the encoder output's k and v again) -> apply_calibration ->
attach_comp_cols -> fuse_projections (the decoder units only: the
encoder's and the cross blocks' wq/wk/wv stay apart) -> the encoder over
the requests' frames -> fused full-sequence prefill -> greedy decode.

Tolerances, and why (gaps measured on these sizes and inputs):
  * Calibration (the reference op by op, its eager unrolled pass): the
    same 32 site names (2 encoder layers of 6, 2 decoder layers of 6 and
    4 cross), counts and weight histograms, lo/hi/amax within CAL_RTOL
    (4.2e-7, the bound the other families' tables met), 0 dynamic steps
    flipped.
  * Serving, both packages from the reference's table, the reference op
    by op (jax.disable_jit): greedy ids equal, the KV caches bit-equal,
    the encoder output within 4 float32 ulps of its largest magnitude,
    logits within atol 2e-6, 0 static steps flipped over the encoder, a
    prefill and a decode step.
  * serve.main of both packages (the port on the reference's params and
    table, the reference jitted), asym_u8: the calibration frames and
    prompts, the serve frames and the greedy ids equal; --continuous refused by
    both with the same NotImplementedError.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calib as rcalib
from repro.calib import observe as robserve
from repro.launch import serve as rserve
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import fuse_projections as r_fuse
from repro.quant import linear as rlin
from repro.quant import prequantize_weights as r_preq
from repro.train import make_prefill_step as r_prefill
from repro.train import make_serve_step as r_step
from repro_torch import calib as tcalib
from repro_torch import interop
from repro_torch.calib import observe as tobserve
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import fuse_projections as t_fuse
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq
from repro_torch.train import make_prefill_step as t_prefill
from repro_torch.train import make_serve_step as t_step
from test_torch_encdec import ARCH, OUT_RTOL, base  # noqa: F401
from test_torch_moe import MODES, _count_flips, _observing, _Recorder
from test_torch_moe_serve import _recording
from test_torch_serve_options import _ref_params

# served requests, prompt and generated tokens; calibration's prompt and
# greedy steps: serve.main's (--requests 2 --prompt-len 3 --gen-len 4,
# calibrate_decode's gen_len 2), so the reference's op-by-op runs share
# their compiled ops
B, P, GEN = 2, 3, 4
CAL_P, CAL_GEN = 3, 2
FRAMES = tserve.ENC_FRAMES          # encoder frames a request carries
CAL_RTOL = 4.2e-7


def _frames(rng, cfg):
    return rng.normal(size=(B, FRAMES, cfg.frontend_dim or cfg.d_model)
                      ).astype(np.float32)


@pytest.fixture(scope="module", params=MODES)
def calibrated(request, base):
    """Both packages' calibration from the same frames and prompts (drawn
    as serve draws them: the frames first), each call's activations
    recorded per site."""
    mode = request.param
    cfg_r, cfg_t, pj, pt = base
    rq = RQ(design="design2", backend="fused", mode=mode, inference=True)
    tq = TQ(design="design2", backend="fused", mode=mode, inference=True)
    sj, st = r_preq(pj, rq), t_preq(pt, tq)
    crng = np.random.default_rng(4242)
    fr = _frames(crng, cfg_r)
    cal = crng.integers(0, cfg_r.vocab, (B, CAL_P)).astype(np.int32)
    rec_r, rec_t = _recording(robserve.Observer), _recording(tobserve.Observer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(robserve, "Observer", rec_r)
        mp.setattr(tobserve, "Observer", rec_t)
        with jax.disable_jit():
            table_r = rcalib.calibrate_decode(sj, cfg_r, rq, cal,
                                              gen_len=CAL_GEN,
                                              enc_frontend=fr)
        table_t = tcalib.calibrate_decode(st, cfg_t, tq, cal,
                                          gen_len=CAL_GEN, device="cpu",
                                          enc_frontend=fr)
    return dict(mode=mode, rq=rq, tq=tq, sj=sj, st=st, table_r=table_r,
                table_t=table_t,
                calib_flips=_count_flips(rec_r.xs, rec_t.xs, static=False))


def test_calibration_tables_agree(calibrated, base):
    cfg = base[1]
    mode, table_r, table_t = (calibrated[k] for k in ("mode", "table_r",
                                                       "table_t"))
    flips, total, dx = calibrated["calib_flips"]
    assert table_t.mode == table_r.mode == mode
    assert sorted(table_t.sites) == sorted(table_r.sites)
    assert len(table_t.sites) == 6 * cfg.enc_layers + 10 * cfg.n_layers \
        == 32
    for site in ("enc.layers.attn.wq@1", "enc.layers.mlp.w_down@0",
                 "enc.cross.attn.wk@1", "enc.cross.attn.wo@0",
                 "units.0.attn.wv@1"):
        assert site in table_t.sites
    cov = tcalib.coverage(calibrated["st"], table_t)
    assert cov["missing"] == [] and cov["sites_expected"] == 32
    rel = 0.0
    for k, r in table_r.sites.items():
        t = table_t.sites[k]
        for f in ("lo", "hi", "amax"):
            rel = max(rel, abs(t[f] - r[f]) / max(abs(r[f]), 1e-30))
        assert t["count"] == r["count"]
        np.testing.assert_array_equal(t["hist_w"], r["hist_w"])
    print(f"\n[whisper {mode}] calibration: {len(table_t.sites)} sites, "
          f"lo/hi/amax within {rel:.3e} relative; {flips} of {total} "
          f"dynamic steps flipped (max |dx| {dx:.3e})")
    assert rel <= CAL_RTOL
    assert flips == 0


def _install(c):
    """Both packages' serving trees from the reference's table."""
    table_json = json.dumps(c["table_r"].to_json())
    tab_j = rcalib.CalibrationTable.from_json(json.loads(table_json))
    tab_t = interop.table_from_json(table_json)
    sj = rcalib.attach_comp_cols(rcalib.apply_calibration(c["sj"], tab_j),
                                 c["rq"])
    st = tcalib.attach_comp_cols(tcalib.apply_calibration(c["st"], tab_t),
                                 c["tq"])
    return r_fuse(sj), t_fuse(st)


def _run_ref(cfg, tree, qcfg, prompts, frames):
    """The reference's encoder, prefill and greedy steps, op by op."""
    with jax.disable_jit():
        enc = RT._run_encoder(tree, jnp.asarray(frames), cfg, qcfg)
        st = RT.init_decode_state(cfg, B, P + GEN, enc_out=enc)
        tok, lg_pf, st = r_prefill(cfg, qcfg)(tree, st, jnp.asarray(prompts))
        toks, lgs = [np.asarray(tok)], []
        for _ in range(GEN - 1):
            tok, lg, st = r_step(cfg, qcfg)(tree, st, tok)
            toks.append(np.asarray(tok))
            lgs.append(np.asarray(lg))
    return (np.concatenate(toks, 1), np.asarray(lg_pf),
            np.concatenate(lgs, 1), np.asarray(enc),
            jax.tree.map(np.asarray, st["caches"]))


def _run_port(cfg, tree, qcfg, prompts, frames):
    with torch.no_grad():
        enc = TT._run_encoder(tree, torch.from_numpy(frames), cfg, qcfg)
        st = TT.init_decode_state(cfg, B, P + GEN, device="cpu",
                                  enc_out=enc)
        tok, lg_pf, st = t_prefill(cfg, qcfg)(tree, st,
                                              torch.from_numpy(prompts))
        toks, lgs = [tok.numpy()], []
        for _ in range(GEN - 1):
            tok, lg, st = t_step(cfg, qcfg)(tree, st, tok)
            toks.append(tok.numpy())
            lgs.append(lg.numpy())
    return (np.concatenate(toks, 1), lg_pf.numpy(),
            np.concatenate(lgs, 1), enc.numpy(),
            st["caches"])


def test_calibrated_serve_matches_reference(calibrated, base):
    cfg_r, cfg_t = base[0], base[1]
    mode = calibrated["mode"]
    sj, st = _install(calibrated)
    assert "wqkv" in st["units"][0]["attn"]
    assert {"wq", "wk", "wv"} <= set(st["enc"]["layers"]["attn"])
    assert {"wq", "wk", "wv"} <= set(st["enc"]["cross"]["attn"])
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg_r.vocab, (B, P)).astype(np.int32)
    frames = _frames(rng, cfg_r)
    rq, tq = calibrated["rq"], calibrated["tq"]
    # every static step of the encoder, the prefill and the decode steps
    with _observing(rlin, _Recorder()) as rec_r:
        ids_r, pf_r, dec_r, enc_r, caches_r = _run_ref(cfg_r, sj, rq,
                                                       prompts, frames)
    with _observing(tlin, _Recorder()) as rec_t:
        ids_t, pf_t, dec_t, enc_t, caches_t = _run_port(cfg_t, st, tq,
                                                        prompts, frames)
    flips, total, dx = _count_flips(rec_r.calls, rec_t.calls)
    gap = max(np.abs(pf_t - pf_r).max(), np.abs(dec_t - dec_r).max())
    apart = {}
    for name in ("k", "v"):
        got = caches_t[0][name].float().numpy()
        want = np.asarray(jnp.asarray(caches_r[0][name], jnp.float32))
        apart[name] = int((got != want).sum())
    enc_gap = float(np.abs(enc_t - enc_r).max())
    print(f"\n[whisper {mode}] ids {ids_t.tolist()}; encoder output max "
          f"|gap| {enc_gap:.3e}; max |logit gap| {gap:.3e}; cache entries "
          f"apart {apart}; {flips} of {total} static steps flipped (max "
          f"|dx| {dx:.3e})")
    np.testing.assert_array_equal(ids_t, ids_r)
    assert apart == {"k": 0, "v": 0}
    np.testing.assert_array_equal(caches_t[0]["idx"].numpy(),
                                  caches_r[0]["idx"])
    assert enc_gap <= OUT_RTOL * float(np.abs(enc_r).max())
    np.testing.assert_allclose(pf_t, pf_r, rtol=0, atol=2e-6)
    np.testing.assert_allclose(dec_t, dec_r, rtol=0, atol=2e-6)
    assert flips == 0


def _recording_calls(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def rec(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    monkeypatch.setattr(module, name, rec)


def test_serve_main_matches_reference(base, monkeypatch):
    """serve.main --calibrate 1 (asym_u8) of both packages: the port on the
    reference's params, serving from the reference's table beside its
    own calibration.  The calibration draws its frames before its
    prompts and serve draws its frames after the prompts, so both
    packages hand their encoders the same frames and calibrate on the
    same prompts; the greedy ids equal."""
    argv = ["--arch", ARCH, "--smoke", "--requests", str(B), "--prompt-len",
            str(P), "--gen-len", str(GEN), "--calibrate", "1"]
    cal_r, cal_t, enc_r, enc_t = [], [], [], []
    real_r, real_t = rcalib.calibrate_decode, tcalib.calibrate_decode

    def record(*a, **k):
        cal_r.append((a, k, real_r(*a, **k)))
        return cal_r[-1][2]

    def reference_table(*a, **k):
        cal_t.append((a, k))
        real_t(*a, **k)
        return interop.table_from_json(json.dumps(cal_r[-1][2].to_json()))

    monkeypatch.setattr(rcalib, "calibrate_decode", record)
    # what its init_params(PRNGKey(0), SMOKE) draws, drawn once already
    monkeypatch.setattr(RT, "init_params", lambda rng, cfg: base[2])
    _recording_calls(monkeypatch, RT, "_run_encoder", enc_r)
    with jax.disable_jit():
        ids_r, _ = rserve.main(argv)
    monkeypatch.setattr(tcalib, "calibrate_decode", reference_table)
    monkeypatch.setattr(TT, "init_params", _ref_params(base[2]))
    _recording_calls(monkeypatch, TT, "_run_encoder", enc_t)
    ids_t, logits = tserve.main(argv + ["--device", "cpu"])
    assert len(cal_t) == len(cal_r) == 1
    np.testing.assert_array_equal(cal_t[0][0][3], cal_r[0][0][3])
    np.testing.assert_array_equal(cal_t[0][1]["enc_frontend"],
                                  cal_r[0][1]["enc_frontend"])
    # calibration's encoder, then serve's
    assert len(enc_t) == len(enc_r) == 2
    for (a_t, _), (a_r, _) in zip(enc_t, enc_r):
        np.testing.assert_array_equal(a_t[1].numpy(), np.asarray(a_r[1]))
    assert tuple(enc_t[-1][0][1].shape) == (B, FRAMES, base[1].d_model)
    print(f"\n[whisper serve.main] ids {ids_t.tolist()}")
    assert np.isfinite(logits).all()
    np.testing.assert_array_equal(ids_t, ids_r)


def test_continuous_is_refused_as_the_reference_refuses_it(base,
                                                          monkeypatch):
    argv = ["--arch", ARCH, "--smoke", "--requests", "2", "--prompt-len",
            "3", "--gen-len", "4", "--continuous", "3"]
    with pytest.raises(NotImplementedError) as r:
        rserve.main(argv)
    monkeypatch.setattr(TT, "init_params", _ref_params(base[2]))
    with pytest.raises(NotImplementedError) as t:
        tserve.main(argv + ["--device", "cpu"])
    assert str(t.value) == str(r.value)
    assert "encdec" in str(t.value)
