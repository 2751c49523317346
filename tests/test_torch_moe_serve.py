"""The calibrated serving path of the MoE family (mixtral-8x7b and
llama4-scout-17b-a16e) against the JAX package's, at smoke size, on the
reference's own weights (tests/test_torch_moe.py holds moe() alone).

Steps, both configs in both modes: prequantize -> calibrate_decode
(token by token through the unfused dynamic qdot; experts named
``@layer.expert``) -> apply_calibration -> attach_comp_cols ->
fuse_projections -> fused full-sequence prefill -> greedy decode.

Tolerances, and why (gaps measured on these sizes and inputs):
  * Calibration: the same site names, counts and weight histograms,
    lo/hi/amax within rtol 1e-4 (tests/test_torch_serve.py's bound;
    measured at most 6.3e-7), 0 dynamic steps flipped.  Sites of an expert that saw only padding
    rows (lo = hi = 0) occur and are equal in both tables.
  * Serving, both packages from the reference's table: greedy ids equal,
    caches within check_rows (measured bit-equal), logits within atol
    2e-6 (measured at most 2.1e-7), and every static quantization step of
    one prefill and one decode step equal (0 flipped).
  * An expert whose calibration saw only padding rows (lo = hi = 0, so
    its scale is the 1e-8 floor), set by hand in the reference's table
    and then sent real rows: ids, logits and caches as above.
The reference calibrates op by op (its eager, unrolled decode step), so
calibration runs on 2 prompts of 2 tokens plus one greedy step.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calib as rcalib
from repro.calib import observe as robserve
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
from repro_torch.kernels.check import check_rows
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import fuse_projections as t_fuse
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq
from repro_torch.train import make_prefill_step as t_prefill
from repro_torch.train import make_serve_step as t_step
from test_torch_moe import (ARCHS, MODES, _count_flips, _np,  # noqa: F401
                            _observing, _Recorder, bases)

B, P, GEN = 2, 4, 3                 # served requests, prompt, generated
CAL_P, CAL_GEN = 2, 1               # calibration prompt and greedy steps
_JITTED: dict = {}                  # (arch, mode) -> the reference's steps


def _recording(observer_cls):
    """A package's calibration Observer that also keeps each call's
    activations per site."""
    class Recording(observer_cls):
        xs = {}

        def record(self, x, pre, cfg):
            super().record(x, pre, cfg)
            key = pre.path + "@" + ".".join(map(str, self._idx))
            self.xs.setdefault(key, []).append(
                (_np(x), None, None, cfg.signed))
    return Recording


def _calibrate_both(base, mode):
    cfg_r, cfg_t, pj, pt = base
    rq = RQ(design="design2", backend="fused", mode=mode, inference=True)
    tq = TQ(design="design2", backend="fused", mode=mode, inference=True)
    sj, st = r_preq(pj, rq), t_preq(pt, tq)
    cal = np.random.default_rng(4242).integers(
        0, cfg_r.vocab, (B, CAL_P)).astype(np.int32)
    rec_r, rec_t = _recording(robserve.Observer), _recording(tobserve.Observer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(robserve, "Observer", rec_r)
        mp.setattr(tobserve, "Observer", rec_t)
        table_r = rcalib.calibrate_decode(sj, cfg_r, rq, cal,
                                          gen_len=CAL_GEN)
        table_t = tcalib.calibrate_decode(st, cfg_t, tq, cal,
                                          gen_len=CAL_GEN, device="cpu")
    flips = _count_flips(rec_r.xs, rec_t.xs, static=False)
    return dict(rq=rq, tq=tq, sj=sj, st=st, table_r=table_r,
                table_t=table_t, calib_flips=flips)


def _install(c, table_json):
    """Both packages' serving trees from one table's JSON text."""
    tab_j = rcalib.CalibrationTable.from_json(json.loads(table_json))
    tab_t = interop.table_from_json(table_json)
    sj = rcalib.attach_comp_cols(rcalib.apply_calibration(c["sj"], tab_j),
                                 c["rq"])
    st = tcalib.attach_comp_cols(tcalib.apply_calibration(c["st"], tab_t),
                                 c["tq"])
    return r_fuse(sj), t_fuse(st)


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS
                                        for m in MODES],
                ids=lambda am: f"{am[0]}-{am[1]}")
def calibrated(request, bases):
    arch, mode = request.param
    return arch, mode, _calibrate_both(bases[arch], mode)


def test_calibration_tables_agree(calibrated, bases):
    arch, mode, c = calibrated
    cfg = bases[arch][1]
    table_r, table_t = c["table_r"], c["table_t"]
    flips, total, dx = c["calib_flips"]
    assert table_t.mode == table_r.mode == mode
    assert sorted(table_t.sites) == sorted(table_r.sites)
    per_layer = 5 + (3 if cfg.mlp_kind == "swiglu" else 2) * cfg.n_experts \
        + (3 if cfg.shared_expert_ff else 0)
    assert len(table_t.sites) == per_layer * cfg.n_layers
    assert f"units.0.moe.w_up@1.{cfg.n_experts - 1}" in table_t.sites
    assert "units.0.moe.router@1" in table_t.sites
    cov = tcalib.coverage(c["st"], table_t)
    assert cov["missing"] == [] and cov["sites_expected"] == len(
        table_t.sites)
    rel, hist_gap = 0.0, 0
    for k, r in table_r.sites.items():
        t = table_t.sites[k]
        for f in ("lo", "hi", "amax"):
            rel = max(rel, abs(t[f] - r[f]) / max(abs(r[f]), 1e-30))
        assert t["count"] == r["count"]
        np.testing.assert_array_equal(t["hist_w"], r["hist_w"])
        hist_gap += int(np.abs(t["hist_x"] - r["hist_x"]).sum())
    degenerate = sorted(k for k, s in table_r.sites.items()
                        if s["lo"] == s["hi"] == 0.0)
    print(f"\n[{arch} {mode}] calibration: {len(table_t.sites)} sites, "
          f"lo/hi/amax within {rel:.3e} relative; {flips} of {total} "
          f"dynamic steps flipped (max |dx| {dx:.3e}); {hist_gap} "
          f"activation counts in another bin; sites that saw only zero "
          f"rows: {degenerate}")
    assert rel <= 1e-4
    assert flips == 0


def _run_ref(cfg, tree, qcfg, prompts):
    key = (cfg.name, qcfg.mode)
    if key not in _JITTED:        # compiled once per config and mode
        _JITTED[key] = (jax.jit(r_prefill(cfg, qcfg)),
                        jax.jit(r_step(cfg, qcfg)))
    prefill, step = _JITTED[key]
    st = RT.init_decode_state(cfg, B, P + GEN)
    tok, lg_pf, st = prefill(tree, st, jnp.asarray(prompts))
    toks, lgs = [np.asarray(tok)], []
    for _ in range(GEN - 1):
        tok, lg, st = step(tree, st, tok)
        toks.append(np.asarray(tok))
        lgs.append(np.asarray(lg))
    return (np.concatenate(toks, 1), np.asarray(lg_pf),
            np.concatenate(lgs, 1), jax.tree.map(np.asarray, st["caches"]))


def _run_port(cfg, tree, qcfg, prompts):
    prefill, step = t_prefill(cfg, qcfg), t_step(cfg, qcfg)
    st = TT.init_decode_state(cfg, B, P + GEN, device="cpu")
    with torch.no_grad():
        tok, lg_pf, st = prefill(tree, st, torch.from_numpy(prompts))
        toks, lgs = [tok.numpy()], []
        for _ in range(GEN - 1):
            tok, lg, st = step(tree, st, tok)
            toks.append(tok.numpy())
            lgs.append(lg.numpy())
    return (np.concatenate(toks, 1), lg_pf.numpy(), np.concatenate(lgs, 1),
            st["caches"])


def _static_flips(base, sj, st, rq, tq, prompts):
    """Record every qdot call of one prefill and one decode step in both
    packages (eagerly, under an observer) and count the static
    quantization steps that differ."""
    cfg_r, cfg_t = base[0], base[1]
    with _observing(rlin, _Recorder()) as rec_r:
        sr = RT.init_decode_state(cfg_r, B, P + 2)
        tok, _, sr = r_prefill(cfg_r, rq)(sj, sr, jnp.asarray(prompts))
        r_step(cfg_r, rq)(sj, sr, tok)
    with _observing(tlin, _Recorder()) as rec_t, torch.no_grad():
        s2 = TT.init_decode_state(cfg_t, B, P + 2, device="cpu")
        tok, _, s2 = t_prefill(cfg_t, tq)(st, s2, torch.from_numpy(prompts))
        t_step(cfg_t, tq)(st, s2, torch.from_numpy(np.asarray(tok)))
    return _count_flips(rec_r.calls, rec_t.calls), rec_t.calls


def _serve_and_compare(base, tag, sj, st, rq, tq, prompts, flips=True):
    """Serve both trees and compare ids, logits and caches; with
    ``flips`` also count the static steps that flip over a prefill and a
    decode step (both packages recorded), else record the port alone.
    Returns the port's recorded qdot calls."""
    cfg_r, cfg_t = base[0], base[1]
    ids_r, pf_r, dec_r, caches_r = _run_ref(cfg_r, sj, rq, prompts)
    with _observing(tlin, _Recorder()) as rec_t:
        ids_t, pf_t, dec_t, caches_t = _run_port(cfg_t, st, tq, prompts)
    gap = max(np.abs(pf_t - pf_r).max(), np.abs(dec_t - dec_r).max())
    apart = {}
    for name in ("k", "v"):
        got = caches_t[0][name].float().numpy()
        want = np.asarray(jnp.asarray(caches_r[0][name], jnp.float32))
        apart[name] = int((got != want).sum())
        check_rows(torch.tensor(got), torch.tensor(want))
    n, total, dx = 0, 0, 0.0
    if flips:
        (n, total, dx), _ = _static_flips(base, sj, st, rq, tq, prompts)
    print(f"\n[{tag}] ids {ids_t.tolist()}; max |logit gap| {gap:.3e} (max "
          f"|logit| {np.abs(pf_r).max():.3f}); cache entries apart {apart}"
          + (f"; {n} of {total} static steps flipped (max |dx| {dx:.3e})"
             if flips else ""))
    np.testing.assert_array_equal(ids_t, ids_r)
    np.testing.assert_allclose(pf_t, pf_r, rtol=0, atol=2e-6)
    np.testing.assert_allclose(dec_t, dec_r, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(caches_t[0]["idx"].numpy(),
                                  caches_r[0]["idx"])
    assert n == 0
    return rec_t.calls


def test_calibrated_serve_matches_reference(calibrated, bases):
    arch, mode, c = calibrated
    base = bases[arch]
    sj, st = _install(c, json.dumps(c["table_r"].to_json()))
    # the merged projections: wqkv, and the shared expert's w_gateup
    unit = st["units"][0]
    assert "wqkv" in unit["attn"]
    assert "w_gateup" not in unit["moe"] and "w_gate" in unit["moe"]
    if base[1].shared_expert_ff:
        assert "w_gateup" in unit["moe"]["shared"]
    prompts = np.random.default_rng(0).integers(
        0, base[0].vocab, (B, P)).astype(np.int32)
    _serve_and_compare(base, f"{arch} {mode}", sj, st, c["rq"], c["tq"],
                       prompts)


def test_expert_with_a_degenerate_range_serves_as_reference(calibrated,
                                                            bases):
    """Expert 1's sites of layer 0 as if its calibration had seen only
    padding (zero) rows: lo = hi = amax = 0, so its static scale is the
    1e-8 floor; served rows then quantize to the ends of the grid."""
    arch, mode, c = calibrated
    base = bases[arch]
    d = c["table_r"].to_json()
    hit = []
    for k, s in d["sites"].items():
        if k.startswith("units.0.moe.w_") and k.endswith("@0.1"):
            s.update(lo=0.0, hi=0.0, amax=0.0)
            hit.append(k)
    assert len(hit) == (3 if base[1].mlp_kind == "swiglu" else 2)
    sj, st = _install(c, json.dumps(d))
    w = st["units"][0]["moe"]["w_up"]
    assert float(w.act_scale[0, 1]) == np.float32(1e-8)
    prompts = np.random.default_rng(1).integers(
        0, base[0].vocab, (B, P)).astype(np.int32)
    calls = _serve_and_compare(base, f"{arch} {mode} degenerate expert",
                               sj, st, c["rq"], c["tq"], prompts,
                               flips=False)
    # the expert received real (nonzero) rows at its 1e-8 scale
    rows = np.concatenate([x.reshape(-1, x.shape[-1]) for x, *_ in
                           calls["units.0.moe.w_up@0.1"]])
    assert (np.abs(rows).max(1) > 0).any()


