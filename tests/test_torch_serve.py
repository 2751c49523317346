"""The slice as a whole: the port's calibrated serving path against the
JAX package's, at smoke size, on the reference's own weights
(``T.init_params(PRNGKey(0), SMOKE)`` carried across with
interop.params_from_numpy).

Steps, both quant modes: prequantize -> calibrate_decode (token by token
through the unfused dynamic qdot) -> apply_calibration -> attach_comp_cols
-> fuse_projections -> fused full-sequence prefill -> greedy decode.

  * Calibration: the port's CalibrationTable against the reference's.
    Site keys, counts and weight histograms are equal; lo/hi/amax agree
    to rtol 1e-4 (measured 1.5e-5 asym_u8, 4.7e-7 sym_i8).  The gap is
    float32 reassociation, not quantization: the compensation sums are
    taken in another order by torch than by XLA, and the asym zero-point
    algebra subtracts terms near 1e6 to leave results near 1e3, which
    turns an ulp of the large terms into ~1e-5 of the result.  The test
    counts the dynamic quantization steps that flip (measured 0; held to
    0.1%) and reports the histograms' difference.
  * Serving: both packages serve from the REFERENCE's table JSON, so the
    static scales are identical.  Greedy ids are identical.  Every cache
    leaf matches in bf16 within check.check_rows (one bf16 step, on at
    most 1% of entries: float32 ulps of rope/rmsnorm or of the projection
    straddling a bf16 rounding edge; measured 0 entries apart).
    Logits agree to atol 2e-6 (measured 2.1e-7 with |logit| <= 0.6: a
    few float32 ulps).  The test reports the logit gap and counts the
    flipped static quantization steps of every qdot site (measured 0;
    held to 0.1%).

The port's prefill is compared with the reference's prefill (not with
the reference's token loop, which is not bit-identical to its prefill
for prequant asym_u8).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
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
from repro_torch.calib import observe as tobserve
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels.check import check_rows
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import fuse_projections as t_fuse
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq
from repro_torch.train import make_prefill_step as t_prefill
from repro_torch.train import make_serve_step as t_step

ARCH = "qwen3-1.7b"
B, P, GEN = 2, 5, 4


class _Recorder:
    """A qdot observer for either package: keeps each call's activations
    and the static quantizer it ran with, per site."""

    unroll = True            # the reference's pscan unrolls under it

    def __init__(self):
        self._idx, self.calls = [], {}

    def push(self, i):
        self._idx.append(i)

    def pop(self):
        self._idx.pop()

    def record(self, x, pre, cfg):
        key = pre.path + "@" + ".".join(map(str, self._idx))
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        sx = np.asarray(pre.act_scale, np.float32).reshape(())
        zx = (np.asarray(pre.act_zp, np.float32).reshape(())
              if pre.act_zp is not None else np.float32(0.0))
        self.calls.setdefault(key, []).append((x, sx, zx, cfg.signed))


def _qx(x, sx, zx, signed):
    lo, hi = (-128, 127) if signed else (0, 255)
    return np.clip(np.round(x / sx) + zx, lo, hi)


def _qx_dynamic(x, signed):
    """qdot's dynamic per-call quantizer, in float32 numpy."""
    f = np.float32
    if signed:
        sx = np.maximum(np.abs(x).max() / f(127.0), f(1e-8))
        return _qx(x, sx, f(0.0), True)
    lo, hi = x.min(), x.max()
    sx = np.maximum((hi - lo) / f(255.0), f(1e-8))
    return _qx(x, sx, np.clip(np.round(-lo / sx), f(0), f(255)), False)


def _recording(observer_cls):
    """A subclass of a package's calibration Observer that also keeps
    each call's activations per site (installed while calibrate_decode
    runs, so the table and the activations come from the same pass)."""
    class Recording(observer_cls):
        xs = {}              # one dict per _recording() call

        def record(self, x, pre, cfg):
            super().record(x, pre, cfg)
            key = pre.path + "@" + ".".join(map(str, self._idx))
            x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            self.xs.setdefault(key, []).append(x)
    return Recording


def _flips(xs_r, xs_t, signed):
    """(flipped steps, total, max |dx|) of the dynamic quantizer."""
    flips = total = 0
    worst = 0.0
    for key, calls in xs_r.items():
        for xr, xt in zip(calls, xs_t[key], strict=True):
            flips += int((_qx_dynamic(xt, signed)
                          != _qx_dynamic(xr, signed)).sum())
            total += xr.size
            worst = max(worst, float(np.abs(xt - xr).max()))
    return flips, total, worst


@pytest.fixture(scope="module")
def base():
    cfg_r = rconfigs.get_smoke(ARCH)
    pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj),
                                   tconfigs.get_smoke(ARCH), device="cpu")
    return cfg_r, tconfigs.get_smoke(ARCH), pj, pt


def _serve_trees(base, mode):
    cfg_r, cfg_t, pj, pt = base
    rq = RQ(design="design2", backend="fused", mode=mode, inference=True)
    tq = TQ(design="design2", backend="fused", mode=mode, inference=True)
    sj, st = r_preq(pj, rq), t_preq(pt, tq)
    cal = np.random.default_rng(4242).integers(
        0, cfg_r.vocab, (B, P)).astype(np.int32)
    rec_r, rec_t = _recording(robserve.Observer), _recording(tobserve.Observer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(robserve, "Observer", rec_r)
        mp.setattr(tobserve, "Observer", rec_t)
        table_r = rcalib.calibrate_decode(sj, cfg_r, rq, cal, gen_len=2)
        table_t = tcalib.calibrate_decode(st, cfg_t, tq, cal, gen_len=2,
                                          device="cpu")
    calib_flips = _flips(rec_r.xs, rec_t.xs, mode == "sym_i8")
    # both serve from the reference's table, through its JSON
    text = json.dumps(table_r.to_json())
    tab_j = rcalib.CalibrationTable.from_json(json.loads(text))
    tab_t = interop.table_from_json(text)
    sj = rcalib.attach_comp_cols(rcalib.apply_calibration(sj, tab_j), rq)
    st = tcalib.attach_comp_cols(tcalib.apply_calibration(st, tab_t), tq)
    return (table_r, table_t, r_fuse(sj), t_fuse(st), rq, tq, calib_flips)


@pytest.fixture(scope="module", params=["asym_u8", "sym_i8"])
def served(request, base):
    return request.param, _serve_trees(base, request.param)


def test_calibration_tables_agree(served):
    mode, (table_r, table_t, *_rest, (flips, total, dx)) = served
    assert table_t.mode == table_r.mode == mode
    assert sorted(table_t.sites) == sorted(table_r.sites)
    assert "units.0.attn.wq@1" in table_t.sites
    hist_gap, rel = 0, 0.0
    for k, r in table_r.sites.items():
        t = table_t.sites[k]
        for f in ("lo", "hi", "amax"):
            rel = max(rel, abs(t[f] - r[f]) / max(abs(r[f]), 1e-30))
        assert t["count"] == r["count"]
        np.testing.assert_array_equal(t["hist_w"], r["hist_w"])
        hist_gap += int(np.abs(t["hist_x"] - r["hist_x"]).sum())
    print(f"\n[{mode}] calibration: lo/hi/amax within {rel:.3e} relative; "
          f"{flips} of {total} dynamic activation steps flipped, max "
          f"|x_port - x_ref| = {dx:.3e}; histograms: {hist_gap} of "
          f"{sum(int(s['count']) for s in table_r.sites.values())} "
          f"activation counts in another bin")
    assert rel <= 1e-4
    assert flips <= 1e-3 * total


def _run_ref(cfg, tree, qcfg, prompts):
    prefill, step = jax.jit(r_prefill(cfg, qcfg)), jax.jit(r_step(cfg, qcfg))
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


def test_serve_matches_reference(served, base):
    mode, (_, _, sj, st, rq, tq, _) = served
    cfg_r, cfg_t = base[0], base[1]
    prompts = np.random.default_rng(0).integers(
        0, cfg_r.vocab, (B, P)).astype(np.int32)
    ids_r, pf_r, dec_r, caches_r = _run_ref(cfg_r, sj, rq, prompts)
    ids_t, pf_t, dec_t, caches_t = _run_port(cfg_t, st, tq, prompts)
    np.testing.assert_array_equal(ids_t, ids_r)
    gap = max(np.abs(pf_t - pf_r).max(), np.abs(dec_t - dec_r).max())
    print(f"\n[{mode}] logits: max |port - reference| = {gap:.3e} "
          f"(max |logit| {np.abs(pf_r).max():.3f})")
    np.testing.assert_allclose(pf_t, pf_r, rtol=0, atol=2e-6)
    np.testing.assert_allclose(dec_t, dec_r, rtol=0, atol=2e-6)
    for name in ("k", "v"):
        got = caches_t[0][name].float().numpy()
        want = np.asarray(jnp.asarray(caches_r[0][name], jnp.float32))
        flips = int((got != want).sum())
        print(f"[{mode}] cache {name}: {flips} of {got.size} bf16 entries "
              f"one step apart")
        check_rows(torch.tensor(got), torch.tensor(want))
    np.testing.assert_array_equal(caches_t[0]["idx"].numpy(),
                                  caches_r[0]["idx"])


def test_quantization_flips_are_rare(served, base):
    """Record every qdot call of one prefill + one decode step in both
    packages (eagerly, under an observer) and count the quantized
    activation steps that differ."""
    mode, (_, _, sj, st, rq, tq, _) = served
    cfg_r, cfg_t = base[0], base[1]
    prompts = np.random.default_rng(0).integers(
        0, cfg_r.vocab, (B, P)).astype(np.int32)
    rec_r, rec_t = _Recorder(), _Recorder()
    rlin.set_observer(rec_r)
    try:
        sr = RT.init_decode_state(cfg_r, B, P + 2)
        tok, _, sr = r_prefill(cfg_r, rq)(sj, sr, jnp.asarray(prompts))
        r_step(cfg_r, rq)(sj, sr, tok)
    finally:
        rlin.set_observer(None)
    tlin.set_observer(rec_t)
    try:
        with torch.no_grad():
            s2 = TT.init_decode_state(cfg_t, B, P + 2, device="cpu")
            tok, _, s2 = t_prefill(cfg_t, tq)(st, s2,
                                              torch.from_numpy(prompts))
            t_step(cfg_t, tq)(st, s2, torch.from_numpy(np.asarray(tok)))
    finally:
        tlin.set_observer(None)
    assert sorted(rec_t.calls) == sorted(rec_r.calls)
    flips = total = 0
    worst = 0.0
    for key, calls_r in rec_r.calls.items():
        for (xr, sx, zx, sg), (xt, sx2, zx2, _) in zip(calls_r,
                                                      rec_t.calls[key]):
            assert sx == sx2 and zx == zx2
            flips += int((_qx(xt, sx, zx, sg) != _qx(xr, sx, zx, sg)).sum())
            total += xr.size
            worst = max(worst, float(np.abs(xt - xr).max()))
    print(f"\n[{mode}] {flips} of {total} quantized activations flipped a "
          f"step; max |x_port - x_ref| = {worst:.3e}")
    assert flips <= 1e-3 * total
