"""The calibrated serve of the recurrent families (recurrentgemma-2b,
xlstm-125m) against the JAX package's, at smoke size, on the reference's
own weights (tests/test_torch_recurrent.py holds the blocks alone).

Steps, both configs in both modes: prequantize -> calibrate_decode
(token by token, recurrent state carried) -> apply_calibration ->
attach_comp_cols -> fuse_projections -> fused full-sequence prefill ->
greedy decode.

Tolerances, and why (gaps measured on these sizes and inputs):
  * Calibration: the same site names, counts and weight histograms,
    lo/hi/amax within rtol 1e-4, 0 dynamic steps flipped.
  * Serving, both packages from the reference's table, the reference op
    by op (xlstm's with fuse_projections off: the reference's merge takes
    its mLSTM's wq/wk/wv, which it then cannot find; the port's merge
    leaves them): greedy ids equal, KV caches within check_rows
    (measured bit-equal), logits within atol 2e-6, 0 static steps
    flipped, the conv state bit-equal and the float recurrent states
    within STATE_RTOL (3 float32 ulps) of their largest magnitude
    (measured at most 1.8e-7, sLSTM's n; the gap printed: torch's exp,
    log1p, sigmoid and tanh are not XLA's, and torch's einsum sums in
    another order).
  * serve --continuous 3 over 2 slots (the reference jitted): its ids.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calib as rcalib
from repro.launch import serve as rserve
from repro.models import transformer as RT
from repro.quant import fuse_projections as r_fuse
from repro.train import make_prefill_step as r_prefill
from repro.train import make_serve_step as r_step
from repro_torch import calib as tcalib
from repro_torch import interop
from repro_torch.kernels.check import check_rows
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.quant import fuse_projections as t_fuse
from repro_torch.train import make_prefill_step as t_prefill
from repro_torch.train import make_serve_step as t_step
from test_torch_moe import MODES
from test_torch_moe_serve import _calibrate_both, _static_flips
from test_torch_recurrent import (ARCHS, B, GEN, P,  # noqa: F401
                                  _assert_close, _sites_per_layer, bases)
from test_torch_serve_options import _ref_params


# ---------------------------------------------------------------------------
# the calibrated serve
# ---------------------------------------------------------------------------

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
    assert len(table_t.sites) == _sites_per_layer(cfg)
    cov = tcalib.coverage(c["st"], table_t)
    assert cov["missing"] == [] and cov["sites_expected"] == len(
        table_t.sites)
    rel = 0.0
    for k, r in table_r.sites.items():
        t = table_t.sites[k]
        for f in ("lo", "hi", "amax"):
            rel = max(rel, abs(t[f] - r[f]) / max(abs(r[f]), 1e-30))
        assert t["count"] == r["count"]
        np.testing.assert_array_equal(t["hist_w"], r["hist_w"])
    print(f"\n[{arch} {mode}] calibration: {len(table_t.sites)} sites, "
          f"lo/hi/amax within {rel:.3e} relative; {flips} of {total} "
          f"dynamic steps flipped (max |dx| {dx:.3e})")
    assert rel <= 1e-4
    assert flips == 0


def _install(c, table_json, fuse_ref: bool):
    """Both packages' serving trees from one table's JSON text; the port
    always merges (its mLSTM keeps wq/wk/wv apart), the reference only
    where ``fuse_ref``."""
    tab_j = rcalib.CalibrationTable.from_json(json.loads(table_json))
    tab_t = interop.table_from_json(table_json)
    sj = rcalib.attach_comp_cols(rcalib.apply_calibration(c["sj"], tab_j),
                                 c["rq"])
    st = tcalib.attach_comp_cols(tcalib.apply_calibration(c["st"], tab_t),
                                 c["tq"])
    return (r_fuse(sj) if fuse_ref else sj), t_fuse(st)


def _run_ref(cfg, tree, qcfg, prompts):
    """The reference's prefill and greedy steps, op by op."""
    with jax.disable_jit():
        st = RT.init_decode_state(cfg, B, P + GEN)
        tok, lg_pf, st = r_prefill(cfg, qcfg)(tree, st, jnp.asarray(prompts))
        toks, lgs = [np.asarray(tok)], []
        for _ in range(GEN - 1):
            tok, lg, st = r_step(cfg, qcfg)(tree, st, tok)
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


def test_calibrated_serve_matches_reference(calibrated, bases):
    arch, mode, c = calibrated
    base = bases[arch]
    cfg_r, cfg_t = base[0], base[1]
    fuse_ref = arch != "xlstm-125m"
    sj, st = _install(c, json.dumps(c["table_r"].to_json()), fuse_ref)
    if arch == "xlstm-125m":        # the port's merge leaves the mLSTM
        assert {"wq", "wk", "wv"} <= set(st["units"][0]["mlstm"])
    else:
        assert "wqkv" in st["units"][2]["attn"]
        assert "w_gateup" in st["units"][0]["mlp"]
    prompts = np.random.default_rng(0).integers(
        0, cfg_r.vocab, (B, P)).astype(np.int32)
    ids_r, pf_r, dec_r, caches_r = _run_ref(cfg_r, sj, c["rq"], prompts)
    ids_t, pf_t, dec_t, caches_t = _run_port(cfg_t, st, c["tq"], prompts)
    gap = max(np.abs(pf_t - pf_r).max(), np.abs(dec_t - dec_r).max())
    (n, total, dx), _ = _static_flips(base, sj, st, c["rq"], c["tq"],
                                      prompts)
    print(f"\n[{arch} {mode}] ids {ids_t.tolist()}; max |logit gap| "
          f"{gap:.3e}; {n} of {total} static steps flipped (max |dx| "
          f"{dx:.3e})")
    for slot, kind in enumerate(cfg_t.pattern):
        for k in sorted(caches_r[slot]):
            got = caches_t[slot][k]
            want = caches_r[slot][k]
            if k in ("k", "v"):
                w32 = np.asarray(jnp.asarray(want, jnp.float32))
                apart = int((got.float().numpy() != w32).sum())
                print(f"  slot {slot} ({kind}) cache {k}: {apart} entries "
                      f"apart")
                check_rows(got.float(), torch.tensor(w32))
            elif k == "idx":
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                _assert_close(f"slot {slot} ({kind}) state {k}", got, want,
                              exact=k == "conv")
    np.testing.assert_array_equal(ids_t, ids_r)
    np.testing.assert_allclose(pf_t, pf_r, rtol=0, atol=2e-6)
    np.testing.assert_allclose(dec_t, dec_r, rtol=0, atol=2e-6)
    assert n == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_matches_reference(bases, monkeypatch, arch):
    """serve --continuous 3 over 2 slots, calibrated: the reference's
    greedy ids (both packages serve from the reference's table; xlstm with
    --no-fuse-proj, the reference's fused serve of it fails)."""
    argv = ["--arch", arch, "--smoke", "--requests", "2", "--prompt-len",
            "3", "--gen-len", "4", "--calibrate", "1", "--continuous", "3"]
    if arch == "xlstm-125m":
        argv.append("--no-fuse-proj")
    tables = []
    real_r, real_t = rcalib.calibrate_decode, tcalib.calibrate_decode

    def record(*a, **k):
        tables.append(real_r(*a, **k))
        return tables[-1]

    def reference_table(*a, **k):
        real_t(*a, **k)
        return interop.table_from_json(json.dumps(tables[-1].to_json()))

    monkeypatch.setattr(rcalib, "calibrate_decode", record)
    ids_r, _ = rserve.main(argv)
    monkeypatch.setattr(tcalib, "calibrate_decode", reference_table)
    monkeypatch.setattr(TT, "init_params", _ref_params(bases[arch][2]))
    ids_t, logits = tserve.main(argv + ["--device", "cpu"])
    print(f"\n[{arch} --continuous 3] ids {ids_t.tolist()}")
    assert ids_t.shape == (3, 4)
    assert np.isfinite(logits).all()
    np.testing.assert_array_equal(ids_t, ids_r)
