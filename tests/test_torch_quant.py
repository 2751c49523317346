"""The port's quantizers and qdot against the JAX package's, on smoke
qwen3-1.7b weights carried across with interop.params_from_numpy.

Tolerances: the quantized operands (q, qx), scales, zero points and
colsums are exact.  qdot outputs: the integer product is exact, but the
mean-field compensation terms are float32 sums of K (or N) gathered
table entries, taken in another order by torch than by XLA; outputs are
held to rtol 1e-5 plus an atol of 1e-5 * max|y|.  Without compensation
the fused branch is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.calib import static as rstatic
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import linear as rlin
from repro.quant import quantize as rquant
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.calib import static as tstatic
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import linear as tlin
from repro_torch.quant import quantize as tquant

ARCH = "qwen3-1.7b"
MODES = ["asym_u8", "sym_i8"]


@pytest.fixture(scope="module")
def params():
    pj = RT.init_params(jax.random.PRNGKey(0), rconfigs.get_smoke(ARCH))
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj),
                                   tconfigs.get_smoke(ARCH), device="cpu")
    return pj, pt


def _wrappers(tree, cls):
    found = {}

    def grab(node):
        found[node.path] = node
        return node
    (rlin if cls is rlin.QuantizedWeight else tlin).map_quantized(tree, grab)
    return found


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("axis", [None, (0, 1), 1])
def test_quantizers_exact(axis):
    x = np.random.default_rng(3).normal(size=(6, 5, 40)).astype(np.float32)
    x[0, 0, :3] = [0.0, 1e-3, -2.5]
    q, s, z = tquant.quantize_uint8(torch.from_numpy(x), axis)
    qr, sr, zr = rquant.quantize_uint8(jnp.asarray(x), axis)
    for a, b in ((q, qr), (s, sr), (z, zr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q, s = tquant.quantize_int8(torch.from_numpy(x), axis)
    qr, sr = rquant.quantize_int8(jnp.asarray(x), axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


@pytest.mark.parametrize("mode", MODES)
def test_prequantize_identical(params, mode):
    pj, pt = params
    wj = _wrappers(rlin.prequantize_weights(pj, RQ(mode=mode)),
                   rlin.QuantizedWeight)
    wt = _wrappers(tlin.prequantize_weights(pt, TQ(mode=mode)),
                   tlin.QuantizedWeight)
    assert sorted(wj) == sorted(wt) and len(wt) == 7
    for path, r in wj.items():
        t = wt[path]
        assert t.q.dtype == (torch.int8 if mode == "sym_i8" else torch.uint8)
        np.testing.assert_array_equal(t.q.to(torch.int32).numpy(),
                                      np.asarray(r.q), err_msg=path)
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(r.scale))
        for f in ("zp", "colsum"):
            a, b = getattr(t, f), getattr(r, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _static_trees(pj, pt, mode, fused, merge):
    """Both packages' trees with the same static activation scales
    (hand-set, one per layer), comp cols and optional merging."""
    rq = RQ(mode=mode, backend="fused" if fused else "delta",
            inference=True)
    tq = TQ(mode=mode, backend="fused" if fused else "delta",
            inference=True)
    sj = rlin.prequantize_weights(pj, rq)
    st = tlin.prequantize_weights(pt, tq)
    sx = np.array([0.031, 0.027], np.float32)
    zx = (np.array([127.0, 131.0], np.float32) if mode == "asym_u8"
          else None)
    sj = rlin.map_quantized(sj, lambda n: n.replace(
        act_scale=jnp.asarray(sx),
        act_zp=None if zx is None else jnp.asarray(zx)))
    st = tlin.map_quantized(st, lambda n: n.replace(
        act_scale=torch.from_numpy(sx),
        act_zp=None if zx is None else torch.from_numpy(zx)))
    if fused:
        sj = rstatic.attach_comp_cols(sj, rq)
        st = tstatic.attach_comp_cols(st, tq)
    if merge:
        sj, st = rlin.fuse_projections(sj), tlin.fuse_projections(st)
    return sj, st, rq, tq


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("branch", ["dynamic", "dynamic_ste", "prequant",
                                    "static", "fused", "fused_merged",
                                    "fused_nocomp"])
def test_qdot_branches_match(params, mode, branch):
    pj, pt = params
    x = (np.random.default_rng(5).normal(size=(2, 3, 64)) * 1.3
         ).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if branch in ("dynamic", "dynamic_ste"):
        inf = branch == "dynamic"
        wj = pj["units"][0]["attn"]["wq"][1]
        wt = pt["units"][0]["attn"]["wq"][1]
        rq = RQ(mode=mode, backend="delta", inference=inf)
        tq = TQ(mode=mode, backend="delta", inference=inf)
        for pp in (False, True):      # act_per_pos: the prefill's form
            _close(tlin.qdot(xt, wt, dataclasses.replace(tq, act_per_pos=pp)),
                   rlin.qdot(xj, wj, dataclasses.replace(rq, act_per_pos=pp)))
        return
    if branch == "prequant":
        rq = RQ(mode=mode, backend="delta", inference=True)
        tq = TQ(mode=mode, backend="delta", inference=True)
        wj = _wrappers(rlin.prequantize_weights(pj, rq),
                       rlin.QuantizedWeight)["units.0.mlp.w_down"]
        wt = _wrappers(tlin.prequantize_weights(pt, tq),
                       tlin.QuantizedWeight)["units.0.mlp.w_down"]
        xd = np.random.default_rng(6).normal(size=(2, 1, 192)).astype(
            np.float32)
        _close(tlin.qdot(torch.from_numpy(xd), wt.layer(1), tq),
               rlin.qdot(jnp.asarray(xd), jax.tree.map(lambda a: a[1], wj),
                         rq))
        return
    fused = branch.startswith("fused")
    merge = branch == "fused_merged"
    sj, st, rq, tq = _static_trees(pj, pt, mode, fused, merge)
    if branch == "fused_nocomp":
        rq = dataclasses.replace(rq, compensate=False)
        tq = dataclasses.replace(tq, compensate=False)
    names = ["wqkv", "wo"] if merge else ["wq", "wk", "wo"]
    for name in names:
        wj = _wrappers(sj, rlin.QuantizedWeight)[f"units.0.attn.{name}"]
        wt = _wrappers(st, tlin.QuantizedWeight)[f"units.0.attn.{name}"]
        for layer in (0, 1):
            yt = tlin.qdot(xt, wt.layer(layer), tq)
            yj = rlin.qdot(xj, jax.tree.map(lambda a: a[layer], wj), rq)
            if branch == "fused_nocomp":
                np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
            else:
                _close(yt, yj)


@pytest.mark.parametrize("mode", MODES)
def test_fuse_projections_fields_match(params, mode):
    pj, pt = params
    sj, st, _, _ = _static_trees(pj, pt, mode, fused=True, merge=True)
    wj = _wrappers(sj, rlin.QuantizedWeight)
    wt = _wrappers(st, tlin.QuantizedWeight)
    assert sorted(wj) == sorted(wt)
    assert "units.0.attn.wqkv" in wt and "units.0.mlp.w_gateup" in wt
    for path, r in wj.items():
        t = wt[path]
        assert t.merged == r.merged and t.per_channel == r.per_channel
        np.testing.assert_array_equal(t.q.to(torch.int32).numpy(),
                                      np.asarray(r.q))
        for f in ("scale", "zp", "colsum", "act_scale", "act_zp",
                  "comp_col"):
            a, b = getattr(t, f), getattr(r, f)
            assert (a is None) == (b is None), (path, f)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{path}.{f}")
