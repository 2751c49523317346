"""The remaining dense configs (gemma-7b, minitron-8b, nemotron-4-340b)
against the JAX package, at smoke size, on the reference's own weights
(``T.init_params(PRNGKey(0), SMOKE)`` carried across with
interop.params_from_numpy): the MLP kinds they bring (geglu, relu2, and
gelu, which no config uses), decode_attention's plain version at query
groups above 8 (nemotron's 96/8 = 12, recurrentgemma's 10/1), the
calibrated serve and forward_train, and the int32 range of nemotron's
w_down (K = 73,728).  The recurrent families are held in
tests/test_torch_recurrent.py.

Tolerances, and why (gaps measured on these sizes and inputs):
  * mlp() per kind, both modes, prequantized weights with dynamic
    activation quantization: every quantized operand equal (0 steps
    flipped), outputs within rtol 1e-5 plus 1e-5 x max|y| (the
    compensation sums are float32 sums in torch's order, not XLA's:
    tests/test_torch_quant.py's bound).
  * decode_attention's plain version against the reference's XLA twin
    (tests/test_torch_kernels.py's helper): v rows bit-equal, k rows
    within one bf16 step (check_rows), outputs within 2e-5.
  * The calibrated serve of each config in both modes (the helpers of
    tests/test_torch_moe_serve.py): calibration tables' sites equal,
    lo/hi/amax within rtol 1e-4, 0 dynamic steps flipped; served from the
    reference's table, greedy ids equal, caches within check_rows,
    logits within atol 2e-6, 0 static steps flipped.
  * forward_train (xla asym_u8) against the reference run op by op
    (jax.disable_jit): every product equal on the same operands, at most
    0.1% of the steps flipped, loss within rtol 2e-6 (the op-by-op bounds
    of tests/test_torch_train.py).
  * The int32 range at K = 73,728: products whose true value passes
    2^31 wrap modulo 2^32 in the reference (int32 accumulation); the
    port's plain delta_matmul and fused_qdot give the same int32 words
    (exact) and the same dequantized floats (bit-equal).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import lut as rlut
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import layers as rlayers
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import linear as rlin
from repro.quant import prequantize_weights as r_preq
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import lut as tlut
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import fuse_projections as t_fuse
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq
from test_torch_kernels import _attn_matches_reference
from test_torch_moe import (MODES, _count_flips, _observing,  # noqa: F401
                            _RecordProducts, _Recorder)
from test_torch_moe_serve import (_calibrate_both, _install,
                                  _serve_and_compare)

ARCHS = ["gemma-7b", "minitron-8b", "nemotron-4-340b"]
NEW_CONFIGS = ARCHS + ["recurrentgemma-2b", "xlstm-125m"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def bases():
    out = {}
    for arch in ARCHS:
        cfg_r = rconfigs.get_smoke(arch)
        pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
        cfg_t = tconfigs.get_smoke(arch)
        pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                       device="cpu")
        out[arch] = (cfg_r, cfg_t, pj, pt)
    return out


def test_params_carry_across_and_init_draws_the_reference_tree(bases):
    """The port's own init draws the reference's tree and shapes for every
    new config (the non-GLU MLPs have w_up / w_down only), and
    params_from_numpy refuses a wrong MLP shape by its path."""
    for arch in NEW_CONFIGS:
        cfg_r, cfg_t = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
        pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
        own = TT.init_params(torch.Generator().manual_seed(0), cfg_t,
                             device="cpu")
        shapes = jax.tree.map(lambda a: tuple(a.shape), pj)
        assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes, arch
    cfg_r, cfg_t, pj, _ = bases["minitron-8b"]
    assert set(pj["units"][0]["mlp"]) == {"w_up", "w_down"}
    bad = jax.tree.map(np.asarray, pj)
    bad["units"][0]["mlp"]["w_down"] = bad["units"][0]["mlp"]["w_down"][
        :, :8]
    with pytest.raises(ValueError, match="mlp.w_down"):
        interop.params_from_numpy(bad, cfg_t, device="cpu")


def test_moe_init_takes_the_card_unless_asked():
    """moe_init defaults to the card, as every entry point: without a
    card it raises as init_params does, and device='cpu' works."""
    gen = torch.Generator().manual_seed(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmoe.moe_init(gen, 1, 8, 16, 2, "swiglu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_params(gen, tconfigs.get_smoke("mixtral-8x7b"))
    p = tmoe.moe_init(gen, 1, 8, 16, 2, "swiglu", device="cpu")
    assert p["w_gate"].device.type == "cpu"
    assert tuple(p["w_up"].shape) == (1, 2, 8, 16)


# ---------------------------------------------------------------------------
# the MLP kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind,merged", [("geglu", False), ("geglu", True),
                                         ("relu2", False), ("gelu", False),
                                         ("swiglu", False), ("swiglu", True)])
def test_mlp_kind_matches_reference(kind, merged, mode):
    """layers.mlp of each kind on prequantized weights (dynamic activation
    quantization, the 'xla' product), and for the GLU kinds the merged
    w_gateup of fuse_projections: every quantized operand equal and the
    output within the fused bound."""
    rng = np.random.default_rng(len(kind) + 7 * merged)
    D, F = 64, 256
    names = (["w_gate"] if kind in ("geglu", "swiglu") else []) + \
        ["w_up", "w_down"]
    w = {n: (rng.normal(size=(F, D) if n == "w_down" else (D, F))
             / np.sqrt(F if n == "w_down" else D)).astype(np.float32)
         for n in names}
    x = rng.normal(size=(2, 3, D)).astype(np.float32)
    rq = RQ(design="design2", backend="xla", mode=mode, inference=True)
    tq = TQ(design="design2", backend="xla", mode=mode, inference=True)
    pj = r_preq({"units": [{"mlp": {k: jnp.asarray(v) for k, v in
                                    w.items()}}]}, rq)
    pt = t_preq({"units": [{"mlp": {k: _t(v) for k, v in w.items()}}]}, tq)
    if merged:
        pt = t_fuse(pt)
        assert "w_gateup" in pt["units"][0]["mlp"]
    with _observing(rlin, _Recorder()) as rec_r:
        yr = np.asarray(rlayers.mlp(pj["units"][0]["mlp"], jnp.asarray(x),
                                    rq, kind))
    with _observing(tlin, _Recorder()) as rec_t, torch.no_grad():
        yt = tlayers.mlp(pt["units"][0]["mlp"], _t(x), tq, kind).numpy()
    if merged:   # the merged call stands for the gate and up calls
        g = rec_t.calls.pop("units.0.mlp.w_gateup@")
        rec_t.calls["units.0.mlp.w_gate@"] = g
        rec_t.calls["units.0.mlp.w_up@"] = g
    flips, total, dx = _count_flips(rec_r.calls, rec_t.calls, static=False)
    gap = float(np.abs(yt - yr).max())
    print(f"\n[mlp {kind} {mode} merged={merged}] {flips} of {total} "
          f"dynamic steps flipped (max |dx| {dx:.3e}); max |y gap| "
          f"{gap:.3e} of max |y| {np.abs(yr).max():.3f}")
    assert flips == 0
    np.testing.assert_allclose(yt, yr, rtol=1e-5,
                               atol=1e-5 * np.abs(yr).max())


# ---------------------------------------------------------------------------
# decode_attention at query groups above 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("H,Kv,window", [(12, 1, None), (12, 1, 5),
                                         (10, 1, 5), (10, 1, None),
                                         (24, 2, None), (16, 16, None)])
def test_decode_attention_plain_at_large_groups(H, Kv, window, per_slot):
    """The plain decode-attention step (and the append) at
    replace(SMOKE, n_heads=12, n_kv=1, head_dim=16), nemotron's group
    of 12 over two kv heads, recurrentgemma's 10/1 with and without a
    window (positions past it), and gemma's 16/16, against the
    reference's XLA twin."""
    _attn_matches_reference(3, 24, H, Kv, 16, H + Kv + per_slot, per_slot,
                            window, qk_norm=False)
    _attn_matches_reference(2, 24, H, Kv, 16, 100 + H, per_slot, window,
                            qk_norm=False, idx=[23, 9][:2] if per_slot
                            else 20)


def test_decode_attention_wrapper_takes_groups_up_to_16():
    """ops.decode_attention's checks take a group of 16 (and refuse 17)
    before any launch: the CPU path runs the plain version at any group,
    the card's wrapper checks H/Kv <= 16."""
    B, S, hd = 1, 8, 16
    for H, ok in ((16, True), (17, False)):
        q = torch.zeros((B, H, hd))
        kv = torch.zeros((B, 1, hd))
        cache = torch.zeros((B, S, 1, hd), dtype=torch.bfloat16)
        pos = torch.zeros((), dtype=torch.int32)
        if ok:
            tops._check_attention_shapes(q, kv, kv, None, None, cache,
                                         cache, pos)
        else:
            with pytest.raises(ValueError, match="<= 16"):
                tops._check_attention_shapes(q, kv, kv, None, None, cache,
                                             cache, pos)


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
    from repro_torch import calib as tcalib
    cfg = bases[arch][1]
    table_r, table_t = c["table_r"], c["table_t"]
    flips, total, dx = c["calib_flips"]
    assert table_t.mode == table_r.mode == mode
    assert sorted(table_t.sites) == sorted(table_r.sites)
    per_layer = 4 + (3 if cfg.mlp_kind in ("geglu", "swiglu") else 2)
    assert len(table_t.sites) == per_layer * cfg.n_layers
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


def test_calibrated_serve_matches_reference(calibrated, bases):
    arch, mode, c = calibrated
    base = bases[arch]
    sj, st = _install(c, json.dumps(c["table_r"].to_json()))
    unit = st["units"][0]
    assert "wqkv" in unit["attn"]
    glu = base[1].mlp_kind in ("geglu", "swiglu")
    assert ("w_gateup" in unit["mlp"]) == glu
    prompts = np.random.default_rng(0).integers(
        0, base[0].vocab, (2, 4)).astype(np.int32)
    _serve_and_compare(base, f"{arch} {mode}", sj, st, c["rq"], c["tq"],
                       prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(bases, arch):
    cfg_r, cfg_t, pj, pt = bases[arch]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_r.vocab, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rcfg = RQ(design="design2", backend="xla", mode="asym_u8")
    tcfg = TQ(design="design2", backend="xla", mode="asym_u8")
    with jax.disable_jit(), _RecordProducts(rops, np.asarray) as rrec:
        r_loss, _ = RT.forward_train(
            pj, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_r, rcfg)
    with _RecordProducts(tops, lambda t: t.numpy()) as trec:
        t_loss, _ = TT.forward_train(
            pt, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t,
            tcfg)
    per_layer = 4 + (3 if cfg_t.mlp_kind in ("geglu", "swiglu") else 2)
    assert len(trec.calls) == len(rrec.calls) == per_layer * cfg_t.n_layers
    flips = total = 0
    for (ra, rb), (ta, tb) in zip(rrec.calls, trec.calls):
        np.testing.assert_array_equal(tb, rb)
        flips += int((ta != ra).sum())
        total += ra.size
    print(f"\n{arch} forward_train: {flips} of {total} steps flipped; loss "
          f"{float(t_loss)!r} vs {float(r_loss)!r}")
    assert flips <= 1e-3 * total
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=2e-6)


# ---------------------------------------------------------------------------
# the int32 range at nemotron's w_down
# ---------------------------------------------------------------------------

K_W_DOWN = tconfigs.get("nemotron-4-340b").d_ff          # 73,728


def _range_operands(signed: bool, M: int = 2, N: int = 8):
    """Operands whose products pass 2^31 over K_W_DOWN: row 0 at the
    grid's end (255, or -128 against -128), the others drawn from the top
    of the grid."""
    rng = np.random.default_rng(73728 + signed)
    lo, hi = (-128, -100) if signed else (220, 256)
    a = rng.integers(lo, hi, (M, K_W_DOWN)).astype(np.int32)
    b = rng.integers(lo, hi, (K_W_DOWN, N)).astype(np.int32)
    a[0] = -128 if signed else 255
    b[:, 0] = -128 if signed else 255
    return a, b


@pytest.mark.parametrize("design,signed", [("design2", False),
                                           ("design2", True),
                                           ("initial", False)])
def test_delta_matmul_wraps_as_the_reference_past_int32(design, signed):
    """delta_matmul's plain version at K = 73,728 on operands whose exact
    product (and for the unsigned 'initial' the delta sum) passes 2^31,
    its table in the narrowed form the card takes (ops.narrow_delta):
    the reference accumulates in int32 and wraps modulo 2^32; the port
    gives the same words."""
    a, b = _range_operands(signed)
    off = 128 if signed else 0
    exact = a.astype(np.int64) @ b.astype(np.int64)
    d64 = rlut.build_delta_lut(design, signed).astype(np.int64)
    dsum = d64[(a + off)[:, :, None] & 255, (b + off)[None] & 255].sum(1)
    true = exact + dsum
    want = np.asarray(rref.delta_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                            rlut.build_delta_lut(design,
                                                                 signed),
                                            offset=off))
    wrapped = ((true + 2**31) % 2**32 - 2**31).astype(np.int32)
    bits, unsigned, bias = tops.narrow_delta(
        tlut.build_delta_lut(design, signed))
    got = tops.delta_matmul(_t(a), _t(b), bits, offset=off,
                            unsigned=unsigned, bias=bias).numpy()
    # outputs whose exact product, delta sum or total passes 2^31
    passes = int(((np.abs(exact) >= 2**31) | (np.abs(dsum) >= 2**31)
                  | (np.abs(true) >= 2**31)).sum())
    print(f"\n[int32 range {design} signed={signed}] {passes} of "
          f"{true.size} outputs have a sum past 2^31 (max |exact| "
          f"{np.abs(exact).max()}, max |delta sum| {np.abs(dsum).max()}, "
          f"max |total| {np.abs(true).max()}); the reference wraps: "
          f"{bool(np.array_equal(want, wrapped))}")
    np.testing.assert_array_equal(want, wrapped)
    np.testing.assert_array_equal(got, want)
    if not signed:
        assert passes > 0


@pytest.mark.parametrize("compensate", [False, True])
def test_fused_qdot_wraps_as_the_reference_past_int32(compensate):
    """fused_qdot's plain version at K = 73,728, asym_u8, activations
    that quantize to the top of the grid against weights at its top:
    the int32 accumulator wraps as the reference's, and the dequantized
    outputs are bit-equal to its twin's."""
    M, N = 2, 8
    rng = np.random.default_rng(5)
    _, qw = _range_operands(False, M, N)
    sx, zx = np.float32(0.01), np.float32(3.0)
    x = ((rng.integers(225, 256, (M, K_W_DOWN)) - zx) * sx).astype(
        np.float32)
    x[0] = 5.0                      # quantizes to 255
    scal = np.array([sx, zx, 0.5, 0, 0, 0, 0, 0], np.float32)
    ntab = np.stack([np.full(N, 0.002, np.float32),
                     np.full(N, 128.0, np.float32),
                     qw.sum(0).astype(np.float32),
                     rng.normal(size=N).astype(np.float32)])
    mu_r = rng.normal(size=256).astype(np.float32)
    d = rlut.build_delta_lut("design2", False)
    want = np.asarray(rref.fused_qdot_ref(
        jnp.asarray(x), jnp.asarray(qw), d, jnp.asarray(scal),
        jnp.asarray(ntab), jnp.asarray(mu_r), offset=0, asym=True,
        compensate=compensate))
    got, qx, acc = tops.fused_qdot_packed(
        _t(x), _t(qw).to(torch.uint8),
        _t(tlut.build_delta_lut("design2", False)), _t(scal), _t(ntab),
        _t(mu_r), signed=False, compensate=compensate, return_int=True)
    acc_ref = np.asarray(rref.delta_matmul_ref(jnp.asarray(qx.numpy()),
                                               jnp.asarray(qw), d))
    assert int(qx[0].min()) == 255
    true = qx.numpy().astype(np.int64) @ qw.astype(np.int64)
    print(f"\n[int32 range fused compensate={compensate}] "
          f"{int((true >= 2**31).sum())} of {true.size} exact products "
          f"pass 2^31; max |out gap| "
          f"{float(np.abs(got.numpy() - want).max()):.3e}")
    assert (true >= 2**31).any()
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    np.testing.assert_array_equal(got.numpy(), want)
