"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's XLA twins in repro.kernels.ref.

Tolerances, and why:
  * delta_matmul: exact (integer arithmetic).
  * fused_qdot: the quantized activations and the int32 accumulator are
    exact.  The float output is exact without compensation; with it the
    row sum of mu_r[qx] is a float32 sum over K taken in another order
    by torch than by XLA, so the output is held to rtol 1e-5 plus an
    atol of 1e-5 * max|y| (cancellation in the asym cross terms).
  * decode_attention: the v rows are bit-equal; the k rows are held to
    repro_torch.kernels.check.check_rows (one bf16 step, or 2^-20 of the
    row's scale where rope cancels to near zero; at most 1% of entries
    differ), since torch's and XLA's rmsnorm/rope float math (sum order,
    pow/cos/sin ulps) may straddle a bf16 rounding edge.  The output
    (softmax and dot products in float32) is held to atol/rtol 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as rlut
from repro.kernels import ref as rref
from repro.quant import linear as rlin
from repro_torch.core import lut as tlut
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.check import check_rows

MODES = [("asym_u8", False), ("sym_i8", True)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mode,signed", MODES)
def test_delta_matmul_exhaustive_pairs(mode, signed):
    """K=1: a (256,1) holds every operand value and b (1,256) likewise,
    so the output IS the whole 256x256 product table (65,536 pairs)."""
    vals = np.arange(-128, 128) if signed else np.arange(256)
    a = vals.astype(np.int32)[:, None]
    b = vals.astype(np.int32)[None, :]
    d = tlut.build_delta_lut("design2", signed)
    off = 128 if signed else 0
    before = dict(ops.LAUNCHES)
    got = ops.delta_matmul(_t(a), _t(b).to(torch.int8 if signed
                                           else torch.uint8), _t(d), off)
    assert ops.LAUNCHES == before          # the plain version launches nothing
    want = np.asarray(rref.delta_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                            rlut.build_delta_lut("design2",
                                                                 signed),
                                            offset=off))
    np.testing.assert_array_equal(got.numpy(), want)
    table = (rlut.build_signed_lut if signed else rlut.build_lut)("design2")
    np.testing.assert_array_equal(got.numpy(), table)


@pytest.mark.parametrize("mode,signed", MODES)
@pytest.mark.parametrize("shape", [(5, 77, 131), (3, 1000, 17), (16, 64, 8)])
def test_delta_matmul_ragged(mode, signed, shape):
    M, K, N = shape
    rng = np.random.default_rng(M * K + N)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = rng.integers(lo, hi, (M, K)).astype(np.int32)
    b = rng.integers(lo, hi, (K, N)).astype(np.int32)
    off = 128 if signed else 0
    got = ops.delta_matmul(_t(a), _t(b).to(torch.int8 if signed
                                           else torch.uint8),
                           _t(tlut.build_delta_lut("design2", signed)), off)
    want = rref.delta_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                 rlut.build_delta_lut("design2", signed),
                                 offset=off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fused_inputs(M, K, N, signed, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, K)) * 1.7 + 0.3).astype(np.float32)
    if signed:
        sx = np.float32(np.abs(x).max() / 127.0)
        zx = np.float32(0.0)
        qw = rng.integers(-128, 128, (K, N)).astype(np.int32)
        zw = np.zeros(N, np.float32)
    else:
        sx = np.float32((x.max() - x.min()) / 255.0)
        zx = np.float32(np.clip(np.round(-x.min() / sx), 0, 255))
        qw = rng.integers(0, 256, (K, N)).astype(np.int32)
        zw = rng.integers(100, 160, N).astype(np.float32)
    # a few activations exactly on .5 quantization boundaries
    x[0, :4] = (np.arange(4) + 0.5).astype(np.float32) * sx
    mu_r, mu_c, mu = rlin._mean_field_tables("design2", signed)
    mu_r, mu_c = np.asarray(mu_r), np.asarray(mu_c)
    off = 128 if signed else 0
    sw = (rng.uniform(0.5, 2.0, N) * 1e-3).astype(np.float32)
    colsum = qw.sum(0).astype(np.float32)
    comp_col = mu_c[qw + off].sum(0, dtype=np.float64).astype(np.float32)
    scal = np.array([sx, zx, np.float32(mu), 0, 0, 0, 0, 0], np.float32)
    ntab = np.stack([sw, zw, colsum, comp_col]).astype(np.float32)
    return x, qw, scal, ntab, mu_r


@pytest.mark.parametrize("mode,signed", MODES)
@pytest.mark.parametrize("compensate", [False, True])
@pytest.mark.parametrize("shape", [(4, 64, 96), (7, 77, 131), (33, 200, 24)])
def test_fused_qdot_plain_matches_reference(mode, signed, compensate,
                                            shape):
    M, K, N = shape
    x, qw, scal, ntab, mu_r = _fused_inputs(M, K, N, signed, M + K + N)
    off = 128 if signed else 0
    d = rlut.build_delta_lut("design2", signed)
    qw_t = _t(qw).to(torch.int8 if signed else torch.uint8)
    got, qx, acc = ops.fused_qdot_packed(
        _t(x), qw_t, _t(tlut.build_delta_lut("design2", signed)), _t(scal),
        _t(ntab), _t(mu_r), signed=signed, compensate=compensate,
        return_int=True)
    want = np.asarray(rref.fused_qdot_ref(
        jnp.asarray(x), jnp.asarray(qw), d, jnp.asarray(scal),
        jnp.asarray(ntab), jnp.asarray(mu_r), offset=off, asym=not signed,
        compensate=compensate))
    # integer stages: exact
    lo, hi = (0.0, 255.0) if not signed else (-128.0, 127.0)
    qx_ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / scal[0])
                                 + scal[1], lo, hi).astype(jnp.int32))
    np.testing.assert_array_equal(qx.numpy(), qx_ref)
    acc_ref = np.asarray(rref.delta_matmul_ref(jnp.asarray(qx_ref),
                                               jnp.asarray(qw), d,
                                               offset=off))
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    # float epilogue
    g = got.numpy()
    if compensate:
        np.testing.assert_allclose(g, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(g, want)


def _attn_inputs(B, S_max, H, Kv, hd, seed, per_slot):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, 1, Kv, hd)).astype(np.float32)
    v = rng.normal(size=(B, 1, Kv, hd)).astype(np.float32)
    kc = rng.normal(size=(B, S_max, Kv, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S_max, Kv, hd)).astype(np.float32)
    gq = rng.uniform(0.5, 1.5, hd).astype(np.float32)
    gk = rng.uniform(0.5, 1.5, hd).astype(np.float32)
    idx = (rng.integers(0, S_max, B).astype(np.int32) if per_slot
           else np.int32(S_max - 2))
    return q, k, v, kc, vc, gq, gk, idx


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("qk_norm", [True, False])
def test_decode_attention_plain_matches_reference(per_slot, window,
                                                  qk_norm):
    B, S_max, H, Kv, hd = 3, 12, 4, 2, 16
    q, k, v, kc, vc, gq, gk, idx = _attn_inputs(B, S_max, H, Kv, hd,
                                                7 + per_slot, per_slot)
    kw = dict(n_heads=H, n_kv=Kv, head_dim=hd, rope_theta=10000.0,
              window=window)
    gains = dict(q_gain=gq, k_gain=gk) if qk_norm else {}
    out_r, ck_r, cv_r = rref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16),
        jnp.asarray(idx), **kw,
        **{n: jnp.asarray(g) for n, g in gains.items()})
    ck = _t(kc).to(torch.bfloat16)
    cv = _t(vc).to(torch.bfloat16)
    before = dict(ops.LAUNCHES)
    out, ck2, cv2 = ops.decode_attention(
        _t(q), _t(k), _t(v), ck, cv, torch.tensor(idx), **kw,
        **{n: _t(g) for n, g in gains.items()})
    assert ops.LAUNCHES == before
    assert ck2 is ck and cv2 is cv          # appended in place
    ck_r = np.asarray(jnp.asarray(ck_r, jnp.float32))
    got_k = ck.float().numpy()
    # v rows take no norm or rope: bit-equal; k rows within one bf16 step
    np.testing.assert_array_equal(cv.float().numpy(),
                                  np.asarray(jnp.asarray(cv_r, jnp.float32)))
    check_rows(_t(got_k), _t(ck_r))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("backend", ["delta", "fused", "exact"])
def test_approx_matmul_backends_match_reference(signed, backend):
    """ops.approx_matmul (float32 out, leading batch axes) against the
    reference's, per ported backend: exact."""
    from repro.kernels import ops as rops
    rng = np.random.default_rng(11)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = rng.integers(lo, hi, (2, 3, 40)).astype(np.int32)
    b = rng.integers(lo, hi, (40, 24)).astype(np.int32)
    got = ops.approx_matmul(_t(a), _t(b), "design2", backend, signed=signed)
    want = rops.approx_matmul(jnp.asarray(a), jnp.asarray(b), "design2",
                              backend, 32, signed)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# lut_matmul and residual_matmul (the 'xla' / 'pallas_legacy' and
# 'residual' / 'residual_xla' backends), against the reference's
# approx_matmul_ref and residual_corrected_matmul_ref.
#
#   * product-LUT gather (approx_matmul_ref, lut_matmul_ref): exact, and
#     equal to the gate-level product table on the 65,536-pair sweep.
#   * residual_corrected_matmul_ref: the exact part is an integer product
#     converted once (exact); the rank-r correction is a float32 sum in
#     another order than XLA's einsum, held to 1e-6 * max|out| (measured
#     9.9e-8).  At full rank its output rounds to the LUT product, as the
#     reference's does (tests/test_signed.py).
# ---------------------------------------------------------------------------

RESID_REF_TOL = 1e-6


@pytest.mark.parametrize("mode,signed", MODES)
@pytest.mark.parametrize("design", ["design2", "exact"])
def test_lut_matmul_exhaustive_pairs(mode, signed, design):
    """K=1 over every operand pair: the output is the product table."""
    vals = np.arange(-128, 128) if signed else np.arange(256)
    a = vals.astype(np.int32)[:, None]
    b = vals.astype(np.int32)[None, :]
    off = 128 if signed else 0
    table = (ops.get_signed_lut if signed else ops.get_lut)(design)
    before = dict(ops.LAUNCHES)
    got = ops.lut_matmul(_t(a + off), _t(b + off), *ops.narrow_lut(table))
    assert ops.LAUNCHES == before
    from repro.kernels import ops as rops
    r_table = (rops.get_signed_lut if signed else rops.get_lut)(design)
    want = np.asarray(rref.approx_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                             r_table, offset=off))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), r_table)
    # the 16-bit narrowing the kernel takes, widened back, is the table
    narrow, unsigned = ops.narrow_lut(table)
    assert unsigned == (not signed)
    np.testing.assert_array_equal(ops._widen(narrow, unsigned).numpy(),
                                  table)


@pytest.mark.parametrize("mode,signed", MODES)
@pytest.mark.parametrize("shape", [(5, 77, 131), (3, 1000, 17), (77, 131, 45)])
def test_approx_matmul_ref_ragged(mode, signed, shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K * N)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = rng.integers(lo, hi, (M, K)).astype(np.int32)
    b = rng.integers(lo, hi, (K, N)).astype(np.int32)
    off = 128 if signed else 0
    lut = rlut.build_signed_lut("design2") if signed \
        else rlut.build_lut("design2")
    want = np.asarray(rref.approx_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                             lut, offset=off))
    got = tref.approx_matmul_ref(_t(a), _t(b), _t(lut), off)
    np.testing.assert_array_equal(got.numpy(), want)
    # small blocks: the K slicing is exact
    got = tref._gather_blocks((_t(a).long() + off) * 256, _t(b).long() + off,
                              _t(lut).reshape(-1), budget=M * N * 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("rank", [4, 16, 32, None])
def test_error_factors_equal_reference(signed, rank):
    fn_r = rlut.signed_error_factors if signed else rlut.error_factors
    fn_t = tlut.signed_error_factors if signed else tlut.error_factors
    Fr, Gr, res_r = fn_r("design2", rank)
    Ft, Gt, res_t = fn_t("design2", rank)
    np.testing.assert_array_equal(Ft, Fr)
    np.testing.assert_array_equal(Gt, Gr)
    assert res_t == res_r


@pytest.mark.parametrize("mode,signed", MODES)
@pytest.mark.parametrize("rank", [4, 16, 32, 256])
@pytest.mark.parametrize("shape", [(37, 300, 45), (5, 77, 131)])
def test_residual_plain_matches_reference(mode, signed, rank, shape):
    M, K, N = shape
    rng = np.random.default_rng(rank + M)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = rng.integers(lo, hi, (M, K)).astype(np.int32)
    b = rng.integers(lo, hi, (K, N)).astype(np.int32)
    off = 128 if signed else 0
    F, G = ops.get_factors("design2", rank, signed)
    want = np.asarray(rref.residual_corrected_matmul_ref(
        jnp.asarray(a), jnp.asarray(b), F, G, offset=off))
    got = ops.residual_matmul(_t(a), _t(b), _t(F), _t(G), off).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESID_REF_TOL * np.abs(want).max())
    if rank == 256:      # full rank: the correction is the whole error
        lut = rlut.build_signed_lut("design2") if signed \
            else rlut.build_lut("design2")
        exact = lut[(a + off)[:, :, None], (b + off)[None]].sum(1)
        np.testing.assert_array_equal(np.round(got), exact)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas_legacy", "residual",
                                     "residual_xla", "pallas", "delta",
                                     "delta_xla", "fused", "exact"])
def test_approx_matmul_every_backend_matches_reference(signed, backend):
    """ops.approx_matmul for every backend name of the reference against
    the reference's ops.approx_matmul.  The reference's 'pallas_legacy',
    'residual' and 'pallas' run Pallas kernels that do not build on the
    installed jax, so those names are held against their XLA twins
    ('xla', 'residual_xla', 'delta_xla'), which compute the same
    function.  Integer backends exact; residual within RESID_REF_TOL."""
    from repro.kernels import ops as rops
    twin = {"pallas_legacy": "xla", "residual": "residual_xla",
            "pallas": "delta_xla"}.get(backend, backend)
    rng = np.random.default_rng(17)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = rng.integers(lo, hi, (2, 3, 40)).astype(np.int32)
    b = rng.integers(lo, hi, (40, 24)).astype(np.int32)
    got = ops.approx_matmul(_t(a), _t(b), "design2", backend, 16,
                            signed=signed)
    want = np.asarray(rops.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                         "design2", twin, 16, signed))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if backend.startswith("residual"):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RESID_REF_TOL * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_approx_matmul_straight_through_gradient():
    """ApproxMatmul's backward is the reference's _approx_matmul_bwd:
    float-valued operands get g @ b.T and a.T @ g (float32 matmuls summed
    in torch's order, not XLA's: rtol 1e-5, measured 1.6e-6)."""
    import jax
    from repro.kernels import ops as rops
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (2, 3, 8)).astype(np.float32)
    b = rng.integers(0, 256, (8, 5)).astype(np.float32)
    g = rng.normal(size=(2, 3, 5)).astype(np.float32)
    at, bt = _t(a).requires_grad_(), _t(b).requires_grad_()
    out = ops.approx_matmul(at, bt, "design2", "xla")
    da, db = torch.autograd.grad(out, (at, bt), _t(g))
    _, vjp = jax.vjp(lambda x, y: rops.approx_matmul(x, y, "design2", "xla"),
                     jnp.asarray(a), jnp.asarray(b))
    ra, rb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(da.numpy(), np.asarray(ra), rtol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(rb), rtol=1e-5)
    # integer operands carry no gradient
    assert not ops.approx_matmul(_t(a).int(), _t(b).int()).requires_grad


def test_narrow_lut_refuses_a_table_that_fits_16_bits_neither_way():
    bad = np.zeros((256, 256), np.int32)
    bad[0, 0], bad[1, 1] = -1, 40000
    with pytest.raises(ValueError, match="neither uint16 nor int16"):
        ops.narrow_lut(bad)
