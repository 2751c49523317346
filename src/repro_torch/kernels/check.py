"""Hold each CUDA kernel against its plain PyTorch version on the card.

Used by ``chip_smoke.py`` (at the main path's full-width shapes) and by
``tests/test_torch_gpu.py`` (small and ragged shapes).  Inputs come from
a numpy seed and are moved to the device; each ``check_*`` runs the
kernel wrapper and the plain version on the same tensors and raises
AssertionError beyond the stated tolerances, returning the measured gaps.

Tolerances, and why:
  delta_matmul      exact: integer arithmetic in any order.
  fused_qdot        qx and the int32 accumulator exact.  The float output
                    is exact without compensation (same ops, same order,
                    no FMA contraction); with compensation the row sum of
                    mu_r[qx] is a float32 sum in another order, held to
                    rtol FUSED_RTOL plus FUSED_ATOL_REL * max|y|.
  lut_matmul        exact: integer arithmetic in any order; also equal to
                    the gate-level product table on the 65,536-pair sweep.
  residual_matmul   the exact part is an int32 sum converted once (exact
                    as the plain version's); the rank-r correction is a
                    float32 sum over K entries of the table C = F G, each
                    entry rounded once from a float64 sum, where the
                    plain version sums K*r float32 products in its
                    matmul's order; held to RESID_TOL_REL * max|out|.
  decode_attention  the bf16 v row is exact.  The bf16 k row may land one
                    bf16 step away (2^-8 to 2^-7 of the value, ROW_RTOL)
                    where the kernel's and torch's rmsnorm/rope float math
                    (sum order, powf/cosf ulps) straddles a rounding edge,
                    or within ROW_ATOL_REL * max|row| where rope's
                    x1*cos - x2*sin cancels to near zero and f32 ulps of
                    the O(1) terms exceed a bf16 step of the result; at
                    most ROW_FLIP_MAX of entries differ at all.  The f32
                    output (online vs two-pass softmax, dot-product order)
                    within ATTN_TOL absolute and relative.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.linear import _mean_field_tables
from . import ops, ref
from ..core.lut import build_delta_lut

FUSED_RTOL = 1e-5
FUSED_ATOL_REL = 1e-5
ATTN_TOL = 2e-5
ROW_RTOL = 2 ** -7
ROW_ATOL_REL = 2 ** -20
ROW_FLIP_MAX = 0.01
RESID_TOL_REL = 1e-5


def _launches(name, fn):
    """Run fn() and assert it launched kernel ``name`` exactly once."""
    before = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == before + 1, f"{name} did not launch once"
    return out


def delta_case(M, K, N, signed, seed, device):
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = torch.from_numpy(rng.integers(lo, hi, (M, K)).astype(np.int32))
    b = torch.from_numpy(rng.integers(lo, hi, (K, N)).astype(np.int32))
    d = torch.from_numpy(build_delta_lut("design2", signed))
    return dict(a=a.to(device),
                b=b.to(torch.int8 if signed else torch.uint8).to(device),
                dlut=d.to(device), offset=128 if signed else 0)


def check_delta(case) -> dict:
    got = _launches("delta_matmul", lambda: ops.delta_matmul(**case))
    want = ref.delta_matmul_ref(**case)
    assert torch.equal(got, want), "delta_matmul: kernel != plain"
    return {"max_abs_err": 0.0}


LUT_PATTERNS = ("uniform", "conflict_free", "normal")


def _quantized_normal(rng, shape):
    """uint8 codes of normal samples quantized over their min..max, as
    quant.quantize_uint8 quantizes a tensor: clustered around the zero
    point, as real activations and weights are."""
    x = rng.normal(size=shape)
    scale = (x.max() - x.min()) / 255.0
    zp = np.clip(np.round(-x.min() / scale), 0, 255)
    return np.clip(np.round(x / scale) + zp, 0, 255).astype(np.int64)


def lut_indices(M, K, N, pattern, rng):
    """(a (M, K), b (K, N)) table indices in [0, 255] for one of
    LUT_PATTERNS: 'uniform' random (a warp's 32 columns meet 1-4 times in
    a shared-memory bank); 'conflict_free', a uniform with b[k, n] = 2 (n
    mod 32) + (k & 1), so 32 neighbouring columns read 32 different
    banks; 'normal', both quantized from normal samples."""
    if pattern == "uniform":
        return rng.integers(0, 256, (M, K)), rng.integers(0, 256, (K, N))
    if pattern == "conflict_free":
        a = rng.integers(0, 256, (M, K))
        return a, 2 * (np.arange(N)[None, :] % 32) + (np.arange(K)[:, None]
                                                      & 1)
    if pattern == "normal":
        return _quantized_normal(rng, (M, K)), _quantized_normal(rng, (K, N))
    raise ValueError(f"unknown operand pattern {pattern!r}; expected one of "
                     f"{LUT_PATTERNS}")


def gather_wavefronts(b, offset: int = 0, rows: int = 256) -> float:
    """Mean shared-memory wavefronts of one warp's table gather for the
    weight operand b (K, N): a warp's 32 lanes are 32 neighbouring
    columns reading one table row at one k, entry ib = (b + offset) &
    255, 16-bit entries two to a 32-bit word, 32 banks.  Lanes reading
    one word share its wavefront; each further word of a bank costs one
    more.  1.0 is conflict-free; averaged over the first ``rows`` k and
    every whole group of 32 columns."""
    b = torch.as_tensor(b)[:rows]
    n = b.shape[1] // 32 * 32
    words = (((b[:, :n].long() + offset) & 255) >> 1).reshape(-1, 32)
    seen = torch.zeros((words.shape[0], 128), dtype=torch.bool,
                       device=words.device)
    seen.scatter_(1, words, True)
    # word w lies in bank w % 32: distinct words per bank, its maximum
    per_bank = seen.reshape(-1, 4, 32).sum(1)
    return float(per_bank.max(1).values.float().mean())


def lut_case(M, K, N, signed, seed, device, design="design2",
             pattern="uniform", shifted=True):
    """Inputs of one lut_matmul launch: the narrowed product table and
    operands drawn by lut_indices.  ``shifted``: as the Pallas function
    takes them, pre-shifted into [0, 255] (uint8 b, offset 0); otherwise
    as the 'xla' backend passes them, int8-valued with offset 128 when
    ``signed``."""
    rng = np.random.default_rng(seed)
    a, b = lut_indices(M, K, N, pattern, rng)
    off = 128 if signed and not shifted else 0
    lut, unsigned = ops.narrow_lut(ops.get_signed_lut(design) if signed
                                   else ops.get_lut(design))
    return dict(a=torch.from_numpy((a - off).astype(np.int32)).to(device),
                b=torch.from_numpy((b - off).astype(
                    np.int8 if off else np.uint8)).to(device),
                lut=lut.to(device), unsigned=unsigned, offset=off)


def lut_plain(case) -> torch.Tensor:
    """The plain version of one lut_matmul launch."""
    return ref.approx_matmul_ref(case["a"], case["b"],
                                 ops._widen(case["lut"], case["unsigned"]),
                                 case["offset"])


def check_lut(case) -> dict:
    got = _launches("lut_matmul", lambda: ops.lut_matmul(**case))
    assert torch.equal(got, lut_plain(case)), "lut_matmul: kernel != plain"
    return {"max_abs_err": 0.0}


def residual_case(M, K, N, signed, rank, seed, device, design="design2"):
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = torch.from_numpy(rng.integers(lo, hi, (M, K)).astype(np.int32))
    b = torch.from_numpy(rng.integers(lo, hi, (K, N)).astype(np.int32))
    F, G = ops.get_factors(design, rank, signed)
    return dict(a=a.to(device),
                b=b.to(torch.int8 if signed else torch.uint8).to(device),
                F=torch.from_numpy(F).to(device),
                G=torch.from_numpy(G).to(device),
                offset=128 if signed else 0)


def _resid_err(got, want) -> dict:
    err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-30)
    assert err <= RESID_TOL_REL * scale, \
        f"residual_matmul: max |kernel - plain| {err:.3e} > " \
        f"{RESID_TOL_REL} * max|out| ({scale:.3e})"
    return {"max_abs_err": err, "max_rel_err": err / scale}


def check_residual(case) -> dict:
    got = _launches("residual_matmul", lambda: ops.residual_matmul(**case))
    want = ref.residual_corrected_matmul_ref(**case)
    return _resid_err(got, want)


def fused_case(M, K, N, signed, seed, device, compensate=True):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, K)) * 1.7 + 0.3).astype(np.float32)
    off = 128 if signed else 0
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
    x[0, :4] = (np.arange(4) + 0.5).astype(np.float32) * sx  # .5 edges
    mu_r, mu_c, mu = _mean_field_tables("design2", signed)
    sw = (rng.uniform(0.5, 2.0, N) * 1e-3).astype(np.float32)
    comp_col = mu_c[qw + off].sum(0, dtype=np.float64).astype(np.float32)
    scal = np.array([sx, zx, mu, 0, 0, 0, 0, 0], np.float32)
    ntab = np.stack([sw, zw, qw.sum(0).astype(np.float32), comp_col])

    def t(v, dtype=None):
        v = torch.from_numpy(np.ascontiguousarray(v))
        return (v if dtype is None else v.to(dtype)).to(device)
    return dict(x=t(x), qw=t(qw, torch.int8 if signed else torch.uint8),
                dlut=t(build_delta_lut("design2", signed)), scal=t(scal),
                ntab=t(ntab.astype(np.float32)), comp_r=t(mu_r),
                signed=signed, compensate=compensate)


def check_fused(case) -> dict:
    out, qx, acc = _launches("fused_qdot", lambda: ops.fused_qdot_packed(
        **case, return_int=True))
    w_out, w_qx, w_acc = ref.fused_qdot_ref(
        case["x"], case["qw"], case["dlut"], case["scal"], case["ntab"],
        case["comp_r"], offset=128 if case["signed"] else 0,
        asym=not case["signed"], compensate=case["compensate"],
        return_int=True)
    assert torch.equal(qx, w_qx), "fused_qdot: quantized activations differ"
    assert torch.equal(acc, w_acc), "fused_qdot: int32 accumulators differ"
    err = float((out - w_out).abs().max())
    if case["compensate"]:
        bound = FUSED_ATOL_REL * float(w_out.abs().max())
        assert torch.allclose(out, w_out, rtol=FUSED_RTOL, atol=bound), \
            f"fused_qdot: max |kernel - plain| = {err}"
    else:
        assert torch.equal(out, w_out), f"fused_qdot: max |diff| = {err}"
    return {"max_abs_err": err,
            "max_rel_err": err / max(float(w_out.abs().max()), 1e-30)}


def attention_case(B, S, H, Kv, hd, seed, device, per_slot=True,
                   window=None, qk_norm=True, pos=None):
    """Inputs of one decode-attention step; ``pos`` (B,) overrides the
    random cache positions."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    q, k, v = t(B, H, hd), t(B, Kv, hd), t(B, Kv, hd)
    kc = t(B, S, Kv, hd).to(torch.bfloat16)
    vc = t(B, S, Kv, hd).to(torch.bfloat16)
    gq = torch.from_numpy(rng.uniform(0.5, 1.5, hd).astype(np.float32))
    gk = torch.from_numpy(rng.uniform(0.5, 1.5, hd).astype(np.float32))
    if pos is None:
        pos = (rng.integers(0, S, B) if per_slot else np.int64(S - 2))
    pos = torch.from_numpy(np.asarray(pos, np.int32))
    dev = {k_: x.to(device) for k_, x in dict(
        q=q, k_new=k, v_new=v, k_cache=kc, v_cache=vc, pos=pos).items()}
    dev["q_gain"] = gq.to(device) if qk_norm else None
    dev["k_gain"] = gk.to(device) if qk_norm else None
    return dict(dev, theta=10000.0, window=window)


def check_rows(got: torch.Tensor, want: torch.Tensor) -> int:
    """Hold bf16 k rows to ROW_RTOL / ROW_ATOL_REL / ROW_FLIP_MAX; return
    the number of entries that differ."""
    g, w = got.float(), want.float()
    bound = ROW_ATOL_REL * float(w.abs().max())
    err = float((g - w).abs().max())
    flips = int((g != w).sum())
    assert torch.allclose(g, w, rtol=ROW_RTOL, atol=bound), \
        f"decode_attention: k rows apart by up to {err:.3e} (bound " \
        f"{ROW_RTOL} relative + {bound:.3e})"
    assert flips <= ROW_FLIP_MAX * g.numel(), \
        f"decode_attention: {flips} of {g.numel()} k-row entries differ"
    return flips


def check_attention(case) -> dict:
    out, kr, vr = _launches("decode_attention",
                            lambda: ops.decode_attention_step(**case))
    w_out, w_kr, w_vr = ref.decode_attention_step_ref(**case)
    assert torch.equal(vr, w_vr), "decode_attention: v rows differ"
    flips = check_rows(kr, w_kr)
    err = float((out - w_out).abs().max())
    assert torch.allclose(out, w_out, rtol=ATTN_TOL, atol=ATTN_TOL), \
        f"decode_attention: max |kernel - plain| = {err}"
    return {"max_abs_err": err, "row_flips": flips,
            "row_entries": kr.numel()}


def _cpu(t):
    return t.cpu() if isinstance(t, torch.Tensor) else t


def attention_on_rows(args, kr, vr, theta, window):
    """The plain decode attention on the CPU, attending to the given bf16
    rows (the card's): qk-norm and rope of q, the rows appended at pos,
    masked GQA attention.  args: the CPU copies of decode_attention_step's
    (q, k_new, v_new, q_gain, k_gain, k_cache, v_cache, pos)."""
    q, _, _, q_gain, _, k_cache, v_cache, pos = args
    B, H, hd = q.shape
    pos = pos.reshape(-1).expand(B)
    positions = pos[:, None] + torch.arange(1, dtype=torch.int32)
    qr = q[:, None]
    if q_gain is not None:
        qr = ref._rmsnorm(qr, q_gain)
    if theta:
        qr = ref._rope(qr, positions, theta)
    ck, cv = k_cache.clone(), v_cache.clone()
    ref.write_rows(ck, kr[:, None], pos)
    ref.write_rows(cv, vr[:, None], pos)
    return ref.masked_attention(qr, ck, cv, pos, positions, n_heads=H,
                                n_kv=kr.shape[1], head_dim=hd,
                                window=window).reshape(B, H, hd)


class CpuShadow:
    """While active, every kernel launch also runs the kernel's plain
    version on the CPU, on copies of the same inputs, and holds the two to
    this module's tolerances; ``stats`` counts the launches and the gaps.
    The caller's arguments reach the kernels unchanged.

    The attention output is held against the CPU's attention over the
    card's own rows (a k row one bf16 step away moves a sharp softmax far
    more than float order does; the rows are held by check_rows), with
    the absolute part of ATTN_TOL scaled by max|v|, since the output is a
    convex combination of v rows."""

    SERVE = ("delta_matmul", "fused_qdot_packed", "decode_attention_step")
    TRAIN = ("lut_matmul", "residual_matmul")

    def __init__(self, names=SERVE):
        """names: the ops wrappers to shadow (the serving path's three by
        default; CpuShadow.TRAIN for the training kernels)."""
        self.names = tuple(names)

    def __enter__(self):
        shadows = {"delta_matmul": self._delta,
                   "fused_qdot_packed": self._fused,
                   "decode_attention_step": self._attention,
                   "lut_matmul": self._lut,
                   "residual_matmul": self._residual}
        self.saved = {n: getattr(ops, n) for n in self.names}
        self.stats = {n: {"calls": 0, "max_abs_err": 0.0, "row_flips": 0,
                          "row_entries": 0} for n in self.names}
        for n in self.names:
            setattr(ops, n, shadows[n])
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(ops, n, fn)

    def _note(self, name, err, flips=0, entries=0):
        st = self.stats[name]
        st["calls"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["row_flips"] += flips
        st["row_entries"] += entries

    def _delta(self, a, b, dlut, offset=0):
        out = self.saved["delta_matmul"](a, b, dlut, offset)
        want = ref.delta_matmul_ref(_cpu(a), _cpu(b), _cpu(dlut), offset)
        assert torch.equal(out.cpu(), want), "delta_matmul: card != cpu"
        self._note("delta_matmul", 0.0)
        return out

    def _lut(self, a, b, lut, unsigned, offset=0):
        out = self.saved["lut_matmul"](a, b, lut, unsigned, offset)
        want = ref.approx_matmul_ref(_cpu(a), _cpu(b),
                                     ops._widen(_cpu(lut), unsigned), offset)
        assert torch.equal(out.cpu(), want), "lut_matmul: card != cpu"
        self._note("lut_matmul", 0.0)
        return out

    def _residual(self, a, b, F, G, offset=0):
        out = self.saved["residual_matmul"](a, b, F, G, offset)
        want = ref.residual_corrected_matmul_ref(
            *(_cpu(t) for t in (a, b, F, G)), offset)
        self._note("residual_matmul", _resid_err(out.cpu(), want)
                   ["max_abs_err"])
        return out

    def _fused(self, x, qw, dlut, scal, ntab, comp_r, *, signed=False,
               compensate=False, return_int=False):
        res = self.saved["fused_qdot_packed"](
            x, qw, dlut, scal, ntab, comp_r, signed=signed,
            compensate=compensate, return_int=True)
        out, qx, acc = (t.cpu() for t in res)
        w_out, w_qx, w_acc = ref.fused_qdot_ref(
            *(_cpu(t) for t in (x, qw, dlut, scal, ntab, comp_r)),
            offset=128 if signed else 0, asym=not signed,
            compensate=compensate, return_int=True)
        assert torch.equal(qx, w_qx), "fused_qdot: qx card != cpu"
        assert torch.equal(acc, w_acc), "fused_qdot: acc card != cpu"
        err = float((out - w_out).abs().max())
        bound = FUSED_ATOL_REL * float(w_out.abs().max())
        assert torch.allclose(out, w_out, rtol=FUSED_RTOL, atol=bound), \
            f"fused_qdot: max |card - cpu| {err:.3e}"
        self._note("fused_qdot_packed", err)
        return res if return_int else res[0]

    def _attention(self, q, k_new, v_new, q_gain, k_gain, k_cache, v_cache,
                   pos, *, theta=10000.0, window=None):
        res = self.saved["decode_attention_step"](
            q, k_new, v_new, q_gain, k_gain, k_cache, v_cache, pos,
            theta=theta, window=window)
        out, kr, vr = (t.cpu() for t in res)
        args = [_cpu(t) for t in (q, k_new, v_new, q_gain, k_gain, k_cache,
                                  v_cache, pos)]
        _, w_kr, w_vr = ref.decode_attention_step_ref(
            *args, theta=theta, window=window)
        assert torch.equal(vr, w_vr), "decode_attention: v row card != cpu"
        flips = check_rows(kr, w_kr)
        w_out = attention_on_rows(args, kr, vr, theta, window)
        vmax = max(float(args[6].float().abs().max()),
                   float(vr.float().abs().max()))
        err = float((out - w_out).abs().max())
        assert torch.allclose(out, w_out, rtol=ATTN_TOL,
                              atol=ATTN_TOL * vmax), \
            f"decode_attention: max |card - cpu| {err:.3e} (max |v| " \
            f"{vmax:.3e})"
        self._note("decode_attention_step", err, flips, kr.numel())
        return res
