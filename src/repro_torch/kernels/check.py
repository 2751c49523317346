"""Hold each CUDA kernel against its plain PyTorch version on the card.

Used by ``chip_smoke.py`` (at the main path's full-width shapes) and by
``tests/test_torch_gpu.py`` (small and ragged shapes).  Inputs come from
a numpy seed and are moved to the device; each ``check_*`` runs the
kernel wrapper and the plain version on the same tensors and raises
AssertionError beyond the stated tolerances, returning the measured gaps.

Tolerances, and why:
  delta_matmul      exact: integer arithmetic in any order (with a biased
                    table too: the sums are exact modulo 2^32).
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
                    output (a two-pass softmax per tile of positions,
                    merged across tiles and chunks, vs one softmax over
                    all; the dot-product order) within ATTN_TOL absolute
                    and relative, every head, also where its k row moved
                    a bf16 step.  Two launches are bit-equal; with the
                    append the output is bit-equal to the step's, the
                    rows land in the caches at pos and every other row
                    is unchanged.
"""
from __future__ import annotations

import time

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


def cuda_time(fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean ms per call of fn() on the card: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.

    ``queued`` (a wrapper's ``device_ms``): the calls are queued behind a
    spin on the card (torch.cuda._sleep) at least twice as long as the
    host took to issue them, so the events time the card's work and not
    the host's launch rate; it is checked that the host had issued every
    call before the first one started."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spin = 0
    if queued:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        spin = int(2 * (time.perf_counter() - t0) * 2e9) + 10**6  # <= 2 GHz
    for _ in range(4):
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not spin or not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin *= 4
    raise AssertionError("cuda_time: the card started before the host had "
                         "queued the timed calls")


def _weight_operand(rng, seed, K, N, lo, hi, device,
                    device_draw: bool) -> torch.Tensor:
    """A (K, N) int32 operand uniform in [lo, hi): numpy's draw from
    ``rng``, or with ``device_draw`` torch's on ``device`` from ``seed``
    (numpy's draw of a weight of 1e8-1e9 entries takes host seconds)."""
    if not device_draw:
        return torch.from_numpy(rng.integers(lo, hi, (K, N)).astype(
            np.int32))
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(lo, hi, (K, N), generator=g, device=device,
                         dtype=torch.int32)


def delta_case(M, K, N, signed, seed, device, design="design2",
               device_draw=False):
    """Inputs of one delta_matmul launch, the design's delta table as
    ops.narrow_delta narrows it (biased uint16 for the unsigned
    'initial'); the weights drawn on the device with ``device_draw``."""
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = torch.from_numpy(rng.integers(lo, hi, (M, K)).astype(np.int32))
    b = _weight_operand(rng, seed, K, N, lo, hi, device, device_draw)
    d, unsigned, bias = ops.narrow_delta(build_delta_lut(design, signed))
    return dict(a=a.to(device),
                b=b.to(torch.int8 if signed else torch.uint8).to(device),
                dlut=d.to(device), offset=128 if signed else 0,
                unsigned=unsigned, bias=bias)


def delta_plain(case) -> torch.Tensor:
    """The plain version of one delta_matmul launch, on the int32 (or
    int16) table the narrowed one stands for."""
    return ref.delta_matmul_ref(
        case["a"], case["b"],
        ops.widen_delta(case["dlut"], case.get("unsigned", False),
                        case.get("bias", 0)), case["offset"])


# nemotron-4-340b's w_down: 255 * 255 * K passes 2^31 (from K = 33,026)
RANGE_K = 73_728


def range_delta_case(M, N, seed, device, design="design2", K=RANGE_K):
    """asym_u8 delta_matmul operands at the top of the grid (row 0 and
    column 0 all 255, the rest in [220, 255]) at K = RANGE_K, so that
    every exact product passes 2^31 and the int32 sums wrap modulo 2^32,
    as the reference's int32 accumulation does (for 'initial' the delta
    sum passes it too)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(220, 256, (M, K)).astype(np.int32)
    b = rng.integers(220, 256, (K, N)).astype(np.int32)
    a[0], b[:, 0] = 255, 255
    d, unsigned, bias = ops.narrow_delta(build_delta_lut(design, False))
    return dict(a=torch.from_numpy(a).to(device),
                b=torch.from_numpy(b).to(torch.uint8).to(device),
                dlut=d.to(device), offset=0, unsigned=unsigned, bias=bias)


def range_fused_case(M, N, seed, device, compensate=True, K=RANGE_K):
    """asym_u8 fused_qdot operands whose activations quantize to the top
    of the grid (row 0 to 255) against range_delta_case's weights: the
    int32 accumulator wraps past 2^31 as the reference's does."""
    case = fused_case(M, K, N, False, seed, device, compensate=compensate)
    rng = np.random.default_rng(seed + 1)
    sx, zx = np.float32(0.01), np.float32(3.0)
    x = ((rng.integers(225, 256, (M, K)) - zx) * sx).astype(np.float32)
    x[0] = 5.0
    qw = range_delta_case(1, N, seed, "cpu", K=K)["b"]
    scal = case["scal"].cpu().clone()
    scal[0], scal[1] = float(sx), float(zx)
    ntab = case["ntab"].cpu().clone()
    ntab[2] = qw.to(torch.int32).sum(0).float()
    return dict(case, x=torch.from_numpy(x).to(device), qw=qw.to(device),
                scal=scal.to(device), ntab=ntab.to(device))


def check_range(case, kind: str) -> dict:
    """A range case (range_delta_case or range_fused_case) through its
    kernel against the plain version on the card, and the card's plain
    version against the CPU's (the int32 words wrap alike on both).
    Returns the check's result with ``past_2_31``, the outputs whose
    exact product passes 2^31."""
    cpu = {k: _cpu(v) for k, v in case.items()}
    if kind == "delta_matmul":
        r = check_delta(case)
        assert torch.equal(delta_plain(case).cpu(), delta_plain(cpu)), \
            "delta_matmul: the card's plain version != the CPU's"
        a, b = cpu["a"], cpu["b"]
    else:
        r = check_fused(case)
        w_out, a, w_acc = fused_plain(cpu, return_int=True)
        out, _, acc = fused_plain(case, return_int=True)
        assert torch.equal(acc.cpu(), w_acc) and torch.equal(out.cpu(),
                                                             w_out), \
            "fused_qdot: the card's plain version != the CPU's"
        b = cpu["qw"]
    past = int((torch.matmul(a.double(), b.double()) >= 2**31).sum())
    assert past > 0, "the range case does not pass 2^31"
    return dict(r, past_2_31=past)


def check_delta(case) -> dict:
    got = _launches("delta_matmul", lambda: ops.delta_matmul(**case))
    assert torch.equal(got, delta_plain(case)), "delta_matmul: kernel != plain"
    return {"max_abs_err": 0.0}


def sweep_values(signed: bool) -> np.ndarray:
    """Every int8 (signed) or uint8 operand value, ascending."""
    return np.arange(-128, 128) if signed else np.arange(256)


def delta_sweep_case(design, signed, device, rows=slice(None)):
    """delta_case over the 65,536 operand pairs: a (256, 1) every value,
    b (1, 256) every value, so the output is the design's product table.
    ``rows``: a slice of a's rows (4 rows take the split-K schedule)."""
    v = sweep_values(signed)
    return dict(delta_case(1, 1, 1, signed, 0, device, design=design),
                a=torch.from_numpy(v[rows, None].astype(np.int32)).to(device),
                b=torch.from_numpy(v[None, :].astype(
                    np.int8 if signed else np.uint8)).to(device))


def fused_sweep_case(design, signed, device, rows=slice(None)):
    """fused_case over the 65,536 operand pairs: x (n, 1) every value
    with scale 1 and zero point 0, so qx = x, and qw (1, 256) every
    value; no compensation, weight scale 1 and zero point 0, so the
    output and the accumulator are the design's product table."""
    v = sweep_values(signed)
    case = fused_case(1, 4, 256, signed, 0, device, compensate=False,
                      design=design)
    ntab = np.zeros((4, 256), np.float32)
    ntab[0], ntab[2] = 1.0, v
    return dict(case,
                x=torch.from_numpy(v[rows, None].astype(np.float32)).to(
                    device),
                qw=torch.from_numpy(v[None, :].astype(
                    np.int8 if signed else np.uint8)).to(device),
                scal=torch.tensor([1.0] + [0.0] * 7, device=device),
                ntab=torch.from_numpy(ntab).to(device))


def check_sweeps(design, signed, device) -> int:
    """The 65,536-pair sweep through delta_matmul and fused_qdot on both
    schedules (the tile schedule on all 256 rows, split-K on 4 rows at a
    time), each launch held to its plain version and the rows to the
    design's product table; returns the launches made."""
    from ..core.lut import build_lut, build_signed_lut
    table = torch.from_numpy((build_signed_lut if signed else build_lut)(
        design).astype(np.int32))
    n = 0
    for rows in [slice(None)] + [slice(i, i + 4) for i in range(0, 256, 4)]:
        case = delta_sweep_case(design, signed, device, rows)
        check_delta(case)
        got = ops.delta_matmul(**case)
        assert torch.equal(got.cpu(), table[rows]), \
            "delta_matmul: sweep != product table"
        case = fused_sweep_case(design, signed, device, rows)
        check_fused(case)
        _, _, acc = ops.fused_qdot_packed(**case, return_int=True)
        assert torch.equal(acc.cpu(), table[rows]), \
            "fused_qdot: sweep != product table"
        n += 4
    return n


BANK_DESIGNS = ("design1", "design2", "design1_trunc4")


def check_bank_rows(M, K, N, signed, seed, device,
                    designs=BANK_DESIGNS) -> int:
    """A plan's bank as the kernels see it: an int16 (n, 256, 256) bank of
    ``designs`` on the device, each row (a view, 16-byte aligned) passed
    to delta_matmul and fused_qdot, held to the plain version and
    bit-equal to the same table passed alone.  Returns the launches."""
    bank = torch.stack([ops.narrow_delta(build_delta_lut(d, signed))[0]
                        for d in designs]).to(device)
    n = 0
    for i, d in enumerate(designs):
        row = bank[i]
        assert row.is_contiguous() and row.data_ptr() % 16 == 0
        case = delta_case(M, K, N, signed, seed + i, device, design=d)
        check_delta(dict(case, dlut=row))
        assert torch.equal(ops.delta_matmul(**dict(case, dlut=row)),
                           ops.delta_matmul(**case)), \
            "delta_matmul: a bank row != the table alone"
        f = fused_case(M, K, N, signed, seed + i, device, design=d)
        check_fused(dict(f, dlut=row))
        for x, y in zip(ops.fused_qdot_packed(**dict(f, dlut=row),
                                              return_int=True),
                        ops.fused_qdot_packed(**f, return_int=True)):
            assert torch.equal(x, y), "fused_qdot: a bank row != alone"
        n += 4
    return n


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
             pattern="uniform", shifted=True, device_draw=False):
    """Inputs of one lut_matmul launch: the narrowed product table and
    operands drawn by lut_indices.  ``shifted``: as the Pallas function
    takes them, pre-shifted into [0, 255] (uint8 b, offset 0); otherwise
    as the 'xla' backend passes them, int8-valued with offset 128 when
    ``signed``.  ``device_draw``: the uniform weights drawn on the
    device."""
    rng = np.random.default_rng(seed)
    if device_draw:
        if pattern != "uniform":
            raise ValueError("device_draw draws uniform operands only")
        a = rng.integers(0, 256, (M, K))
        b = _weight_operand(rng, seed, K, N, 0, 256, device, True)
    else:
        a, b = lut_indices(M, K, N, pattern, rng)
        b = torch.from_numpy(b)
    off = 128 if signed and not shifted else 0
    lut, unsigned = ops.narrow_lut(ops.get_signed_lut(design) if signed
                                   else ops.get_lut(design))
    return dict(a=torch.from_numpy((a - off).astype(np.int32)).to(device),
                b=(b - off).to(torch.int8 if off else torch.uint8).to(
                    device),
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


def residual_case(M, K, N, signed, rank, seed, device, design="design2",
                  device_draw=False):
    """Inputs of one residual_matmul launch: uniform operands and the
    rank-``rank`` factors; ``device_draw``: the weights drawn on the
    device."""
    rng = np.random.default_rng(seed)
    lo, hi = (-128, 128) if signed else (0, 256)
    a = torch.from_numpy(rng.integers(lo, hi, (M, K)).astype(np.int32))
    b = _weight_operand(rng, seed, K, N, lo, hi, device, device_draw)
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


def fused_case(M, K, N, signed, seed, device, compensate=True,
               design="design2", sx=None, device_draw=False):
    """Inputs of one fused_qdot launch.  ``sx``: the static activation
    scale, in place of the one the rows' range gives (zero point 0): 1e-8
    is the scale calibration gives a site that saw only zero rows (an
    MoE expert that got padding alone), which sends every nonzero row
    to the ends of the grid.  ``device_draw``: the weights drawn on the
    device."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, K)) * 1.7 + 0.3).astype(np.float32)
    off = 128 if signed else 0
    if signed:
        qw = _weight_operand(rng, seed, K, N, -128, 128, device,
                             device_draw)
        zw = np.zeros(N, np.float32)
    else:
        qw = _weight_operand(rng, seed, K, N, 0, 256, device, device_draw)
        zw = rng.integers(100, 160, N).astype(np.float32)
    if sx is not None:
        sx, zx = np.float32(sx), np.float32(0.0)
        x[0, :4] = 0.0                    # zero (padding) entries
    else:
        if signed:
            sx = np.float32(np.abs(x).max() / 127.0)
            zx = np.float32(0.0)
        else:
            sx = np.float32((x.max() - x.min()) / 255.0)
            zx = np.float32(np.clip(np.round(-x.min() / sx), 0, 255))
        x[0, :4] = (np.arange(4) + 0.5).astype(np.float32) * sx  # .5 edges
    mu_r, mu_c, mu = _mean_field_tables(design, signed)
    sw = (rng.uniform(0.5, 2.0, N) * 1e-3).astype(np.float32)
    # the weights' column sums in float64, rounded once, where qw lies
    # (K in slices: a weight drawn on the card has up to 1e9 entries)
    mu_t = torch.from_numpy(mu_c.astype(np.float64)).to(qw.device)
    acc = torch.zeros(N, dtype=torch.float64, device=qw.device)
    for k0 in range(0, K, 2048):
        acc += mu_t[qw[k0:k0 + 2048].long() + off].sum(0)
    comp_col = acc.float().cpu().numpy()
    colsum = qw.sum(0, dtype=torch.int64).float().cpu().numpy()
    scal = np.array([sx, zx, mu, 0, 0, 0, 0, 0], np.float32)
    ntab = np.stack([sw, zw, colsum, comp_col])

    def t(v, dtype=None):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return (v if dtype is None else v.to(dtype)).to(device)
    dlut, unsigned, bias = ops.narrow_delta(build_delta_lut(design, signed))
    return dict(x=t(x), qw=t(qw, torch.int8 if signed else torch.uint8),
                dlut=dlut.to(device), scal=t(scal),
                ntab=t(ntab.astype(np.float32)), comp_r=t(mu_r),
                signed=signed, compensate=compensate, unsigned=unsigned,
                bias=bias)


def fused_plain(case, return_int: bool = False):
    """The plain version of one fused_qdot launch."""
    return ref.fused_qdot_ref(
        case["x"], case["qw"],
        ops.widen_delta(case["dlut"], case.get("unsigned", False),
                        case.get("bias", 0)),
        case["scal"], case["ntab"], case["comp_r"],
        offset=128 if case["signed"] else 0, asym=not case["signed"],
        compensate=case["compensate"], return_int=return_int)


def check_fused(case) -> dict:
    out, qx, acc = _launches("fused_qdot", lambda: ops.fused_qdot_packed(
        **case, return_int=True))
    w_out, w_qx, w_acc = fused_plain(case, return_int=True)
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


def attention_edge_positions(S: int, B: int, Kv: int, hd: int,
                             sms: int = ops.ATTN_SMS) -> list:
    """Cache positions that probe the kernel's split of S positions
    (ops.attention_chunks, tiles of ops.attention_tile_rows within a
    chunk): 0, S-1 and both sides of every chunk and tile edge."""
    chunks, rows = ops.attention_chunks(S, B, Kv, sms)
    sr = ops.attention_tile_rows(rows, hd)
    edges = [e for c in range(chunks) for t in range(0, rows, sr)
             for e in (c * rows + t - 1, c * rows + t) if 0 < c * rows + t]
    return sorted({0, S - 1, *(e for e in edges if e < S)})


def check_attention(case) -> dict:
    """The kernel's step (no append) against its plain version: every
    head within ATTN_TOL of the plain output, also where the kernel's k
    row of a (slot, kv head) landed a bf16 step from the plain version's
    (check_rows allows it); two launches bit-equal.  Returns, beside the
    error, the (slot, kv head) pairs whose k row moved (``flipped``) and
    the max error over their heads (``flipped_err``)."""
    out, kr, vr = _launches("decode_attention",
                            lambda: ops.decode_attention_step(**case))
    w_out, w_kr, w_vr = ref.decode_attention_step_ref(**case)
    assert torch.equal(vr, w_vr), "decode_attention: v rows differ"
    flips = check_rows(kr, w_kr)
    err = float((out - w_out).abs().max())
    assert torch.allclose(out, w_out, rtol=ATTN_TOL, atol=ATTN_TOL), \
        f"decode_attention: max |kernel - plain| = {err}"
    again = ops.decode_attention_step(**case)
    assert all(torch.equal(x, y) for x, y in zip((out, kr, vr), again)), \
        "decode_attention: two launches differ"
    moved = (kr != w_kr).any(-1)                             # (B, Kv)
    heads = moved.repeat_interleave(out.shape[1] // kr.shape[1], dim=1)
    flipped_err = float((out - w_out)[heads].abs().max()) \
        if bool(moved.any()) else 0.0
    return {"max_abs_err": err, "row_flips": flips,
            "row_entries": kr.numel(), "flipped": moved.nonzero().tolist(),
            "flipped_err": flipped_err}


def check_attention_append(case) -> dict:
    """ops.decode_attention (the kernel with the append) on copies of the
    case's caches: the output bit-equal to the step's, row pos of each
    cache the plain version's row (v bit-equal, k by check_rows), every
    other row bit-equal to its value before the call."""
    q, k, v = case["q"], case["k_new"], case["v_new"]
    B, H, hd = q.shape
    Kv = k.shape[1]
    kc, vc = case["k_cache"].clone(), case["v_cache"].clone()
    out, ck, cv = _launches("decode_attention", lambda: ops.decode_attention(
        q[:, None], k[:, None], v[:, None], kc, vc, case["pos"], n_heads=H,
        n_kv=Kv, head_dim=hd, rope_theta=case["theta"],
        window=case["window"], q_gain=case["q_gain"],
        k_gain=case["k_gain"]))
    assert ck is kc and cv is vc, "decode_attention: not in place"
    step = ops.decode_attention_step(**case)[0]
    assert torch.equal(out.reshape(B, H, hd), step), \
        "decode_attention: the append's output differs from the step's"
    _, w_kr, w_vr = ref.decode_attention_step_ref(**case)
    flips = _appended_rows(kc, vc, case["k_cache"], case["v_cache"],
                           case["pos"], w_kr, w_vr)
    return {"row_flips": flips, "row_entries": w_kr.numel()}


def _appended_rows(kc, vc, k_before, v_before, pos, w_kr, w_vr) -> int:
    """Hold caches after an append against their copies from before it:
    row pos[b] of slot b is the plain version's row (v bit-equal, k by
    check_rows), every other row bit-equal; returns the k-row flips."""
    B, S = kc.shape[:2]
    p = pos.reshape(-1).expand(B).long()
    b = torch.arange(B, device=p.device)
    other = torch.ones((B, S), dtype=torch.bool, device=p.device)
    other[b, p] = False
    for new, old in ((kc, k_before), (vc, v_before)):
        assert torch.equal(new[other], old[other]), \
            "decode_attention: the append changed another cache row"
    assert torch.equal(vc[b, p], w_vr), "decode_attention: v rows differ"
    return check_rows(kc[b, p], w_kr)


def _cpu(t):
    return t.cpu() if isinstance(t, torch.Tensor) else t


def attention_on_rows(args, kr, vr, theta, window):
    """The plain decode attention, attending to the given bf16 rows (the
    card's): qk-norm and rope of q, the rows appended at pos, masked GQA
    attention.  args: decode_attention_step's (q, k_new, v_new, q_gain,
    k_gain, k_cache, v_cache, pos), all on the rows' device."""
    q, _, _, q_gain, _, k_cache, v_cache, pos = args
    B, H, hd = q.shape
    pos = pos.reshape(-1).expand(B)
    positions = pos[:, None] + torch.arange(1, dtype=torch.int32,
                                            device=pos.device)
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

    The attention op appends on the card: the card's rows are read from
    its caches at pos, and every other row is held equal to a copy taken
    before the call.  The attention output is held against the CPU's
    attention over the card's own rows (a k row one bf16 step away moves a sharp softmax far
    more than float order does; the rows are held by check_rows), with
    the absolute part of ATTN_TOL scaled by max|v|, since the output is a
    convex combination of v rows."""

    SERVE = ("delta_matmul", "fused_qdot_packed", "decode_attention")
    TRAIN = ("lut_matmul", "residual_matmul")

    def __init__(self, names=SERVE, card_gathers=None):
        """names: the ops wrappers to shadow (the calibrated serving
        path's three by default, ``serving(backend)`` for a served run on
        another backend, CpuShadow.TRAIN for the training kernels).
        ``card_gathers``: a delta_matmul, fused_qdot, lut_matmul or
        residual_matmul launch of more than this many gathers (M*K*N) is
        held against its plain version on the card (delta_plain,
        fused_plain, lut_plain, residual_corrected_matmul_ref), not on
        the CPU (the vocabulary-wide unembed at prefill size, the
        MoE experts and internvl2's projections at full width); ``stats``
        counts those launches as ``on_card``."""
        self.names = tuple(names)
        self.card_gathers = card_gathers

    @classmethod
    def serving(cls, backend: str):
        """The wrappers a served run on ``backend`` launches: the
        attention op and the product of ops.approx_matmul's backend
        ('fused' also runs its calibration and its unfused calls through
        delta_matmul; 'exact' launches no product kernel)."""
        if backend in ops.LUT_BACKENDS:
            prod = ("lut_matmul",)
        elif backend in ops.RESIDUAL_BACKENDS:
            prod = ("residual_matmul",)
        elif backend == "fused":
            prod = ("delta_matmul", "fused_qdot_packed")
        elif backend == "exact":
            prod = ()
        else:
            prod = ("delta_matmul",)
        return prod + ("decode_attention",)

    def __enter__(self):
        shadows = {"delta_matmul": self._delta,
                   "fused_qdot_packed": self._fused,
                   "decode_attention": self._attention,
                   "lut_matmul": self._lut,
                   "residual_matmul": self._residual}
        self.saved = {n: getattr(ops, n) for n in self.names}
        self.stats = {n: {"calls": 0, "max_abs_err": 0.0, "row_flips": 0,
                          "row_entries": 0, "on_card": 0}
                      for n in self.names}
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

    def _delta(self, a, b, dlut, offset=0, *, unsigned=False, bias=0):
        out = self.saved["delta_matmul"](a, b, dlut, offset,
                                         unsigned=unsigned, bias=bias)
        case = dict(a=a, b=b, dlut=dlut, offset=offset, unsigned=unsigned,
                    bias=bias)
        gathers = a.shape[0] * a.shape[1] * b.shape[1]
        if self.card_gathers is not None and gathers > self.card_gathers:
            assert torch.equal(out, delta_plain(case)), \
                "delta_matmul: kernel != plain on the card"
            self.stats["delta_matmul"]["on_card"] += 1
        else:
            want = delta_plain({k: _cpu(v) for k, v in case.items()})
            assert torch.equal(out.cpu(), want), "delta_matmul: card != cpu"
        self._note("delta_matmul", 0.0)
        return out

    def _lut(self, a, b, lut, unsigned, offset=0):
        out = self.saved["lut_matmul"](a, b, lut, unsigned, offset)
        case = dict(a=a, b=b, lut=lut, unsigned=unsigned, offset=offset)
        gathers = a.shape[0] * a.shape[1] * b.shape[1]
        if self.card_gathers is not None and gathers > self.card_gathers:
            assert torch.equal(out, lut_plain(case)), \
                "lut_matmul: kernel != plain on the card"
            self.stats["lut_matmul"]["on_card"] += 1
        else:
            want = lut_plain({k: _cpu(v) for k, v in case.items()})
            assert torch.equal(out.cpu(), want), "lut_matmul: card != cpu"
        self._note("lut_matmul", 0.0)
        return out

    def _residual(self, a, b, F, G, offset=0):
        out = self.saved["residual_matmul"](a, b, F, G, offset)
        gathers = a.shape[0] * a.shape[1] * b.shape[1]
        if self.card_gathers is not None and gathers > self.card_gathers:
            want = ref.residual_corrected_matmul_ref(a, b, F, G, offset)
            err = _resid_err(out, want)["max_abs_err"]
            self.stats["residual_matmul"]["on_card"] += 1
        else:
            want = ref.residual_corrected_matmul_ref(
                *(_cpu(t) for t in (a, b, F, G)), offset)
            err = _resid_err(out.cpu(), want)["max_abs_err"]
        self._note("residual_matmul", err)
        return out

    def _fused(self, x, qw, dlut, scal, ntab, comp_r, *, signed=False,
               compensate=False, return_int=False, unsigned=False, bias=0):
        res = self.saved["fused_qdot_packed"](
            x, qw, dlut, scal, ntab, comp_r, signed=signed,
            compensate=compensate, return_int=True, unsigned=unsigned,
            bias=bias)
        case = dict(x=x, qw=qw, dlut=dlut, scal=scal, ntab=ntab,
                    comp_r=comp_r, signed=signed, compensate=compensate,
                    unsigned=unsigned, bias=bias)
        gathers = x.shape[0] * x.shape[1] * qw.shape[1]
        if self.card_gathers is not None and gathers > self.card_gathers:
            self.stats["fused_qdot_packed"]["on_card"] += 1
        else:
            case = {k: _cpu(v) for k, v in case.items()}
        out, qx, acc = (t.to(case["x"].device) for t in res)
        w_out, w_qx, w_acc = fused_plain(case, return_int=True)
        assert torch.equal(qx, w_qx), "fused_qdot: qx card != cpu"
        assert torch.equal(acc, w_acc), "fused_qdot: acc card != cpu"
        err = float((out - w_out).abs().max())
        bound = FUSED_ATOL_REL * float(w_out.abs().max())
        assert torch.allclose(out, w_out, rtol=FUSED_RTOL, atol=bound), \
            f"fused_qdot: max |card - cpu| {err:.3e}"
        self._note("fused_qdot_packed", err)
        return res if return_int else res[0]

    def _attention(self, q, k, v, k_cache, v_cache, idx, *, n_heads,
                   n_kv, head_dim, rope_theta=10000.0, window=None,
                   q_gain=None, k_gain=None):
        B = q.shape[0]
        args = [_cpu(t) for t in (
            q.reshape(B, n_heads, head_dim), k.reshape(B, n_kv, head_dim),
            v.reshape(B, n_kv, head_dim), q_gain, k_gain, k_cache, v_cache,
            idx)]                     # the caches copied before the call
        res = self.saved["decode_attention"](
            q, k, v, k_cache, v_cache, idx, n_heads=n_heads, n_kv=n_kv,
            head_dim=head_dim, rope_theta=rope_theta, window=window,
            q_gain=q_gain, k_gain=k_gain)
        _, w_kr, w_vr = ref.decode_attention_step_ref(
            *args, theta=rope_theta, window=window)
        kc, vc = k_cache.cpu(), v_cache.cpu()
        flips = _appended_rows(kc, vc, args[5], args[6], args[7], w_kr, w_vr)
        pos = args[7].reshape(-1).expand(B).long()
        b = torch.arange(B)
        kr, vr = kc[b, pos], vc[b, pos]      # the card's rows
        out = res[0].cpu().reshape(B, n_heads, head_dim)
        w_out = attention_on_rows(args, kr, vr, rope_theta, window)
        vmax = max(float(args[6].float().abs().max()),
                   float(vr.float().abs().max()))
        err = float((out - w_out).abs().max())
        assert torch.allclose(out, w_out, rtol=ATTN_TOL,
                              atol=ATTN_TOL * vmax), \
            f"decode_attention: max |card - cpu| {err:.3e} (max |v| " \
            f"{vmax:.3e})"
        self._note("decode_attention", err, flips, kr.numel())
        return res
