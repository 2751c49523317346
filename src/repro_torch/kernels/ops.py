"""Kernel wrappers and the operators the quantized layers call.

Five kernels, each written by hand in CUDA C++ for Hopper
(``csrc/*.cu``) with its plain PyTorch version in ``ref``:

  delta_matmul      exact integer product + delta-table gather (split-K
                    over every SM for M <= 4)
  fused_qdot        static activation quantization (a pre-pass, once per
                    row) + the delta product + the dequant epilogue
                    (split-K over every SM for M <= 8)
  decode_attention  qk-norm + rope + bf16 row rounding + masked GQA
                    attention, one decode step, split over the cache
                    positions (ops.attention_chunks), the cache append
                    inside the kernel
  lut_matmul        product-LUT gather sum (16-bit table in shared memory)
  residual_matmul   exact product + rank-r error correction, float32, as
                    a gather sum over the correction table C = F G

delta_matmul and fused_qdot keep the delta table in 16 bits
(``narrow_delta``: int16, or uint16 with a bias for the unsigned
'initial').  The lowering follows the tensors' device: a CUDA tensor
launches the kernel (or the wrapper raises on what the kernel does not
take), a CPU tensor takes the plain version.  There is no fallback from
one to the other.  ``LAUNCHES`` counts the kernel launches of each
wrapper; while tracing, each launch is also credited to the innermost
open span of ``trace``.  ``SCHEDULES`` counts the schedule that each
fused_qdot call on the card launched, as its launcher reports it.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from .. import trace
from . import ref

# kernel name -> number of launches in this process (reset_launches)
LAUNCHES = {"delta_matmul": 0, "fused_qdot": 0, "decode_attention": 0,
            "lut_matmul": 0, "residual_matmul": 0}
# "fused_qdot.<schedule>" -> calls on the card, by the schedule the C
# launcher reports it launched: splitk4, splitk8 (the split-K schedule at
# 4 and 8 rows a thread) or tile
SCHEDULES: Counter = Counter()
_FUSED_SCHEDULES = {4: "fused_qdot.splitk4", 8: "fused_qdot.splitk8",
                    0: "fused_qdot.tile"}

_LUT_CACHE: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SCHEDULES.clear()


def _launched(name: str) -> None:
    """Count one launch of kernel ``name``: in LAUNCHES and, while
    tracing, in the innermost open span."""
    LAUNCHES[name] += 1
    trace.launched()


def get_lut(design: str) -> np.ndarray:
    """(256,256) int32 product table of a registered design; 'exact'
    is the true product."""
    if design not in _LUT_CACHE:
        if design == "exact":
            v = np.arange(256, dtype=np.int64)
            _LUT_CACHE[design] = (v[:, None] * v[None, :]).astype(np.int32)
        else:
            from ..core import lut as lutmod
            _LUT_CACHE[design] = lutmod.build_lut(design)
    return _LUT_CACHE[design]


def get_signed_lut(design: str) -> np.ndarray:
    """(256,256) int32 signed product table indexed [a+128, b+128]."""
    key = ("signed", design)
    if key not in _LUT_CACHE:
        from ..core import lut as lutmod
        _LUT_CACHE[key] = lutmod.build_signed_lut(design)
    return _LUT_CACHE[key]


def get_delta_lut(design: str, signed: bool = False) -> np.ndarray:
    """Delta table D = approx - exact, int16 where the design's error
    range allows (core.lut.build_delta_lut)."""
    key = ("delta", design, signed)
    if key not in _LUT_CACHE:
        from ..core import lut as lutmod
        _LUT_CACHE[key] = lutmod.build_delta_lut(design, signed)
    return _LUT_CACHE[key]


def get_factors(design: str, rank: int = 32, signed: bool = False):
    """(F (256, rank), G (rank, 256)) float32 SVD factors of the design's
    error surface (core.lut.error_factors / signed_error_factors)."""
    from ..core import lut as lutmod
    fn = lutmod.signed_error_factors if signed else lutmod.error_factors
    F, G, _ = fn(design, rank)
    return F, G


def narrow_lut(lut):
    """A (256,256) product table narrowed to 16 bits for the lut_matmul
    kernel: (int16 tensor holding the entries' low 16 bits, unsigned),
    where ``unsigned`` says the bits are read as uint16 (every value in
    [0, 65535]) rather than int16 (every value in [-32768, 32767]).
    Raises ValueError for a table that fits neither."""
    arr = np.asarray(lut.cpu() if isinstance(lut, torch.Tensor) else lut)
    if arr.shape != (256, 256) or arr.dtype.kind not in "iu":
        raise ValueError(f"lut_matmul: the table must be a (256, 256) "
                         f"integer table, got {arr.dtype} {arr.shape}")
    lo, hi = int(arr.min()), int(arr.max())
    if 0 <= lo and hi <= 0xFFFF:
        bits = arr.astype(np.uint16).view(np.int16)
        return torch.from_numpy(bits), True
    if -0x8000 <= lo and hi <= 0x7FFF:
        return torch.from_numpy(arr.astype(np.int16)), False
    raise ValueError(f"lut_matmul: table values span [{lo}, {hi}], which "
                     f"fits neither uint16 nor int16 (the kernel keeps a "
                     f"16-bit table in shared memory)")


def lut_table(design: str, signed: bool, device):
    """The design's product table narrowed by narrow_lut, on ``device``
    (cached per device): (int16 tensor, unsigned)."""
    key = ("lut_t", design, signed, str(torch.device(device)))
    if key not in _LUT_CACHE:
        t, unsigned = narrow_lut(get_signed_lut(design) if signed
                                 else get_lut(design))
        _LUT_CACHE[key] = (t.to(device), unsigned)
    return _LUT_CACHE[key]


def product_table(design: str, signed: bool, device) -> torch.Tensor:
    """The design's (256,256) int32 product table (signed: indexed [a+128,
    b+128]) on ``device`` (cached per device): what approx_mul gathers
    from, and the reference's app tables ``_lut_for`` / ``_slut_for``."""
    key = ("prod_t", design, signed, str(torch.device(device)))
    if key not in _LUT_CACHE:
        t = get_signed_lut(design) if signed else get_lut(design)
        _LUT_CACHE[key] = torch.from_numpy(
            np.ascontiguousarray(t, dtype=np.int32)).to(device)
    return _LUT_CACHE[key]


def approx_mul(a: torch.Tensor, b: torch.Tensor, design: str = "design2",
               signed: bool = False) -> torch.Tensor:
    """Elementwise approximate product (the image pipelines'), int32:
    a gather from the design's flattened product table at
    (a+off)*256 + (b+off), off = 128 when ``signed``.  Operands broadcast
    and take the device of ``a`` (``b`` may be a 0-dim CPU tensor, a
    scalar to the ops).  Torch ops on every device: the reference
    reaches no Pallas kernel here either."""
    off = 128 if signed else 0
    return ref.approx_mul_ref(a, b, product_table(design, signed, a.device),
                              offset=off)


def factor_tables(design: str, rank: int, signed: bool, device):
    """get_factors as float32 tensors on ``device`` (cached per device)."""
    key = ("factors_t", design, rank, signed, str(torch.device(device)))
    if key not in _LUT_CACHE:
        F, G = get_factors(design, rank, signed)
        _LUT_CACHE[key] = (torch.from_numpy(F).to(device),
                           torch.from_numpy(G).to(device))
    return _LUT_CACHE[key]


def narrow_delta(dlut):
    """A (256,256) delta table in the 16 bits the delta_matmul and
    fused_qdot kernels keep in shared memory: (int16 tensor of the bits,
    unsigned, bias).  An int16-range table is itself (unsigned False,
    bias 0).  A wider one whose range spans at most 65,535 (the unsigned
    'initial', D in [-48744, 0]) is stored biased, T = D + bias with bias
    = -min(D), its bits read as uint16 (unsigned True); the kernels
    subtract K * bias from each output.  Raises ValueError for a table
    that fits neither."""
    arr = np.asarray(dlut.cpu() if isinstance(dlut, torch.Tensor) else dlut)
    if arr.shape != (256, 256) or arr.dtype.kind not in "iu":
        raise ValueError(f"delta table must be a (256, 256) integer table, "
                         f"got {arr.dtype} {arr.shape}")
    lo, hi = int(arr.min()), int(arr.max())
    if -0x8000 <= lo and hi <= 0x7FFF:
        return torch.from_numpy(arr.astype(np.int16)), False, 0
    if hi - lo <= 0xFFFF:
        bits = (arr.astype(np.int64) - lo).astype(np.uint16).view(np.int16)
        return torch.from_numpy(bits), True, -lo
    raise ValueError(f"delta table values span [{lo}, {hi}], more than 16 "
                     f"bits hold (the kernels keep a 16-bit table in shared "
                     f"memory)")


def widen_delta(bits: torch.Tensor, unsigned: bool = False,
                bias: int = 0) -> torch.Tensor:
    """The delta table D that narrow_delta's (bits, unsigned, bias)
    stands for, as the plain versions take it: ``bits`` itself for an
    int16 table, else int32."""
    if not unsigned and not bias:
        return bits
    return _widen(bits, unsigned) - bias


def delta_table(design: str, signed: bool, device):
    """get_delta_lut narrowed by narrow_delta, on ``device`` (cached per
    device): (int16 tensor, unsigned, bias), the delta_matmul and
    fused_qdot wrappers' ``dlut, unsigned=, bias=``."""
    key = ("delta_t", design, signed, str(torch.device(device)))
    if key not in _LUT_CACHE:
        bits, unsigned, bias = narrow_delta(get_delta_lut(design, signed))
        _LUT_CACHE[key] = (bits.to(device), unsigned, bias)
    return _LUT_CACHE[key]


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, from torch's own
    binding: torch.cuda.current_stream() builds a Stream object first,
    about 8 µs of host time a call on an H100 host against 0.1 (a decode
    step launches 160-600 kernels)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: mixed devices ({t.device} with cuda)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _check_table(name: str, dlut: torch.Tensor, unsigned: bool, bias: int,
                 signed: bool) -> None:
    # plain ifs here and in delta_matmul: a message is formatted only when
    # a check fails (calibration makes ~26k calls a run, each a 10-40 µs
    # kernel; formatting every message cost the host about 10 µs a call)
    if dlut.shape != (256, 256):
        raise ValueError(f"{name}: delta table must be (256, 256), got "
                         f"{tuple(dlut.shape)}")
    if dlut.dtype != torch.int16:
        raise ValueError(
            f"{name}: the CUDA kernel takes a delta table of 16-bit entries "
            f"(int16 bits, 128 KiB in shared memory), as ops.narrow_delta "
            f"gives it; got {dlut.dtype}")
    if (unsigned and signed) or (bias and not unsigned):
        raise ValueError(
            f"{name}: a biased table (unsigned, bias {bias}) is taken with "
            f"unsigned operands only, and a bias only with unsigned bits "
            f"(narrow_delta gives every signed design an int16 table)")
    if dlut.data_ptr() % 16:
        raise ValueError(f"{name}: the delta table must be 16-byte aligned "
                         f"(it is copied into shared memory in 16-byte "
                         f"units)")


def _raise_cuda(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def _wrong_device(name: str, t: torch.Tensor):
    return ValueError(f"{name}: no kernel for device {t.device}")


# ---------------------------------------------------------------------------
# delta_matmul
# ---------------------------------------------------------------------------

def delta_matmul(a: torch.Tensor, b: torch.Tensor, dlut: torch.Tensor,
                 offset: int = 0, *, unsigned: bool = False,
                 bias: int = 0) -> torch.Tensor:
    """S[m,n] = sum_k ( a[m,k]*b[k,n] + D[(a+off)&255, (b+off)&255] ), int32.

    a: (M, K) int32; b: (K, N) uint8 (offset 0) or int8 (offset 128) on
    the card, any integer dtype on the CPU.  (dlut, unsigned, bias): the
    (256, 256) delta table D as narrow_delta narrows it (the card takes
    only that form; the CPU also takes D itself, int16 or int32, with the
    defaults).
    """
    if a.device.type == "cpu":
        return ref.delta_matmul_ref(a, b, widen_delta(dlut, unsigned, bias),
                                    offset)
    if a.device.type != "cuda":
        raise _wrong_device("delta_matmul", a)
    name = "delta_matmul"
    if not (a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0]):
        raise ValueError(f"{name}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int32:
        raise ValueError(f"{name}: a must be int32, got {a.dtype}")
    if (b.dtype, offset) not in ((torch.uint8, 0), (torch.int8, 128)):
        raise ValueError(f"{name}: b must be uint8 with offset 0 or int8 "
                         f"with offset 128, got {b.dtype} with offset "
                         f"{offset}")
    signed = b.dtype == torch.int8
    _check_table(name, dlut, unsigned, bias, signed)
    _check_cuda(name, a, b, dlut)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    from ._build import kernel
    err = kernel(name)(a.data_ptr(), b.data_ptr(), dlut.data_ptr(),
                       out.data_ptr(), M, K, N, offset, int(signed),
                       int(bool(unsigned)), int(bias), _stream(a.device))
    _raise_cuda(name, err)
    _launched(name)
    return out


# ---------------------------------------------------------------------------
# lut_matmul
# ---------------------------------------------------------------------------

def _widen(lut: torch.Tensor, unsigned: bool) -> torch.Tensor:
    t = lut.to(torch.int32)
    return t & 0xFFFF if unsigned else t


def lut_matmul(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor,
               unsigned: bool, offset: int = 0) -> torch.Tensor:
    """S[m,n] = sum_k LUT[a[m,k]+offset, b[k,n]+offset], int32: the
    product-LUT gather sum.

    a: (M, K) int32 and b: (K, N) uint8 (offset 0) or int8 (offset 128)
    on the card, any integer dtype on the CPU; uint8-valued operands with
    offset 0, int8-valued ones with offset 128 (or pre-shifted into
    [0, 255] with offset 0).  (lut, unsigned): the (256, 256) product
    table as ``narrow_lut`` narrows it, an int16 tensor whose 16-bit
    entries read as uint16 when ``unsigned`` and as int16 otherwise.
    """
    if a.device.type == "cpu":
        return ref.approx_matmul_ref(a, b, _widen(lut, unsigned), offset)
    if a.device.type != "cuda":
        raise _wrong_device("lut_matmul", a)
    name = "lut_matmul"
    if not (a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0]):
        raise ValueError(f"{name}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int32:
        raise ValueError(f"{name}: a must be int32, got {a.dtype}")
    if (b.dtype, offset) not in ((torch.uint8, 0), (torch.int8, 128)):
        raise ValueError(f"{name}: b must be uint8 with offset 0 or int8 "
                         f"with offset 128, got {b.dtype} with offset "
                         f"{offset}")
    if tuple(lut.shape) != (256, 256) or lut.dtype != torch.int16:
        raise ValueError(f"{name}: the narrowed table must be int16 (256, "
                         f"256), got {lut.dtype} {tuple(lut.shape)}")
    if lut.data_ptr() % 16:
        raise ValueError(f"{name}: the table must be 16-byte aligned (it "
                         f"is copied into shared memory in one bulk copy)")
    _check_cuda(name, a, b, lut)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    from ._build import kernel
    err = kernel(name)(a.data_ptr(), b.data_ptr(), lut.data_ptr(),
                       out.data_ptr(), M, K, N, int(bool(unsigned)), offset,
                       _stream(a.device))
    _raise_cuda(name, err)
    _launched(name)
    return out


# ---------------------------------------------------------------------------
# residual_matmul
# ---------------------------------------------------------------------------

def residual_matmul(a: torch.Tensor, b: torch.Tensor, F: torch.Tensor,
                    G: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """S = float(A @ B) + sum_k F[a+off] G[:, b+off], float32: exact
    product plus the rank-r error correction.

    a: (M, K) int32; b: (K, N) uint8 (offset 0) or int8 (offset 128) on
    the card, any integer dtype on the CPU; F: (256, r), G: (r, 256)
    float32 with 1 <= r <= 256.  The kernel first builds the (256, 256)
    table C = F G (into a scratch allocated here), then sums
    C[a+off, b+off] over k.
    """
    if a.device.type == "cpu":
        return ref.residual_corrected_matmul_ref(a, b, F, G, offset)
    if a.device.type != "cuda":
        raise _wrong_device("residual_matmul", a)
    name = "residual_matmul"
    _check(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
           f"{name}: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    _check(a.dtype == torch.int32, f"{name}: a must be int32, got {a.dtype}")
    _check((b.dtype, offset) in ((torch.uint8, 0), (torch.int8, 128)),
           f"{name}: b must be uint8 with offset 0 or int8 with offset "
           f"128, got {b.dtype} with offset {offset}")
    r = F.shape[-1] if F.dim() == 2 else 0
    _check(F.dim() == 2 and F.shape[0] == 256 and 1 <= r <= 256
           and tuple(G.shape) == (r, 256),
           f"{name}: factors must be F (256, r) and G (r, 256) with "
           f"1 <= r <= 256, got {tuple(F.shape)} and {tuple(G.shape)}")
    _check(F.dtype == torch.float32 == G.dtype,
           f"{name}: factors must be float32")
    _check_cuda(name, a, b, F, G)
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    table = torch.empty((256, 256), dtype=torch.float32, device=a.device)
    from ._build import kernel
    err = kernel(name)(a.data_ptr(), b.data_ptr(), F.data_ptr(),
                       G.data_ptr(), table.data_ptr(), out.data_ptr(), M, K,
                       N, r, offset, int(b.dtype == torch.int8),
                       _stream(a.device))
    _raise_cuda(name, err)
    _launched(name)
    return out


# ---------------------------------------------------------------------------
# approx_matmul: every backend name of the reference
# ---------------------------------------------------------------------------

LUT_BACKENDS = ("xla", "pallas_legacy")
RESIDUAL_BACKENDS = ("residual", "residual_xla")
DELTA_BACKENDS = ("pallas", "delta", "delta_xla", "fused")


def _approx_matmul_2d(a2, b, design, backend, rank, signed):
    off = 128 if signed else 0
    cuda = a2.is_cuda
    if backend == "exact":
        return ref.exact_matmul_ref(a2, b)
    if cuda:
        a2 = a2.to(torch.int32).contiguous()
        b = b.to(torch.int8 if signed else torch.uint8).contiguous()
    if backend in LUT_BACKENDS:
        lut, unsigned = lut_table(design, signed, a2.device)
        return lut_matmul(a2, b, lut, unsigned, offset=off)
    if backend in RESIDUAL_BACKENDS:
        F, G = factor_tables(design, rank, signed, a2.device)
        return residual_matmul(a2, b, F, G, offset=off)
    if backend in DELTA_BACKENDS:
        dlut, unsigned, bias = delta_table(design, signed, a2.device)
        return delta_matmul(a2, b, dlut, offset=off, unsigned=unsigned,
                            bias=bias)
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{LUT_BACKENDS + RESIDUAL_BACKENDS + DELTA_BACKENDS}"
                     f" or 'exact'")


class ApproxMatmul(torch.autograd.Function):
    """approx_matmul with the reference's straight-through VJP
    (``_approx_matmul_bwd``): the backward pass differentiates the exact
    product, da = g @ b.T and db = a.T @ g in float32.  Integer operands
    carry no gradient; float-valued ones get this one."""

    @staticmethod
    def forward(ctx, a, b, design, backend, rank, signed):
        ctx.save_for_backward(a, b)
        lead = a.shape[:-2]
        K = a.shape[-1]
        out = _approx_matmul_2d(a.reshape(-1, K), b, design, backend, rank,
                                signed)
        return out.float().reshape(*lead, a.shape[-2], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        af, bf = a.float(), b.float()
        da = torch.matmul(g, bf.T)
        db = torch.matmul(af.reshape(-1, af.shape[-1]).T,
                          g.reshape(-1, g.shape[-1]))
        return da, db, None, None, None, None


def approx_matmul(a: torch.Tensor, b: torch.Tensor, design: str = "design2",
                  backend: str = "delta", rank: int = 32,
                  signed: bool = False) -> torch.Tensor:
    """S = A (x)_approx B over integer-valued operands, float32 out.

    a: (..., M, K), b: (K, N); uint8-valued by default, int8-valued with
    ``signed``.  Every backend name of the reference is accepted; the
    port has no XLA, so a name that says 'xla' there means the same
    function here.  On a CUDA tensor:
      'xla', 'pallas_legacy'          -> lut_matmul (product-LUT gather)
      'residual', 'residual_xla'      -> residual_matmul (exact product +
                                         rank-``rank`` correction;
                                         approximate)
      'pallas', 'delta', 'delta_xla', -> delta_matmul (exact product +
      'fused'                            delta gather; 'fused' on integer
                                         operands has no float ends)
      'exact'                         -> the exact integer product
    On a CPU tensor each backend takes its kernel's plain version.  The
    backward pass is the reference's straight-through one (ApproxMatmul).
    """
    return ApproxMatmul.apply(a, b, design, backend, rank, signed)


# ---------------------------------------------------------------------------
# fused_qdot
# ---------------------------------------------------------------------------

def _as_col(v, N: int, device) -> torch.Tensor:
    """A scalar / (1,N) / (N,) epilogue parameter as an (N,) f32 column."""
    if v is None:
        return torch.zeros((N,), dtype=torch.float32, device=device)
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return torch.broadcast_to(v.reshape(-1) if v.dim() else v, (N,))


def pack_fused_operands(N: int, device, *, sx, zx=None, sw, zw=None,
                        colsum=None, comp_r=None, comp_col=None,
                        comp_mu=None):
    """The fused kernel's operand tables, packed as the reference's
    ops.fused_qdot packs them: scal (8,) f32 [sx, zx, comp_mu, 0...], ntab
    (4, N) f32 rows [sw, zw, colsum, comp_col] and the row compensation
    table (256,) f32.  sx/zx: static activation scale / zero point (zx
    None for sym_i8); sw/zw: weight scale / zero point, scalar or per
    column; colsum: colsum(qw) for the asym_u8 cross term; comp_*: the
    mean-field compensation tables (quant.linear memoizes the result per
    layer)."""
    f32 = dict(dtype=torch.float32, device=device)
    zero = torch.zeros((), **f32)

    def scalar(v):
        return zero if v is None else torch.as_tensor(v, **f32).reshape(())

    scal = torch.stack([scalar(sx), scalar(zx), scalar(comp_mu)]
                       + [zero] * 5)
    ntab = torch.stack([_as_col(sw, N, device), _as_col(zw, N, device),
                        _as_col(colsum, N, device),
                        _as_col(comp_col, N, device)]).contiguous()
    cr = (torch.as_tensor(comp_r, **f32).reshape(-1).contiguous()
          if comp_r is not None else torch.zeros((256,), **f32))
    return scal, ntab, cr


def _up16(v: int) -> int:
    return (v + 15) // 16 * 16


# the most rows fused_qdot's split-K schedule takes (kSplitMaxRows in
# csrc/fused_qdot.cu): 4 rows a thread at M <= 4, 8 at 5 <= M <= 8;
# more rows take the 32 x 128 tile schedule
FUSED_SPLIT_MAX_ROWS = 8


def fused_scratch_layout(M: int, K: int, N: int) -> dict:
    """Byte offsets of the fused kernel's device scratch (the layout of
    ``Layout`` in csrc/fused_qdot.cu, which refuses a smaller scratch):
    the quantized activations as bytes, M rows of ``kp`` (K padded to a
    multiple of 16), then rowsum(qx) int32 (M) at ``rs`` and
    rowsum(mu_r[qx]) float32 (M) at ``rc``; at M <= FUSED_SPLIT_MAX_ROWS
    (the split-K schedule) also the int32 accumulator (M, N) at ``acc``
    and one arrival count per 128-column tile at ``cnt``.  ``bytes`` is
    the total."""
    kp = _up16(K) if K > 16 else 16
    rs = _up16(M * kp)
    rc = _up16(rs + 4 * M)
    acc = _up16(rc + 4 * M)
    cnt = _up16(acc + 4 * M * N)
    splitk = M <= FUSED_SPLIT_MAX_ROWS
    total = cnt + 4 * ((N + 127) // 128) if splitk else acc
    return {"kp": kp, "rs": rs, "rc": rc, "acc": acc, "cnt": cnt,
            "splitk": splitk, "bytes": total}


def fused_qdot_packed(x: torch.Tensor, qw: torch.Tensor, dlut: torch.Tensor,
                      scal: torch.Tensor, ntab: torch.Tensor,
                      comp_r: torch.Tensor, *, signed: bool = False,
                      compensate: bool = False, return_int: bool = False,
                      unsigned: bool = False, bias: int = 0):
    """The fused kernel on packed operands: float x (M, K) @ prequantized
    qw (K, N) -> float32 (M, N).  (dlut, unsigned, bias): the delta table
    as narrow_delta narrows it (see delta_matmul).  ``return_int`` also
    returns the quantized activations (M, K) and the int32 accumulator
    (M, N).  On the card one call is two launches, the quantize pre-pass
    and the gather (split-K at M <= 8), into a scratch allocated here
    (fused_scratch_layout); it counts as one launch of the kernel and
    one of the schedule the launcher reports in SCHEDULES."""
    offset = 128 if signed else 0
    if x.device.type == "cpu":
        return ref.fused_qdot_ref(x, qw, widen_delta(dlut, unsigned, bias),
                                  scal, ntab, comp_r,
                                  offset=offset, asym=not signed,
                                  compensate=compensate,
                                  return_int=return_int)
    if x.device.type != "cuda":
        raise _wrong_device("fused_qdot", x)
    name = "fused_qdot"
    # plain ifs: a message is formatted only when a check fails (decode
    # makes 112 calls a step, each a 20-70 µs kernel)
    if not (x.dim() == 2 and qw.dim() == 2 and x.shape[1] == qw.shape[0]):
        raise ValueError(f"{name}: shapes {tuple(x.shape)} @ "
                         f"{tuple(qw.shape)}")
    M, K = x.shape
    N = qw.shape[1]
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32")
    want = torch.int8 if signed else torch.uint8
    if qw.dtype != want:
        raise ValueError(f"{name}: qw must be {want} for "
                         f"{'sym_i8' if signed else 'asym_u8'}, got "
                         f"{qw.dtype}")
    _check_table(name, dlut, unsigned, bias, signed)
    if not (scal.dtype == torch.float32 and scal.numel() >= 3):
        raise ValueError(f"{name}: scal must be float32 with >= 3 entries")
    if not (ntab.dtype == torch.float32 and tuple(ntab.shape) == (4, N)):
        raise ValueError(f"{name}: ntab must be float32 (4, {N})")
    if not (comp_r.dtype == torch.float32 and comp_r.numel() == 256):
        raise ValueError(f"{name}: comp_r must be float32 (256,)")
    _check_cuda(name, x, qw, dlut, scal, ntab, comp_r)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    qx = acc = None
    if return_int:
        qx = torch.empty((M, K), dtype=torch.int32, device=x.device)
        acc = torch.empty((M, N), dtype=torch.int32, device=x.device)
    nbytes = fused_scratch_layout(M, K, N)["bytes"]
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    rows = ctypes.c_int(-1)
    from ._build import kernel
    err = kernel(name)(x.data_ptr(), qw.data_ptr(), dlut.data_ptr(),
                       scal.data_ptr(), ntab.data_ptr(), comp_r.data_ptr(),
                       out.data_ptr(), qx.data_ptr() if return_int else None,
                       acc.data_ptr() if return_int else None,
                       scratch.data_ptr(), nbytes, M, K, N,
                       int(not signed), int(compensate), int(bool(unsigned)),
                       int(bias), ctypes.addressof(rows), _stream(x.device))
    _raise_cuda(name, err)
    _launched(name)
    if rows.value in _FUSED_SCHEDULES:
        SCHEDULES[_FUSED_SCHEDULES[rows.value]] += 1
    return (out, qx, acc) if return_int else out


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

ATTN_SMS = 132            # SMs of an H100 SXM (the wrapper reads the card's)
ATTN_BLOCKS_PER_SM = 3    # blocks a split aims at, per SM
ATTN_MIN_ROWS = 16        # fewest positions a chunk gets to fill the SMs
ATTN_MAX_CHUNKS = 16      # chunks of one (kv head, slot): one cluster
ATTN_STAGE_BYTES = 32768  # a tile's K and V rows, staged in shared memory

# per-device values of the attention wrapper: SM counts, rope frequencies
_ATTN_CACHE: dict = {}


def attention_tile_rows(rows: int, hd: int) -> int:
    """Cache positions of one tile of the decode_attention kernel, whose
    chunks of ``rows`` positions are read tile by tile at head_dim
    ``hd``: the tile's bf16 K and V rows in ATTN_STAGE_BYTES of shared
    memory, at most 256 and at most ``rows``.  The launcher takes it as
    it is and refuses a tile whose shared memory does not fit."""
    return min(rows, 256, ATTN_STAGE_BYTES // (4 * hd))


def attention_chunks(S_max: int, B: int, Kv: int, sms: int = ATTN_SMS):
    """(chunks, rows): the decode_attention kernel's split of the S_max
    cache positions into ``chunks`` chunks of ``rows`` consecutive
    positions, one block per (chunk, kv head, slot) and one cluster of
    ``chunks`` blocks per (kv head, slot).  As many chunks as keep the
    B*Kv pairs' blocks within ATTN_BLOCKS_PER_SM per SM (so that they run
    in one wave where the instantiation fits that many: groups of 1-8),
    but none under ATTN_MIN_ROWS positions and at most ATTN_MAX_CHUNKS;
    the last chunk is never empty.  So the blocks number at most
    max(B*Kv, ATTN_BLOCKS_PER_SM*sms).  The G = 16 instantiation (groups
    of 9-16) fits 2 blocks an SM, so at many pairs its blocks take two
    waves; a split planned at 2 an SM, one wave, measured slower at
    nemotron-4-340b's 96/8 over 4,096 positions (0.559 ms against 0.486
    on an H100 80GB HBM3 at 700 W: scripts/time_ab.py)."""
    pairs = B * Kv
    n = max(1, min(ATTN_MAX_CHUNKS, S_max // ATTN_MIN_ROWS,
                   ATTN_BLOCKS_PER_SM * sms // pairs))
    rows = -(-S_max // n)
    return -(-S_max // rows), rows


def _sm_count(device) -> int:
    """The card's multiprocessor count (cached per device)."""
    key = ("sms", str(device))
    if key not in _ATTN_CACHE:
        _ATTN_CACHE[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _ATTN_CACHE[key]


def _rope_table(theta: float, hd: int, device) -> torch.Tensor:
    """ref.rope_freqs on ``device`` (cached): the kernel reads rope's
    frequencies as the plain version computes them there."""
    key = ("rope", float(theta), hd, str(device))
    if key not in _ATTN_CACHE:
        _ATTN_CACHE[key] = ref.rope_freqs(theta, hd // 2, device)
    return _ATTN_CACHE[key]


ATTN_MAX_GROUP = 16        # query heads a kv head, the kernel's largest G


def _check_attention_shapes(q, k_new, v_new, q_gain, k_gain, k_cache,
                            v_cache, pos):
    """The decode_attention kernel's operand checks (shapes, dtypes,
    head_dim, the query group H/Kv <= ATTN_MAX_GROUP), any device.
    Returns the gains to pass, () without qk-norm."""
    name = "decode_attention"
    # plain ifs: a message is formatted only when a check fails (28 calls
    # a decode step and a calibration token, each a few-µs kernel)
    B, H, hd = q.shape
    Kv = k_new.shape[1]
    S = k_cache.shape[1]
    if not (tuple(k_new.shape) == (B, Kv, hd) == tuple(v_new.shape)):
        raise ValueError(f"{name}: k/v rows must be ({B}, {Kv}, {hd})")
    if not (tuple(k_cache.shape) == (B, S, Kv, hd) == tuple(v_cache.shape)):
        raise ValueError(f"{name}: caches must be ({B}, S_max, {Kv}, {hd})")
    if not (hd % 2 == 0 and 0 < hd <= 256):
        raise ValueError(f"{name}: head_dim {hd} must be even and <= 256")
    if not (Kv > 0 and H % Kv == 0 and H // Kv <= ATTN_MAX_GROUP):
        raise ValueError(f"{name}: query group H/Kv = {H}/{Kv} must be a "
                         f"whole number <= {ATTN_MAX_GROUP}")
    for t in (q, k_new, v_new):
        if not (t.dtype == torch.float32 and t.stride(2) == 1
                and t.stride(1) == hd):
            raise ValueError(f"{name}: q/k/v must be float32 with packed "
                             f"heads")
    if not (k_cache.dtype == torch.bfloat16 == v_cache.dtype):
        raise ValueError(f"{name}: the caches must be bfloat16")
    if not (pos.dtype == torch.int32 and pos.numel() in (1, B)):
        raise ValueError(f"{name}: pos must be int32, scalar or ({B},)")
    gains = (q_gain, k_gain) if q_gain is not None else ()
    for g in gains:
        if not (g.dtype == torch.float32 and g.numel() == hd):
            raise ValueError(f"{name}: gains must be float32 ({hd},)")
    return gains


def _attention_launch(q, k_new, v_new, q_gain, k_gain, k_cache, v_cache,
                      pos, theta, window, row_out):
    """Check the operands and launch the decode_attention kernel; returns
    out (B, H, hd) f32.  ``row_out`` None: the new k/v rows go into the
    caches at pos (the append); else a pair of (B, Kv, hd) bf16 row
    outputs, and the caches are only read."""
    name = "decode_attention"
    gains = _check_attention_shapes(q, k_new, v_new, q_gain, k_gain,
                                    k_cache, v_cache, pos)
    qk_norm = bool(gains)
    B, H, hd = q.shape
    Kv = k_new.shape[1]
    S = k_cache.shape[1]
    _check_cuda(name, k_cache, v_cache, pos, *gains)
    dev = k_cache.device
    for t in (q, k_new, v_new):
        if t.device != dev:
            raise ValueError(f"{name}: mixed devices")
    chunks, n_rows = attention_chunks(S, B, Kv, _sm_count(dev))
    freqs = _rope_table(theta, hd, dev) if theta else None
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    from ._build import kernel
    err = kernel(name)(
        q.data_ptr(), q.stride(0), k_new.data_ptr(), k_new.stride(0),
        v_new.data_ptr(), v_new.stride(0),
        q_gain.data_ptr() if qk_norm else None,
        k_gain.data_ptr() if qk_norm else None,
        None if freqs is None else freqs.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        0 if pos.numel() == 1 else 1, out.data_ptr(),
        None if row_out is None else row_out[0].data_ptr(),
        None if row_out is None else row_out[1].data_ptr(),
        B, H, Kv, S, hd, chunks, n_rows, attention_tile_rows(n_rows, hd),
        int(window or 0), int(qk_norm),
        int(row_out is None), _stream(dev))
    _raise_cuda(name, err)
    _launched(name)
    return out


def decode_attention_step(q, k_new, v_new, q_gain, k_gain, k_cache, v_cache,
                          pos, *, theta: float = 10000.0, window=None):
    """One fused decode-attention step over a batch of cache slots,
    leaving the caches untouched.

    q: (B, H, hd) f32 pre-norm pre-rope; k_new/v_new: (B, Kv, hd) f32
    (batch rows may be strided, as slices of a merged qkv projection);
    q_gain/k_gain: (hd,) qk-norm gains, or None for no qk-norm;
    k_cache/v_cache: (B, S_max, Kv, hd) before the append; pos: scalar
    or (B,) int32 cache positions, each < S_max.  Returns (out (B, H, hd)
    f32, k_row, v_row (B, Kv, hd) in the cache dtype).
    """
    if q.device.type == "cpu":
        return ref.decode_attention_step_ref(
            q, k_new, v_new, q_gain, k_gain, k_cache, v_cache, pos,
            theta=theta, window=window)
    if q.device.type != "cuda":
        raise _wrong_device("decode_attention", q)
    B, _, hd = q.shape
    Kv = k_new.shape[1]
    krow = torch.empty((B, Kv, hd), dtype=k_cache.dtype, device=q.device)
    vrow = torch.empty((B, Kv, hd), dtype=v_cache.dtype, device=q.device)
    out = _attention_launch(q, k_new, v_new, q_gain, k_gain, k_cache,
                            v_cache, pos, theta, window, (krow, vrow))
    return out, krow, vrow


def decode_attention(q, k, v, k_cache, v_cache, idx, *, n_heads: int,
                     n_kv: int, head_dim: int, rope_theta: float = 10000.0,
                     window=None, q_gain=None, k_gain=None):
    """The decode-step attention/cache op: qk-norm + rope at the slot's
    cache position + masked single-query GQA attention, and the append
    of the new k/v rows to the caches, IN PLACE.  On the card one kernel
    launch does all of it; on the CPU the plain step, then
    ``ref.write_rows``.

    q: (B, 1, n_heads, hd) pre-norm pre-rope; k/v: (B, 1, n_kv, hd);
    idx: scalar int32 (uniform decode) or (B,) per-slot positions, each
    < S_max.  Returns (out (B, 1, n_heads*hd) f32, k_cache, v_cache).
    """
    B = q.shape[0]
    args = (q.reshape(B, n_heads, head_dim), k.reshape(B, n_kv, head_dim),
            v.reshape(B, n_kv, head_dim), q_gain, k_gain, k_cache, v_cache,
            idx)
    if q.device.type == "cuda":
        out = _attention_launch(*args, rope_theta, window, None)
    else:
        out, krow, vrow = decode_attention_step(*args, theta=rope_theta,
                                                window=window)
        ref.write_rows(k_cache, krow[:, None], idx)
        ref.write_rows(v_cache, vrow[:, None], idx)
    return out.reshape(B, 1, n_heads * head_dim), k_cache, v_cache
