"""Plain PyTorch versions of the five kernels.

Each function here computes what one CUDA kernel of ``csrc/`` computes,
op for op after the JAX package's XLA twins, on any device.  The kernel
wrappers in ``ops`` take them for tensors on the CPU; on the card
``chip_smoke.py`` holds each kernel against its plain version.  Nothing
on the main path calls them for a CUDA tensor.

Operands are uint8-valued ([0, 255], offset=0, the paper's unsigned
semantics) or int8-valued ([-128, 127], offset=128): ``offset`` shifts
the table index so signed tables resolve directly.
"""
from __future__ import annotations

import math

import torch

from ..device import true_div


def _pick_k_block(K: int, k_block: int) -> int:
    """Largest candidate K-block (<= k_block, from the fixed ladder)
    that divides K."""
    for kb in (k_block, 64, 32, 16, 8, 4, 2, 1):
        if kb <= k_block and K % kb == 0:
            return kb
    return 1


def exact_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul (int32 out).  CUDA has no integer matmul;
    float64 is exact there, since |sum| <= K * 255**2 is far below 2**53."""
    if a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.long(), b.long()).to(torch.int32)


def _table(dlut, device) -> torch.Tensor:
    return torch.as_tensor(dlut).to(device=device,
                                    dtype=torch.int32).reshape(-1)


def _delta_blocks(out, ab, bb, flat):
    """out += sum_k flat[ab[m,k] + bb[k,n]] over K-blocks: ab (nb, M, kb)
    and bb (nb, kb, N) hold the folded row/column halves of the index."""
    for i in range(ab.shape[0]):
        idx = ab[i][:, :, None] + bb[i][None, :, :]          # (M, kb, N)
        out = out + flat[idx.long()].sum(1, dtype=torch.int32)
    return out


def delta_matmul_ref(a: torch.Tensor, b: torch.Tensor, dlut,
                     offset: int = 0, k_block: int = 32) -> torch.Tensor:
    """S[m,n] = sum_k ( a[m,k]*b[k,n] + D[(a[m,k]+off)&255, (b[k,n]+off)&255] ).

    Exact dot plus a K-blocked delta gather (int32 out), the plain
    version of ``csrc/delta_matmul.cu``.  a: (M, K), b: (K, N) integer
    tensors; dlut: (256, 256) delta table.
    """
    M, K = a.shape
    N = b.shape[1]
    exact = exact_matmul_ref(a, b)
    flat = _table(dlut, a.device)
    kb = _pick_k_block(K, k_block)
    ab = ((a.to(torch.int32) + offset) & 0xFF).reshape(M, K // kb, kb)
    ab = ab.permute(1, 0, 2) * 256                          # (nb, M, kb)
    bb = ((b.to(torch.int32) + offset) & 0xFF).reshape(K // kb, kb, N)
    return _delta_blocks(exact, ab, bb, flat)


def _gather_blocks(a_idx, b_idx, flat, budget: int = 1 << 24):
    """sum_k flat[a_idx[m,k] + b_idx[k,n]] (int32; float32 for a float
    table), K sliced so that no gathered block holds more than ``budget``
    entries (never the whole (M,K,N) index surface).  Integer sums: the
    slicing is exact."""
    M, K = a_idx.shape
    N = b_idx.shape[1]
    dt = torch.float32 if flat.is_floating_point() else torch.int32
    out = torch.zeros((M, N), dtype=dt, device=a_idx.device)
    kb = max(1, min(K, budget // max(M * N, 1)))
    for k0 in range(0, K, kb):
        idx = a_idx[:, k0:k0 + kb, None] + b_idx[None, k0:k0 + kb, :]
        out += flat[idx].sum(1, dtype=dt)
    return out


def approx_matmul_ref(a: torch.Tensor, b: torch.Tensor, lut,
                      offset: int = 0) -> torch.Tensor:
    """S[m,n] = sum_k LUT[a[m,k]+offset, b[k,n]+offset]  (int32): the
    product-LUT gather sum.  a: (M,K), b: (K,N) integer tensors,
    uint8-valued with offset 0, int8-valued with offset 128 and a signed
    LUT; lut: (256,256) integer table."""
    flat = _table(lut, a.device)
    a_idx = (a.long() + offset) * 256
    b_idx = b.long() + offset
    return _gather_blocks(a_idx, b_idx, flat)


def lut_matmul_ref(a: torch.Tensor, b: torch.Tensor, lut) -> torch.Tensor:
    """S[m,n] = sum_k LUT[a[m,k], b[k,n]] (int32): offset-free (signed
    operands arrive pre-shifted by +128), as the Pallas function.  The
    plain version of ``csrc/lut_matmul.cu``, which also takes the offset,
    is approx_matmul_ref; at offset 0 it is this function."""
    return approx_matmul_ref(a, b, lut, 0)


def residual_corrected_matmul_ref(a: torch.Tensor, b: torch.Tensor, F, G,
                                  offset: int = 0,
                                  budget: int = 1 << 24) -> torch.Tensor:
    """Exact matmul + rank-r error model (float32 out), the plain version
    of ``csrc/residual_matmul.cu``:

        S = float(A @ B) + sum_k sum_r F[a[m,k]+off, r] * G[r, b[k,n]+off]

    F: (256, r), G: (r, 256) float32 (core.lut.error_factors, or
    signed_error_factors with offset 128 for int8 operands).  The
    correction is summed over K slices whose gathered factors hold at
    most ``budget`` entries."""
    exact = exact_matmul_ref(a, b).float()
    F = torch.as_tensor(F).to(device=a.device, dtype=torch.float32)
    G = torch.as_tensor(G).to(device=a.device, dtype=torch.float32)
    M, K = a.shape
    N = b.shape[1]
    r = F.shape[1]
    corr = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    kb = max(1, min(K, budget // max(r * (M + N), 1)))
    for k0 in range(0, K, kb):
        Fa = F[a[:, k0:k0 + kb].long() + offset]            # (M, kb, r)
        Gb = G[:, b[k0:k0 + kb].long() + offset]            # (r, kb, N)
        corr = corr + torch.einsum("mkr,rkn->mn", Fa, Gb)
    return exact + corr


def residual_table_ref(F, G) -> torch.Tensor:
    """The correction table C = F G (256, 256) that ``csrc/
    residual_matmul.cu`` builds before its gather sum: a float64 product
    of the float32 factors (each term exact), rounded once to float32."""
    F = torch.as_tensor(F).to(torch.float64)
    G = torch.as_tensor(G).to(device=F.device, dtype=torch.float64)
    return torch.matmul(F, G).to(torch.float32)


def residual_table_sum_ref(a: torch.Tensor, b: torch.Tensor, C,
                           offset: int = 0) -> torch.Tensor:
    """float(A @ B) + sum_k C[a[m,k]+off, b[k,n]+off] (float32): the
    residual product in the CUDA kernel's form, a float32 gather sum over
    one correction table C (residual_table_ref).  The tests hold it
    against the reference's factored form; the kernel's plain version
    stays residual_corrected_matmul_ref."""
    flat = torch.as_tensor(C).to(device=a.device,
                                 dtype=torch.float32).reshape(-1)
    corr = _gather_blocks(((a.long() + offset) & 0xFF) * 256,
                          (b.long() + offset) & 0xFF, flat)
    return exact_matmul_ref(a, b).float() + corr


def quantize_static(x: torch.Tensor, sx, zx, asym: bool) -> torch.Tensor:
    """clip(round(x / sx) + zx) onto the mode's grid, int32 (round half
    to even, as ``jnp.round``)."""
    lo, hi = (0.0, 255.0) if asym else (-128.0, 127.0)
    return torch.clamp(torch.round(x.float() / sx) + zx,
                       lo, hi).to(torch.int32)


def fused_qdot_ref(x, qw, dlut, scal, ntab, comp_r, offset: int = 0,
                   asym: bool = True, compensate: bool = False,
                   k_block: int = 32, return_int: bool = False):
    """Quantize -> (exact dot + delta gather) -> dequant, the plain
    version of ``csrc/fused_qdot.cu``.

    x: (M, K) float; qw: (K, N) prequantized weights; dlut: (256, 256)
    delta table; scal: (>=3,) f32 [sx, zx, comp_mu, ...]; ntab: (4, N)
    f32 rows [sw, zw, colsum, comp_col]; comp_r: (256,) f32.  Every
    float epilogue op keeps the reference's order.  ``return_int`` also
    returns the quantized activations and the int32 accumulator.
    """
    sx, zx = scal[0], scal[1]
    qx = quantize_static(x, sx, zx, asym)
    M, K = qx.shape
    N = qw.shape[1]
    exact = exact_matmul_ref(qx, qw)
    flat = _table(dlut, x.device)
    kb = _pick_k_block(K, k_block)
    # folded offsets: D[a+off, b+off] flattens to a*256 + b + off*257
    ab = (qx * 256 + offset * 257).reshape(M, K // kb, kb).permute(1, 0, 2)
    bb = qw.to(torch.int32).reshape(K // kb, kb, N)
    prod = _delta_blocks(exact, ab, bb, flat)
    accf = prod.float()
    sw = ntab[0][None, :]
    if compensate:
        rowc = comp_r[(qx + offset).long()].sum(-1, keepdim=True)
        accf = accf - (rowc + ntab[3][None, :] - K * scal[2])
    if asym:
        zw = ntab[1][None, :]
        colsum = ntab[2][None, :]
        rowsum = qx.sum(-1, keepdim=True).float()
        accf = accf - zw * rowsum - zx * colsum + K * zx * zw
    out = accf * (sx * sw)
    return (out, qx, prod) if return_int else out


def _rmsnorm(x, gamma, eps: float = 1e-6):
    """Mirror of models.layers.rmsnorm (kept local: models imports
    kernels)."""
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * gamma


def _rope(x, positions, theta: float):
    """Mirror of models.layers.rope. x: (B, S, H, D)."""
    half = x.shape[-1] // 2
    freqs = theta ** true_div(-torch.arange(0, half, dtype=torch.float32,
                                            device=x.device), half)
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None, :]
    ang = pos[:, :, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def write_rows(cache: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor):
    """In place: cache[b, idx(+s)] = rows[b, s] for rows (B, S, Kv, hd);
    idx scalar (every slot at one depth) or (B,) per-slot depths."""
    S = rows.shape[1]
    ar = torch.arange(S, device=cache.device)
    if idx.ndim == 1:
        b = torch.arange(cache.shape[0], device=cache.device)
        cache[b[:, None], (idx.long()[:, None] + ar)] = rows
    else:
        cache.index_copy_(1, idx.long() + ar, rows)


def decode_attention_ref(q, k, v, k_cache, v_cache, idx, *, n_heads: int,
                         n_kv: int, head_dim: int,
                         rope_theta: float = 10000.0, window=None,
                         q_gain=None, k_gain=None):
    """Decode-step attention: (optional) qk rmsnorm, rope at the slot's
    cache position, the cache append, and masked single-query GQA
    attention over the cache, op for op after the generic attention
    path (the -1e30 mask and f32 softmax, new k/v read back through the
    cache dtype).

    q: (B, S, n_heads, hd); k, v: (B, S, n_kv, hd); caches
    (B, S_max, n_kv, hd), left untouched (the appended copies are
    returned); idx: scalar int32 or (B,) per-slot positions.
    Returns (out (B, S, n_heads*hd) f32, k_cache', v_cache').
    """
    B, S = q.shape[:2]
    per_slot = idx.ndim == 1
    ar = torch.arange(S, dtype=torch.int32, device=q.device)
    positions = (idx[:, None] + ar) if per_slot else (idx + ar)
    if q_gain is not None:
        q = _rmsnorm(q, q_gain)
        k = _rmsnorm(k, k_gain)
    if rope_theta:
        q = _rope(q, positions, rope_theta)
        k = _rope(k, positions, rope_theta)
    ck, cv = k_cache.clone(), v_cache.clone()
    write_rows(ck, k.to(ck.dtype), idx)
    write_rows(cv, v.to(cv.dtype), idx)
    out = masked_attention(q, ck, cv, idx, positions, n_heads=n_heads,
                           n_kv=n_kv, head_dim=head_dim, window=window)
    return out, ck, cv


def masked_attention(q, ck, cv, idx, positions, *, n_heads: int, n_kv: int,
                     head_dim: int, window=None):
    """Masked GQA attention of normed, roped queries q (B, S, n_heads,
    hd) at ``positions`` over caches that already hold the new rows
    (the tail of decode_attention_ref).  Returns (B, S, n_heads*hd)."""
    B, S = q.shape[:2]
    per_slot = idx.ndim == 1
    S_k = ck.shape[1]
    group = n_heads // max(n_kv, 1)
    qg = q.reshape(B, S, n_kv, group, head_dim)
    lg = true_div(torch.einsum("bsngd,btnd->bngst", qg, ck.float()),
                  math.sqrt(head_dim))
    kpos = torch.arange(S_k, device=q.device)
    kv_limit = idx + S
    if per_slot:
        m = (kpos[None, None, :] <= positions[:, :, None]) \
            & (kpos[None, None, :] < kv_limit[:, None, None])
        if window is not None:
            m = m & (kpos[None, None, :] > positions[:, :, None] - window)
        mb = m[:, None, None]                       # (B, 1, 1, S, S_k)
    else:
        m = (kpos[None, :] <= positions[:, None]) & (kpos[None, :] < kv_limit)
        if window is not None:
            m = m & (kpos[None, :] > positions[:, None] - window)
        mb = m[None, None, None]
    lg = torch.where(mb, lg, torch.full_like(lg, -1e30))
    pr = torch.softmax(lg.float(), dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", pr, cv.float())
    return out.reshape(B, S, n_heads * head_dim)


def decode_attention_step_ref(q, k_new, v_new, q_gain, k_gain, k_cache,
                              v_cache, pos, *, theta: float,
                              window=None):
    """What ``csrc/decode_attention.cu`` computes: q (B, H, hd) and
    k_new/v_new (B, Kv, hd) pre-norm pre-rope, gains (hd,) or None,
    caches (B, S_max, Kv, hd) before the append, pos scalar or (B,).
    Returns (out (B, H, hd) f32, k_row, v_row (B, Kv, hd) in the cache
    dtype); the caller appends the rows."""
    B, H, hd = q.shape
    Kv = k_new.shape[1]
    pos = pos.reshape(-1).expand(B)
    out, ck, cv = decode_attention_ref(
        q[:, None], k_new[:, None], v_new[:, None], k_cache, v_cache, pos,
        n_heads=H, n_kv=Kv, head_dim=hd, rope_theta=theta, window=window,
        q_gain=q_gain, k_gain=k_gain)
    b = torch.arange(B, device=q.device)
    p = pos.long()
    return out.reshape(B, H, hd), ck[b, p], cv[b, p]
