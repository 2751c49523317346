"""Shared neural layers (functions of tensors, params = nested dicts).

Every dense projection routes through quant.qdot, i.e. through the
paper's approximate multiplier when the run's QuantConfig enables it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import trace
from ..device import true_div
from ..kernels import ops
from ..kernels.ref import write_rows
from ..quant import QuantConfig, qdot
from .sharding import constrain


def rmsnorm(x, gamma, eps: float = 1e-6):
    """On the CPU, the reference's float32 composite.  On the card, torch's
    fused rms_norm: one launch that reduces each row within one block, so
    a row of a batch gets the value it gets alone.  torch's float32 CUDA
    reduction splits a row over a number of threads that depends on how
    many rows there are, so the composite gives a row of a batch of 4
    another value than the same row alone now and then (chip_smoke.py
    counts them), which flips static quantization steps and breaks
    continuous batching's promise that a request is served as it would
    be alone.  Both forms are within a few float32 ulps of the exact
    value (tests/test_torch_serve_options.py holds the fused one to the
    reference)."""
    if x.is_cuda:
        return rmsnorm_fused(x, gamma, eps)
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * gamma


def rmsnorm_fused(x, gamma, eps: float = 1e-6):
    """rmsnorm's form on the card (any device): torch's fused rms_norm."""
    return F.rms_norm(x, (x.shape[-1],), gamma, eps)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x: (B, S, H, D); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** true_div(-torch.arange(0, half, dtype=torch.float32,
                                            device=x.device), half)
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None, :]                       # (1, S)
    ang = pos[:, :, None, None] * freqs          # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _split_heads(x, n, d):
    return x.reshape(*x.shape[:-1], n, d)


def attention(p, x, positions, qcfg: QuantConfig, *, n_heads: int,
              n_kv: int, head_dim: int, causal: bool = True,
              window: Optional[int] = None, qk_norm: bool = False,
              cache: Optional[dict] = None,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              rope_theta: float = 10000.0):
    """x: (B, S, D). Returns (out, new_cache).

    cache: {"k": (B, S_max, n_kv, hd), "v": ..., "idx": int32 scalar, or
    (B,) per-slot positions} for decode.  The new k/v rows are written
    into the cache tensors IN PLACE (the JAX package returns new arrays);
    new_cache holds the same tensors and idx + S.  Every position written
    must lie below S_max (the caller keeps it so: launch.serve raises
    before a slot would pass the cache).

    cross_kv: precomputed (k, v), (B, S_enc, n_kv, hd) each, for
    encoder-decoder cross attention: q from wq alone, k and v as given
    (no k-norm, no rope), no cache, the mask all ones; never the decode
    kernel, also at S = 1.
    """
    B, S, _ = x.shape
    idx = cache["idx"] if cache is not None else None
    per_slot = idx is not None and idx.ndim == 1
    if positions is None and cache is not None:
        ar = torch.arange(S, dtype=torch.int32, device=x.device)
        positions = (idx[:, None] + ar) if per_slot else (idx + ar)
    if cross_kv is None and "wqkv" in p:
        # serving-time merged projection (quant.fuse_projections): one
        # qdot, split by head counts
        qkv = qdot(x, p["wqkv"], qcfg)
        q, k, v = torch.split(
            qkv, [n_heads * head_dim, n_kv * head_dim, n_kv * head_dim], -1)
        q = _split_heads(q, n_heads, head_dim)
        k = _split_heads(k, n_kv, head_dim)
        v = _split_heads(v, n_kv, head_dim)
    else:
        q = _split_heads(qdot(x, p["wq"], qcfg), n_heads, head_dim)
        if cross_kv is None:
            k = _split_heads(qdot(x, p["wk"], qcfg), n_kv, head_dim)
            v = _split_heads(qdot(x, p["wv"], qcfg), n_kv, head_dim)
        else:
            k, v = cross_kv

    with trace.span("model.attn_core"):
        out, new_cache = _attention_core(
            p, q, k, v, positions, cache, cross_kv, n_heads=n_heads,
            n_kv=n_kv, head_dim=head_dim, causal=causal, window=window,
            qk_norm=qk_norm, rope_theta=rope_theta)
    return qdot(out, p["wo"], qcfg), new_cache


def _attention_core(p, q, k, v, positions, cache, cross_kv, *, n_heads,
                    n_kv, head_dim, causal, window, qk_norm, rope_theta):
    """attention() between the q/k/v projections and wo: qk-norm, rope,
    the cache write and the attention itself.  Returns (out (B, S, n_heads
    * head_dim), new_cache)."""
    B, S = q.shape[:2]
    idx = cache["idx"] if cache is not None else None
    if cache is not None and S == 1 and cross_kv is None:
        # fused decode step: qk-norm + rope + masked single-query
        # attention in one kernel, then the cache append
        out, ck, cv = ops.decode_attention(
            q, k, v, cache["k"], cache["v"], idx, n_heads=n_heads,
            n_kv=n_kv, head_dim=head_dim,
            rope_theta=rope_theta if rope_theta else 0.0, window=window,
            q_gain=p.get("q_norm") if qk_norm else None,
            k_gain=p.get("k_norm") if qk_norm else None)
        return out, {"k": ck, "v": cv, "idx": idx + S}

    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        if cross_kv is None:
            k = rmsnorm(k, p["k_norm"])
    if cross_kv is None and rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if cache is None:  # training/prefill; decode layouts follow the cache
        q = constrain(q, "batch", None, "heads", None)
        k = constrain(k, "batch", None, "kv", None)

    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        write_rows(ck, k.to(ck.dtype), idx)
        write_rows(cv, v.to(cv.dtype), idx)
        new_cache = {"k": ck, "v": cv, "idx": idx + S}
        k, v = ck, cv
    k, v = k.float(), v.float()

    S_k = k.shape[1]
    group = n_heads // max(n_kv, 1)
    qg = q.reshape(B, S, n_kv, group, head_dim)
    if cache is not None:
        qpos = positions                  # (S,), or per-slot (B, S)
        kv_limit = idx + S
    elif positions is None:
        qpos = torch.arange(S, device=q.device)
        kv_limit = None
    else:
        qpos = positions if positions.ndim == 1 else positions[0]
        kv_limit = None
    kpos = torch.arange(S_k, device=q.device)

    def attend(q_blk, qpos_blk):
        """q_blk: (B, sq, n_kv, group, hd) -> (B, sq, n_kv, group, hd);
        logits only ever materialize for one query block."""
        lg = true_div(torch.einsum("bsngd,btnd->bngst", q_blk, k),
                      math.sqrt(head_dim))
        if qpos_blk.ndim == 2:
            # per-slot cache positions: the mask varies over the batch
            m = (kpos[None, None, :] <= qpos_blk[:, :, None]) & \
                (kpos[None, None, :] < kv_limit[:, None, None])
            if window is not None:
                m = m & (kpos[None, None, :] > qpos_blk[:, :, None] - window)
            mb = m[:, None, None]                 # (B, 1, 1, sq, S_k)
        else:
            if kv_limit is not None:
                m = (kpos[None, :] <= qpos_blk[:, None]) & \
                    (kpos[None, :] < kv_limit)
            elif causal:
                m = kpos[None, :] <= qpos_blk[:, None]
            else:
                m = torch.ones((q_blk.shape[1], S_k), dtype=torch.bool,
                               device=q.device)
            if window is not None:
                m = m & (kpos[None, :] > qpos_blk[:, None] - window)
            mb = m[None, None, None]
        lg = torch.where(mb, lg, torch.full_like(lg, -1e30))
        pr = torch.softmax(lg.float(), dim=-1)
        return torch.einsum("bngst,btnd->bsngd", pr, v)

    CHUNK = 512
    if S > CHUNK and S % CHUNK == 0 and qpos.ndim == 1:
        out = torch.cat([attend(qg[:, i:i + CHUNK], qpos[i:i + CHUNK])
                         for i in range(0, S, CHUNK)], 1)
    else:
        out = attend(qg, qpos)
    return out.reshape(B, S, n_heads * head_dim), new_cache


def make_cache(batch: int, s_max: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device="cuda", per_slot: bool = False):
    """KV cache (bf16 by default) with one position for every slot, or
    with ``per_slot`` one position per slot (idx (B,)): batched decode
    of slots at different depths (launch.serve --continuous)."""
    idx = torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                      device=device)
    shape = (batch, s_max, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": idx}


def _silu(x):
    return x * torch.sigmoid(x)      # jax.nn.silu's form


def gelu(x):
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p, x, qcfg: QuantConfig, kind: str):
    """The MLP kinds of the reference: swiglu and geglu (gate and up
    projections, merged into w_gateup by quant.fuse_projections), relu2
    (nemotron's squared ReLU) and gelu (w_up and w_down only)."""
    if kind in ("geglu", "swiglu") and "w_gateup" in p:
        # merged gate|up projection (quant.fuse_projections)
        act = gelu if kind == "geglu" else _silu
        g, u = torch.chunk(qdot(x, p["w_gateup"], qcfg), 2, -1)
        h = act(g) * u
    elif kind == "geglu":
        h = gelu(qdot(x, p["w_gate"], qcfg)) * qdot(x, p["w_up"], qcfg)
    elif kind == "swiglu":
        h = _silu(qdot(x, p["w_gate"], qcfg)) * qdot(x, p["w_up"], qcfg)
    elif kind == "relu2":
        h = torch.square(torch.relu(qdot(x, p["w_up"], qcfg)))
    else:
        h = gelu(qdot(x, p["w_up"], qcfg))
    h = constrain(h, "batch", None, "ffn")
    return qdot(h, p["w_down"], qcfg)


def embed(table, tokens):
    return constrain(table[tokens.long()], "batch", None, "embed")


def unembed(table, x, qcfg: QuantConfig):
    """Tied output head.  Exact (a plain float32 matmul) unless
    qcfg.quant_unembed, which routes it through qdot: the (vocab, D)
    table is not prequantized (is_dense_weight), so each call quantizes
    table.T dynamically, as the reference does."""
    with trace.span("model.head"):
        if not qcfg.quant_unembed:
            return torch.matmul(x, table.T)
        return qdot(x, table.T, qcfg)
