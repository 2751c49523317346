"""Mixture-of-Experts layer (mixtral-style top-k, llama4-style top-1).

Capacity-based, sort-free dispatch by one-hot position ranking, as the
reference's ``models/moe.py``: every expert takes a fixed C rows (C the
capacity), padded with an appended zero row, so each expert projection
is one qdot of M = C rows.  Every op follows the reference's order.

Expert FFNs run through quant.qdot over the stack's expert axis, one
expert at a time; an active calibration observer gets each expert's
index inside the layer's, as the reference's pscan gives it
(``units.0.moe.w_up@3.5``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve
from ..quant import QuantConfig, qdot
from ..quant.linear import QuantizedWeight, get_observer
from . import layers
from .sharding import constrain


def moe_init(generator: torch.Generator, n_layers: int, d_model: int,
             d_ff: int, n_experts: int, kind: str, shared_ff: int = 0,
             device="cuda"):
    """Random MoE params stacked over ``n_layers``, with the reference's
    shapes and init scales: router (L, D, E) N(0, 0.02^2), experts
    w_gate/w_up (L, E, D, F) N(0, 1/D) and w_down (L, E, F, D) N(0, 1/F)
    (w_gate for the GLU kinds only), the shared expert a dense MLP of
    width ``shared_ff`` (N(0, 1/in_dim) kernels).  Drawn on
    ``generator``'s device, then moved to ``device`` (the card unless
    asked otherwise, as every entry point: device.resolve)."""
    device = resolve(device)
    L, D, E = n_layers, d_model, n_experts

    def normal(shape, scale):
        if generator is None:             # meta: the shape alone
            return torch.empty(shape, device=device)
        w = torch.randn(shape, generator=generator,
                        device=generator.device) * scale
        return w.to(device)

    glu = kind in ("geglu", "swiglu")
    p = {"router": normal((L, D, E), 0.02),
         "w_up": normal((L, E, D, d_ff), D ** -0.5),
         "w_down": normal((L, E, d_ff, D), d_ff ** -0.5)}
    if glu:
        p["w_gate"] = normal((L, E, D, d_ff), D ** -0.5)
    if shared_ff:
        shared = {"w_up": normal((L, D, shared_ff), 1.0 / math.sqrt(D)),
                  "w_down": normal((L, shared_ff, D),
                                   1.0 / math.sqrt(shared_ff))}
        if glu:
            shared["w_gate"] = normal((L, D, shared_ff), 1.0 / math.sqrt(D))
        p["shared"] = shared
    return p


def _expert(w, e: int):
    """Expert e of an (E, ...) stack: a view, or a QuantizedWeight's
    memoized slice (its own scales, zero points and sums)."""
    return w.layer(e) if isinstance(w, QuantizedWeight) else w[e]


def select_top_k(probs: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, largest
    first, a tie going to the lower index (jax.lax.top_k's order): a
    stable descending sort, on every device."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's composite over the last axis: exp(x - max) over
    its sum."""
    e = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Rows per expert: max(int(T k cf / E), 4), Python's truncation."""
    return max(int(tokens * top_k * capacity_factor / n_experts), 4)


def dispatch(gate_idx: torch.Tensor, n_experts: int, C: int):
    """The dispatch of (T, k) expert choices onto (E, C) slots: each
    (token, choice)'s position in its expert's queue (a cumsum ranking
    in token order), the keep mask (position < C) and the (E, C) table
    of token ids, T where a slot is empty.  Returns (table, keep, slot),
    slot C for a dropped choice."""
    T, k = gate_idx.shape
    dev = gate_idx.device
    onehot = F.one_hot(gate_idx.long(), n_experts).to(torch.int32)
    flat = onehot.reshape(T * k, n_experts)
    pos = torch.cumsum(flat, 0, dtype=torch.int32) - 1
    pos = (pos * flat).sum(-1, dtype=torch.int32).reshape(T, k)
    keep = pos < C
    tok_ids = torch.arange(T, dtype=torch.int32,
                           device=dev)[:, None].expand(T, k)
    slot = torch.where(keep, pos, torch.full_like(pos, C))
    table = torch.full((n_experts, C + 1), T, dtype=torch.int32, device=dev)
    table[gate_idx.reshape(-1).long(), slot.reshape(-1).long()] = \
        tok_ids.reshape(-1)
    return table[:, :C], keep, slot


def combine(ye: torch.Tensor, table: torch.Tensor, gate_idx: torch.Tensor,
            slot: torch.Tensor, w: torch.Tensor, T: int) -> torch.Tensor:
    """The experts' outputs ye (E, C, D) back onto their T tokens: each
    slot's row times its gate weight (w (T, k), zero for a dropped
    choice, set through an (E, C + 1) gate table whose last column
    takes the drops), added with index_add_ into a (T + 1, D) float32
    buffer whose last row takes the empty slots.  A token gets at most
    top_k terms added onto zero: for top_k <= 2 (every config) the order
    of the adds cannot change the sum, on any device."""
    E, C, D = ye.shape
    out = torch.zeros((T + 1, D), dtype=torch.float32, device=ye.device)
    gate_table = torch.zeros((E, C + 1), dtype=torch.float32,
                             device=ye.device)
    gate_table[gate_idx.reshape(-1).long(), slot.reshape(-1).long()] = \
        w.reshape(-1)
    gw = gate_table[:, :C].reshape(-1)                         # (E*C,)
    out.index_add_(0, table.reshape(-1).long(),
                   ye.reshape(E * C, D) * gw[:, None])
    return out[:T]


def _act(kind: str):
    return layers._silu if kind == "swiglu" else layers.gelu


def moe(p, x, qcfg: QuantConfig, *, n_experts: int, top_k: int, kind: str,
        capacity_factor: float = 1.25, shared: bool = False):
    """x: (B, S, D) -> (y (B, S, D), aux): route each token to its top_k
    experts through the router's qdot and a float32 softmax, run every
    expert on its C dispatched rows, and scatter-add the outputs back
    weighted by the renormalised gates; tokens past an expert's capacity
    are dropped from it.  aux is the Switch-style load-balancing term."""
    B, S, D = x.shape
    T = B * S
    xt = constrain(x.reshape(T, D), "batch", None)
    logits = qdot(xt, p["router"], qcfg)                       # (T, E)
    probs = softmax(logits.float())
    gate_vals, gate_idx = select_top_k(probs, top_k)           # (T, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    C = capacity(T, top_k, n_experts, capacity_factor)
    table, keep, slot = dispatch(gate_idx, n_experts, C)
    xe_src = torch.cat([xt, torch.zeros((1, D), dtype=xt.dtype,
                                        device=xt.device)], 0)
    xe = xe_src[table.long()]                                  # (E, C, D)
    # EP over the expert axis when divisible; the capacity axis shards
    # over data either way so the dispatch buffer never replicates
    xe = constrain(xe, "experts", "expert_cap", None)

    glu = kind in ("geglu", "swiglu")
    act = _act(kind)
    obs = get_observer()
    ye = []
    for e in range(n_experts):
        if obs is not None:
            obs.push(e)
        try:
            xc = xe[e]
            if glu:
                h = act(qdot(xc, _expert(p["w_gate"], e), qcfg)) * \
                    qdot(xc, _expert(p["w_up"], e), qcfg)
            else:
                h = act(qdot(xc, _expert(p["w_up"], e), qcfg))
            ye.append(qdot(h, _expert(p["w_down"], e), qcfg))
        finally:
            if obs is not None:
                obs.pop()
    ye = torch.stack(ye)                                       # (E, C, D)
    w = (gate_vals * keep).float()                             # (T, k)
    y = combine(ye, table, gate_idx, slot, w, T).reshape(B, S, D)

    if shared and "shared" in p:
        y = y + layers.mlp(p["shared"], x, qcfg, kind)

    me = probs.mean(0)                                         # (E,)
    ce = F.one_hot(gate_idx[:, 0].long(), n_experts).float().mean(0)
    aux = n_experts * torch.sum(me * ce)
    return y, aux
