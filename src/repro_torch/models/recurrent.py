"""Recurrent blocks: xLSTM's mLSTM and sLSTM (xlstm-125m) and the RG-LRU
with its temporal conv (recurrentgemma-2b).

Plain PyTorch, op for op after the reference's ``models/recurrent.py``,
which computes them outside any Pallas kernel.  Every input, gate and
output projection is a ``quant.qdot`` (on the card a fused_qdot or
delta_matmul launch); the gates and the state update are float32 tensor
ops.  A block takes x (B, S, D) and an optional state (a fresh zero
state when None) and returns (y, final state): S > 1 is the prefill
(a time loop for mLSTM/sLSTM, a parallel scan for the RG-LRU), S = 1 a
decode step against the carried state.

Float forms follow the reference's formulas: softplus is
``jnp.logaddexp(x, 0)`` written out (max(x, 0) + log1p(exp(-|x|))),
log_sigmoid is -softplus(-x), and the RG-LRU's linear recurrence is
combined in jax.lax.associative_scan's odd/even order
(``associative_scan``), not by a sequential loop.  torch's exp, log1p,
sigmoid and tanh are not XLA's, and torch's einsum sums in another
order: the CPU tests report the gaps they leave in the states.

Params of each block are stacked over the layers (leading n_units
axis), as models.transformer keeps every block; the functions here take
one layer's slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve, true_div
from ..quant import QuantConfig, qdot
from . import layers


def _normal(generator, shape, scale, device):
    """N(0, scale^2) drawn on the generator's device, then moved to
    ``device``; with no generator (``device`` meta) the shape alone."""
    if generator is None:
        return torch.empty(shape, device=device)
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * scale).to(device)


def _dense(generator, L, in_dim, out_dim, device, scale=None):
    """(L, in_dim, out_dim) kernels N(0, scale^2), scale 1/sqrt(in_dim)
    unless given (the reference's layers.dense_init)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return _normal(generator, (L, in_dim, out_dim), scale, device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, i.e. jnp.logaddexp(x, 0): max(x, 0) +
    log1p(exp(-|x|)), x + 0 where that is NaN."""
    return torch.where(torch.isnan(x), x + 0.0,
                       torch.clamp_min(x, 0.0)
                       + torch.log1p(torch.exp(-torch.abs(x))))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_sigmoid: -softplus(-x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C (head_dim x head_dim per head)
# ---------------------------------------------------------------------------

def mlstm_init(generator: torch.Generator, n_layers: int, d_model: int,
               n_heads: int, device="cuda"):
    """Random mLSTM params stacked over ``n_layers``, the reference's
    shapes and scales: wq/wk/wv/wo (D, D) N(0, 1/D), the gates wi/wf
    (D, n_heads) N(0, 0.02^2), the output norm's gain 1."""
    dev = resolve(device)
    L, D = n_layers, d_model
    return {"wq": _dense(generator, L, D, D, dev),
            "wk": _dense(generator, L, D, D, dev),
            "wv": _dense(generator, L, D, D, dev),
            "wi": _dense(generator, L, D, n_heads, dev, 0.02),
            "wf": _dense(generator, L, D, n_heads, dev, 0.02),
            "wo": _dense(generator, L, D, D, dev),
            "norm": torch.ones((L, D), dtype=torch.float32, device=dev)}


def mlstm_state(batch: int, n_heads: int, head_dim: int, device="cuda"):
    dev = resolve(device)
    return {"C": torch.zeros((batch, n_heads, head_dim, head_dim),
                             dtype=torch.float32, device=dev),
            "n": torch.zeros((batch, n_heads, head_dim), dtype=torch.float32,
                             device=dev),
            "m": torch.zeros((batch, n_heads), dtype=torch.float32,
                             device=dev)}


def mlstm(p, x, qcfg: QuantConfig, n_heads: int,
          state: Optional[dict] = None):
    """x: (B, S, D). Returns (y, final_state)."""
    B, S, D = x.shape
    hd = D // n_heads
    rt = math.sqrt(hd)
    q = true_div(qdot(x, p["wq"], qcfg).reshape(B, S, n_heads, hd), rt)
    k = true_div(qdot(x, p["wk"], qcfg).reshape(B, S, n_heads, hd), rt)
    v = qdot(x, p["wv"], qcfg).reshape(B, S, n_heads, hd)
    it = qdot(x, p["wi"], qcfg)     # (B, S, H) input gate (pre-exp)
    ft = qdot(x, p["wf"], qcfg)     # (B, S, H) forget gate (pre-sigmoid)
    if state is None:
        state = mlstm_state(B, n_heads, hd, x.device)
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(S):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]      # (B, H, hd)
        ii, ff = it[:, t], ft[:, t]                 # (B, H)
        logf = log_sigmoid(ff)
        m_new = torch.maximum(logf + m, ii)         # stabilizer state
        i_g = torch.exp(ii - m_new)
        f_g = torch.exp(logf + m - m_new)
        C = f_g[..., None, None] * C + i_g[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])    # (B, H, hd, hd)
        n = f_g[..., None] * n + i_g[..., None] * kt
        h_num = torch.einsum("bhij,bhj->bhi", C, qt)
        h_den = torch.clamp_min(
            torch.abs(torch.einsum("bhj,bhj->bh", n, qt)), 1.0)
        hs.append(h_num / h_den[..., None])
        m = m_new
    h = torch.stack(hs, 1).reshape(B, S, D)
    h = layers.rmsnorm(h, p["norm"])
    return qdot(h, p["wo"], qcfg), {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with exponential gating
# ---------------------------------------------------------------------------

def slstm_init(generator: torch.Generator, n_layers: int, d_model: int,
               device="cuda"):
    """Random sLSTM params stacked over ``n_layers``: wz/wo (D, D)
    N(0, 1/D), the gates wi/wf/wo_gate (D, D) N(0, 0.02^2), the norm's
    gain 1."""
    dev = resolve(device)
    L, D = n_layers, d_model
    return {"wz": _dense(generator, L, D, D, dev),
            "wi": _dense(generator, L, D, D, dev, 0.02),
            "wf": _dense(generator, L, D, D, dev, 0.02),
            "wo_gate": _dense(generator, L, D, D, dev, 0.02),
            "wo": _dense(generator, L, D, D, dev),
            "norm": torch.ones((L, D), dtype=torch.float32, device=dev)}


def slstm_state(batch: int, d_model: int, device="cuda"):
    dev = resolve(device)
    return {k: torch.zeros((batch, d_model), dtype=torch.float32, device=dev)
            for k in ("c", "n", "m")}


def slstm(p, x, qcfg: QuantConfig, state: Optional[dict] = None):
    """x: (B, S, D). Returns (y, final_state)."""
    B, S, D = x.shape
    z = torch.tanh(qdot(x, p["wz"], qcfg))
    ii = qdot(x, p["wi"], qcfg)
    ff = qdot(x, p["wf"], qcfg)
    oo = torch.sigmoid(qdot(x, p["wo_gate"], qcfg))
    if state is None:
        state = slstm_state(B, D, x.device)
    c, n, m = state["c"], state["n"], state["m"]
    hs = []
    for t in range(S):
        zt, it, ft, ot = z[:, t], ii[:, t], ff[:, t], oo[:, t]
        logf = log_sigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        hs.append(ot * c / torch.clamp_min(n, 1.0))
        m = m_new
    h = layers.rmsnorm(torch.stack(hs, 1), p["norm"])
    return qdot(h, p["wo"], qcfg), {"c": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma / Griffin) + temporal conv
# ---------------------------------------------------------------------------

def rglru_init(generator: torch.Generator, n_layers: int, d_model: int,
               d_rnn: int, conv_width: int = 4, device="cuda"):
    """Random RG-LRU params stacked over ``n_layers``: w_in (D, R) and
    w_out (R, D) N(0, 1/in_dim), the gates w_gate_x/w_gate_a (D, R)
    N(0, 0.02^2), a_param = softplus^-1(-log(Lambda)) for Lambda evenly
    spaced in [0.9, 0.999] (every layer alike), the conv (cw, R)
    N(0, 0.1^2)."""
    dev = resolve(device)
    L, D, R = n_layers, d_model, d_rnn
    lam = torch.linspace(0.9, 0.999, R, dtype=torch.float32)
    a_param = torch.log(torch.expm1(-torch.log(lam)))
    return {"w_in": _dense(generator, L, D, R, dev),
            "w_gate_x": _dense(generator, L, D, R, dev, 0.02),
            "w_gate_a": _dense(generator, L, D, R, dev, 0.02),
            "a_param": a_param.expand(L, R).contiguous().to(dev),
            "conv": _normal(generator, (L, conv_width, R), 0.1, dev),
            "w_out": _dense(generator, L, R, D, dev)}


def rglru_state(batch: int, d_rnn: int, conv_width: int = 4, device="cuda"):
    dev = resolve(device)
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, conv_width - 1, d_rnn),
                                dtype=torch.float32, device=dev)}


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """The scan of h_t = a_t h_{t-1} + b_t over axis 0, combined as
    jax.lax.associative_scan combines (l, r) -> (a_l a_r, b_r + a_r b_l):
    adjacent pairs first, the half-length scan by recursion, then the
    even elements from the odd ones, interleaved.  Every product and sum
    falls where the reference's does, so equal inputs give bit-equal
    outputs on the CPU (a sequential loop would round otherwise)."""
    n = a.shape[0]
    if n < 2:
        return a, b
    al, bl, ar, br = a[0:n - 1:2], b[0:n - 1:2], a[1::2], b[1::2]
    oa, ob = associative_scan(al * ar, br + ar * bl)
    a2, b2 = a[2::2], b[2::2]
    if n % 2 == 0:
        oa_e, ob_e = oa[:-1], ob[:-1]
    else:
        oa_e, ob_e = oa, ob
    ea = torch.cat([a[:1], oa_e * a2], 0)
    eb = torch.cat([b[:1], b2 + a2 * ob_e], 0)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[0::2], out_a[1::2] = ea, oa
    out_b[0::2], out_b[1::2] = eb, ob
    return out_a, out_b


def rglru(p, x, qcfg: QuantConfig, state: Optional[dict] = None):
    """Griffin recurrent block. x: (B, S, D) -> (y, final_state)."""
    B, S, D = x.shape
    u = qdot(x, p["w_in"], qcfg)                        # (B, S, R)
    R = u.shape[-1]
    cw = p["conv"].shape[0]
    if state is None:
        state = rglru_state(B, R, cw, x.device)
    # causal depthwise temporal conv (width cw), summed from 0 as the
    # reference's Python sum()
    upad = torch.cat([state["conv"], u], 1)             # (B, S+cw-1, R)
    uc = sum(upad[:, i:i + S] * p["conv"][i] for i in range(cw))
    new_conv = upad[:, -(cw - 1):] if cw > 1 else state["conv"]

    rx = torch.sigmoid(qdot(x, p["w_gate_x"], qcfg))    # input gate
    ra = torch.sigmoid(qdot(x, p["w_gate_a"], qcfg))    # recurrence gate
    c_softplus = softplus(p["a_param"])                 # > 0
    log_a = -8.0 * ra * c_softplus                      # (B, S, R), < 0
    a = torch.exp(log_a)
    gated = rx * uc
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    v = beta * gated

    # linear recurrence h_t = a_t h_{t-1} + v_t, the initial state folded
    # into the first element
    aT = a.transpose(0, 1)
    vT = v.transpose(0, 1).clone()
    vT[0] = vT[0] + aT[0] * state["h"]
    _, h_sc = associative_scan(aT, vT)
    h = h_sc.transpose(0, 1)                            # (B, S, R)
    final = {"h": h[:, -1], "conv": new_conv}
    return qdot(h, p["w_out"], qcfg), final
