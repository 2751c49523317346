"""uint8 asymmetric + int8 symmetric quantization for the approximate
multiplier.

The paper's multiplier is unsigned 8x8, so its natural quantized form is
asymmetric uint8:   q = clip(round(x / s) + z, 0, 255), and a quantized
matmul decomposes as

    y = s_x s_w [ Q_x (x) Q_w  -  z_w rowsum(Q_x)  -  z_x colsum(Q_w)
                  + K z_x z_w ]

where only the Q_x (x) Q_w term runs through the approximate multiplier.
mode='sym_i8' quantizes symmetrically to int8 (zero point 0) through the
signed multiplier registry:  y = s_x s_w [ Q_x (x)_signed Q_w ].

Rounding is half to even (torch.round), as jnp.round in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import true_div


@dataclass(frozen=True)
class QuantConfig:
    """How the approximate multiplier is applied inside matmuls.

    design:  'exact' | 'design1' | 'design2' | ... (core.multipliers)
    backend: 'delta' by default, where the reference defaults to 'xla':
             both give the same integer products (the exact product plus
             the delta table is the product table, term by term), and
             the plain versions the CPU runs are cheaper on 'delta' (one
             exact matmul and a 16-bit gather) than on the product-LUT
             gather.  The serve CLI keeps the reference's default ('xla'
             uncalibrated, 'fused' with static scales).  Every name the
             reference accepts (kernels.ops.approx_matmul
             says which kernel each launches on the card):
             'xla' / 'pallas_legacy' (the product-LUT gather sum, the
             lut_matmul kernel), 'residual' / 'residual_xla' (exact
             product + rank-``rank`` error correction, the
             residual_matmul kernel; approximate, not bit-exact),
             'pallas' / 'delta' / 'delta_xla' (exact product + delta
             gather, the delta_matmul kernel), 'fused' (one kernel does
             static activation quantization + the delta product + the
             dequant epilogue; needs prequantized weights with
             calibrated static activation scales, else it degrades to
             'delta'), 'exact'.  The port has no XLA: a name that says
             'xla' in the reference means the same function here.
    rank:    correction rank of the 'residual' backends
    compensate: mean-field bias compensation (subtract the separable
        conditional means mu_r[a] + mu_c[b] - mu of the error table).
    mode: 'asym_u8' (unsigned multiplier + zero-point decomposition) or
        'sym_i8' (symmetric int8 through the signed registry).
    w_per_channel: weight scales per output column (the reduction runs
        over K only, one (1, N) scale row per stacked layer) instead of
        one per tensor.  The integer product is unchanged; only the
        dequantization broadcast differs, so every backend takes it.
    quant_unembed: route the tied output head through qdot (the
        approximate product, its table quantized dynamically on every
        call, as the reference does) instead of an exact float32 matmul.
    act_per_pos: per-position dynamic activation quantization (set by
        train.make_prefill_step; ignored where static scales exist).
    inference: pure inference (serve sets it): qdot skips the
        straight-through branch y_ste + (y - y_ste).detach(), which
        changes the forward value by float reassociation only.  Leave it
        False wherever gradients flow.
    """
    design: str = "design2"
    backend: str = "delta"
    rank: int = 32
    compensate: bool = True
    mode: str = "asym_u8"
    w_per_channel: bool = False
    quant_unembed: bool = False
    act_per_pos: bool = False
    inference: bool = False

    def __post_init__(self):
        if self.mode not in ("asym_u8", "sym_i8"):
            raise ValueError(
                f"unknown quant mode {self.mode!r}; expected 'asym_u8' "
                f"or 'sym_i8'")

    @property
    def enabled(self) -> bool:
        return self.design != "exact"

    @property
    def signed(self) -> bool:
        return self.mode == "sym_i8"


def _reduce(fn, x, axis):
    if axis is None:
        return fn(x)
    return fn(x, dim=axis, keepdim=True)


def _amin(x, dim=None, keepdim=False):
    return torch.amin(x) if dim is None else torch.amin(x, dim, keepdim)


def _amax(x, dim=None, keepdim=False):
    return torch.amax(x) if dim is None else torch.amax(x, dim, keepdim)


def _minmax_scale(x, axis=None, eps=1e-8):
    # the range is a constant of the gradient (the reference's
    # stop_gradient): no gradient flows through the scales
    lo = _reduce(_amin, x.detach(), axis)
    hi = _reduce(_amax, x.detach(), axis)
    scale = torch.clamp_min(true_div(hi - lo, 255.0), eps)
    zp = torch.clamp(torch.round(-lo / scale), 0, 255)
    return scale, zp


def quantize_uint8(x, axis=None):
    """Returns (q, scale, zp): q integer-valued in [0,255] (int32)."""
    scale, zp = _minmax_scale(x, axis)
    q = torch.clamp(torch.round(x / scale) + zp, 0, 255)
    return q.to(torch.int32), scale, zp


def quantize_int8(x, axis=None, eps=1e-8):
    """Symmetric signed quantization: q in [-128,127] (int32), zero point
    0.  Returns (q, scale) with x ~= q * scale."""
    amax = _reduce(_amax, torch.abs(x.detach()), axis)
    scale = torch.clamp_min(true_div(amax, 127.0), eps)
    q = torch.clamp(torch.round(x / scale), -128, 127)
    return q.to(torch.int32), scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def dequantize(q, scale, zp):
    return (q.to(torch.float32) - zp) * scale


def fake_quant(x, axis=None):
    """Straight-through fake-quantization (QAT): the value of the uint8
    round trip, the gradient of the identity."""
    q, s, z = quantize_uint8(x, axis)
    xq = dequantize(q, s, z)
    return x + (xq - x).detach()
