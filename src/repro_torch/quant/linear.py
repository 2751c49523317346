"""Quantized linear ops routed through the approximate multiplier.

``qdot(x, w, cfg)`` is the integration point of the paper's technique:
every dense projection goes through it.  With cfg.design == 'exact' it is
a plain fp matmul; otherwise the uint8 zero-point decomposition (or the
symmetric int8 product) sends Q_x (x) Q_w through the delta kernel, or,
with calibrated static activation scales and backend 'fused', the whole
quantize -> product -> dequant chain through the fused kernel.

Precomputation ladder, each rung carried by ``QuantizedWeight`` with the
stacked-layer axes of the params tree kept on every field:

  1. ``prequantize_weights``: cached (q, scale, zp) + colsum(q).  On every
     device q is stored as uint8 (asym_u8) or int8 (sym_i8): the values
     equal the reference's int32 ones at a quarter of the bytes.
  2. static activation scales (``calib``: observe -> table ->
     ``apply_calibration``).
  3. per-layer design plans (``calib.plan.apply_plan``): each site's
     distinct delta tables in a process-level bank
     (``register_dlut_bank``), the wrapper carrying each layer's bank
     index and the design's compensation tables.
  4. ``attach_comp_cols`` (calib.static) and ``fuse_projections``.

Calibration observers: ``calib.observe`` installs a process-global
observer via ``set_observer``; qdot reports (x, site, cfg) for every
QuantizedWeight-bound call.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..kernels import ops
from .quantize import QuantConfig, quantize_int8, quantize_uint8

_MF_CACHE: dict = {}

# Param-dict keys that flow through qdot: every dense kernel is named
# "w*" plus the MoE router and the encoder frontend projection.
_DENSE_KEYS = ("router", "frontend_proj")

# Calibration observer (calib.observe); None outside calibration passes.
_OBSERVER = None

_STALE_WARNED: set = set()

# Delta-table banks (calib.plan): per-site stacks of the distinct int16
# delta tables the site's layers use, registered at plan install.  Keys
# are content-addressed (path + mode + design list), so re-registering is
# idempotent.  key -> {device: (n, 256, 256) int16 tensor}
_DLUT_BANKS: dict = {}

_TENSOR_FIELDS = ("w", "q", "scale", "zp", "colsum", "act_scale", "act_zp",
                  "dlut", "comp_r", "comp_c", "comp_mu", "comp_col")


def register_dlut_bank(key: str, bank: torch.Tensor) -> None:
    """Register a site's (n, 256, 256) int16 delta-table bank, on the
    bank tensor's device.  A wrapper then carries only the per-layer index
    into it (QuantizedWeight.dlut, with dlut_bank=key)."""
    bank = bank.reshape(-1, 256, 256).contiguous()
    if bank.dtype != torch.int16:
        raise ValueError(f"delta-table bank {key!r} must be int16, got "
                         f"{bank.dtype}")
    _DLUT_BANKS[key] = {str(bank.device): bank}


def get_dlut_bank(key: str, device="cpu") -> torch.Tensor:
    """The bank registered under ``key``, on ``device`` (copied there
    from another device's once, then cached)."""
    if key not in _DLUT_BANKS:
        raise KeyError(
            f"delta-table bank {key!r} is not registered in this process "
            f"({len(_DLUT_BANKS)} banks known).  QuantizedWeight trees "
            f"carrying bank indices are process-local: re-run "
            f"calib.plan.apply_plan (or make_plan_injector) to install "
            f"the plan here.")
    per_dev = _DLUT_BANKS[key]
    dev = str(torch.device(device))
    if dev not in per_dev:
        per_dev[dev] = next(iter(per_dev.values())).to(dev)
    return per_dev[dev]


def set_observer(obs) -> None:
    """Install (or clear, with None) the calibration observer."""
    global _OBSERVER
    _OBSERVER = obs


def get_observer():
    return _OBSERVER


@dataclasses.dataclass(eq=False)
class QuantizedWeight:
    """A dense weight with (some of) its quantization precomputed.

    Transparent to qdot: pass one where a float (..., K, N) weight went.
    Leading (stacked-layer) axes are kept on every field; ``layer(i)``
    slices them all in lockstep.

    Fields (None = not precomputed; qdot falls back to dynamic work):
      w             master weights (float)
      q, scale, zp  cached weight quantization (zp None for sym_i8); q is
                    uint8 (asym_u8) or int8 (sym_i8); per-tensor scales
                    (..., 1, 1), per-column (..., 1, N) with
                    QuantConfig.w_per_channel or when merged
      colsum        colsum(q) float32 (..., 1, N), the asym_u8 cross term
      act_scale/act_zp  calibrated static activation quantizer (...,)
      dlut          per-layer design plan (calib.plan): the layer's int32
                    index (...,) into the site's delta-table bank named by
                    ``dlut_bank`` (register_dlut_bank).  Kept on the host
                    whatever the weights' device: the layer's table is a
                    row of the bank, chosen there, so no step syncs
      comp_r/comp_c/comp_mu
                    per-layer mean-field compensation tables of the
                    plan's designs (256,), (256,), () per layer
      comp_col      cached colsum of the column compensation table over
                    q, (..., 1, N) f32 (calib.static.attach_comp_cols)
      mode          QuantConfig.mode the cache was built for
      path          the weight's params-tree path ("units.0.attn.wq"),
                    the calibration site name
      per_channel   per-column scales (QuantConfig.w_per_channel, or set
                    by fuse_projections)
      dlut_bank     registry key of the site's delta-table bank
      merged        fuse_projections output
    """
    w: torch.Tensor
    q: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    zp: Optional[torch.Tensor] = None
    colsum: Optional[torch.Tensor] = None
    act_scale: Optional[torch.Tensor] = None
    act_zp: Optional[torch.Tensor] = None
    dlut: Optional[torch.Tensor] = None
    comp_r: Optional[torch.Tensor] = None
    comp_c: Optional[torch.Tensor] = None
    comp_mu: Optional[torch.Tensor] = None
    comp_col: Optional[torch.Tensor] = None
    mode: str = "asym_u8"
    path: str = ""
    per_channel: bool = False
    dlut_bank: Optional[str] = None
    merged: bool = False
    # per-object memo of layer slices and packed kernel operands; the
    # wrapper is never mutated after construction (replace() makes a new
    # one with an empty memo)
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)

    def replace(self, **kw) -> "QuantizedWeight":
        return dataclasses.replace(self, **kw)

    def layer(self, i: int) -> "QuantizedWeight":
        """The i-th slice of every field along the leading axis."""
        key = ("layer", i)
        if key not in self._memo:
            self._memo[key] = self.replace(**{
                f: getattr(self, f)[i] for f in _TENSOR_FIELDS
                if getattr(self, f) is not None})
        return self._memo[key]


def _weight_axis(w, per_channel: bool):
    """Quantization reduce axes over the trailing (K, N): both (per
    tensor, one scale per stacked slice) or K only (per channel, one
    scale per output column, shape (..., 1, N))."""
    if per_channel:
        return w.ndim - 2
    return None if w.ndim == 2 else (w.ndim - 2, w.ndim - 1)


def _quantize_weight(w: torch.Tensor, cfg: QuantConfig,
                     path: str = "") -> QuantizedWeight:
    """Quantize over the trailing (K, N) axes, or over K alone with
    cfg.w_per_channel; leading axes are stacked layers and keep their
    own scales."""
    axis = _weight_axis(w, cfg.w_per_channel)
    if cfg.signed:
        q, s = quantize_int8(w, axis)
        zp = colsum = None
        q = q.to(torch.int8)
    else:
        q, s, zp = quantize_uint8(w, axis)
        colsum = q.sum(-2, keepdim=True).float()
        q = q.to(torch.uint8)
    return QuantizedWeight(w, q, s, zp, colsum=colsum, mode=cfg.mode,
                           path=path, per_channel=cfg.w_per_channel)


def is_dense_weight(k, v) -> bool:
    """Does params-tree key k with value v flow through qdot?"""
    return ((k in _DENSE_KEYS or (isinstance(k, str) and k.startswith("w")))
            and isinstance(v, torch.Tensor) and v.ndim >= 2
            and v.is_floating_point())


def map_quantized(node, fn):
    """Rebuild a params tree applying fn(qw) -> QuantizedWeight to every
    QuantizedWeight node."""
    if isinstance(node, QuantizedWeight):
        return fn(node)
    if isinstance(node, dict):
        return {k: map_quantized(v, fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(map_quantized(v, fn) for v in node)
    return node


def walk_dense(node, fn, path=""):
    """Rebuild a params tree applying fn(leaf, path) to every qdot-bound
    dense weight."""
    if isinstance(node, dict):
        return {k: (fn(v, f"{path}.{k}".lstrip("."))
                    if is_dense_weight(k, v)
                    else walk_dense(v, fn, f"{path}.{k}".lstrip(".")))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(walk_dense(v, fn, f"{path}.{i}".lstrip("."))
                          for i, v in enumerate(node))
    return node


def prequantize_weights(params, cfg: QuantConfig):
    """A copy of ``params`` with every qdot-bound dense weight wrapped in
    a QuantizedWeight that records its tree path (the calibration site
    name).  No-op when cfg.enabled is False."""
    if not cfg.enabled:
        return params
    return walk_dense(params, lambda v, p: _quantize_weight(v, cfg, p))


def _warn_stale(pre: QuantizedWeight, cfg: QuantConfig) -> None:
    key = (pre.mode, pre.per_channel, cfg.mode, cfg.w_per_channel)
    if key in _STALE_WARNED:
        return
    _STALE_WARNED.add(key)
    warnings.warn(
        f"QuantizedWeight cache built for mode={pre.mode!r}/"
        f"per_channel={pre.per_channel} used with QuantConfig(mode="
        f"{cfg.mode!r}, w_per_channel={cfg.w_per_channel}) (site "
        f"{pre.path!r}): falling back to requantizing the master weights "
        f"on EVERY call.  Re-run prequantize_weights with the serving "
        f"QuantConfig.", stacklevel=3)


def _mean_field_tables(design: str, signed: bool = False):
    """Conditional-mean error tables for bias compensation: (mu_r (256,)
    f32, mu_c (256,) f32, mu float) as numpy.  Signed tables are indexed
    by the offset-shifted operand (q + 128)."""
    key = (design, signed)
    if key not in _MF_CACHE:
        from ..core import lut as lutmod
        table = (lutmod.signed_error_table if signed
                 else lutmod.error_table)
        e = table(design).astype(np.float64)
        _MF_CACHE[key] = (e.mean(1).astype(np.float32),
                          e.mean(0).astype(np.float32),
                          float(e.mean()))
    return _MF_CACHE[key]


def _mean_field_device(design: str, signed: bool, device):
    """_mean_field_tables as f32 tensors on ``device`` (cached)."""
    key = (design, signed, str(torch.device(device)))
    if key not in _MF_CACHE:
        mu_r, mu_c, mu = _mean_field_tables(design, signed)
        _MF_CACHE[key] = (torch.from_numpy(mu_r).to(device),
                          torch.from_numpy(mu_c).to(device),
                          torch.tensor(mu, dtype=torch.float32,
                                       device=device))
    return _MF_CACHE[key]


def _site_comp_tables(pre, cfg: QuantConfig, signed: bool, device):
    """Compensation tables: the per-layer ones a design plan attached
    (matching the layer's delta table) when present, else the serving
    design's static tables."""
    if pre is not None and pre.comp_r is not None:
        return pre.comp_r, pre.comp_c, pre.comp_mu.reshape(()).float()
    return _mean_field_device(cfg.design, signed, device)


def _plan_table(pre, device) -> torch.Tensor:
    """A planned layer's delta table: row ``pre.dlut`` of the site's
    bank on ``device``, a view (on the card a contiguous 128 KiB table,
    16-byte aligned, since rows sit 131,072 bytes apart)."""
    if pre.dlut_bank is None:
        raise ValueError(f"site {pre.path!r}: a design plan's delta tables "
                         f"are carried as a bank index (calib.plan.apply_plan"
                         f" or make_plan_injector), not as a table")
    return get_dlut_bank(pre.dlut_bank, device)[int(pre.dlut)]


def _delta_prod(qx, qw, pre, signed: bool) -> torch.Tensor:
    """Per-layer mixed-design product: the exact integer product plus
    the gather of the layer's OWN delta table (a row of the site's bank),
    through the delta_matmul kernel.  float32 (..., N)."""
    K = qx.shape[-1]
    a2 = qx.reshape(-1, K)
    if a2.is_cuda:
        a2 = a2.to(torch.int32).contiguous()
        qw = qw.to(torch.int8 if signed else torch.uint8).contiguous()
    out = ops.delta_matmul(a2, qw, _plan_table(pre, qx.device),
                           offset=128 if signed else 0)
    return out.float().reshape(*qx.shape[:-1], qw.shape[-1])


def _wparam(p, per_channel: bool):
    """Reshape a cached weight-quant parameter for broadcast: per-tensor
    to a scalar, per-channel to its (1, N) column shape."""
    if p is None:
        return None
    if per_channel:
        return p.reshape(1, p.shape[-1])
    return p.reshape(())


def _use_fused(cfg: QuantConfig, pre) -> bool:
    """backend='fused' dispatches to the fused kernel whenever the
    wrapper carries cached weight quantization AND calibrated static
    activation scales; otherwise qdot takes the unfused pipeline (whose
    product backend treats 'fused' as 'delta')."""
    return (cfg.backend == "fused" and pre is not None
            and pre.q is not None and pre.act_scale is not None)


def _fused_operands(pre, cfg: QuantConfig, signed: bool):
    """The fused kernel's delta table (ops.delta_table's form: the serving
    design's, or the plan's bank row for this layer) and packed operand
    tables for one (per-layer) wrapper, built once and memoized on it."""
    key = ("fused", cfg.design, signed, cfg.compensate, pre.dlut_bank)
    if key in pre._memo:
        return pre._memo[key]
    dev = pre.q.device
    off = 128 if signed else 0
    comp_r = comp_col = comp_mu = None
    if cfg.compensate:
        comp_r, comp_c, comp_mu = _site_comp_tables(pre, cfg, signed, dev)
        if pre.comp_col is not None:
            comp_col = pre.comp_col.reshape(-1)
        else:
            comp_col = comp_c[pre.q.long() + off].sum(0)
    scal, ntab, cr = ops.pack_fused_operands(
        pre.q.shape[-1], dev, sx=pre.act_scale.reshape(()),
        zx=(pre.act_zp.reshape(()) if pre.act_zp is not None else None),
        sw=_wparam(pre.scale, pre.per_channel),
        zw=_wparam(pre.zp, pre.per_channel),
        colsum=(pre.colsum.reshape(-1) if pre.colsum is not None else None),
        comp_r=comp_r, comp_col=comp_col, comp_mu=comp_mu)
    table = ((_plan_table(pre, dev), False, 0) if pre.dlut is not None
             else ops.delta_table(cfg.design, signed, dev))
    out = (table, scal, ntab, cr)
    pre._memo[key] = out
    return out


def _qdot_fused(x, pre, cfg: QuantConfig, signed: bool):
    """The fused kernel on a wrapper's memoized operands."""
    (dlut, unsigned, bias), scal, ntab, cr = _fused_operands(pre, cfg,
                                                             signed)
    K = x.shape[-1]
    out = ops.fused_qdot_packed(x.reshape(-1, K).contiguous(), pre.q, dlut,
                                scal, ntab, cr, signed=signed,
                                compensate=cfg.compensate,
                                unsigned=unsigned, bias=bias)
    return out.reshape(*x.shape[:-1], pre.q.shape[-1])


def qdot(x: torch.Tensor, w, cfg: QuantConfig) -> torch.Tensor:
    """y[..., n] = sum_k approx(x[..., k], w[k, n])  (dequantized float32).

    x: (..., K) float; w: (K, N) float master weights, or a
    QuantizedWeight carrying cached weight quantization and/or
    calibrated static activation scales.
    """
    with trace.span("quant.qdot"):
        return _qdot(x, w, cfg)


def _qdot(x: torch.Tensor, w, cfg: QuantConfig) -> torch.Tensor:
    pre = w if isinstance(w, QuantizedWeight) else None
    if pre is not None:
        w = pre.w
        # a cache built for another quantization is stale; merged wrappers
        # carry per-column scales whatever the config asks
        if pre.mode != cfg.mode or (
                pre.q is not None and not pre.merged
                and pre.per_channel != cfg.w_per_channel):
            _warn_stale(pre, cfg)
            pre = None
    if _OBSERVER is not None and pre is not None:
        _OBSERVER.record(x, pre, cfg)
    if not cfg.enabled:
        return torch.matmul(x, w)
    if cfg.signed:
        y = _qdot_signed(x, w, cfg, pre)
    else:
        y = _qdot_asym(x, w, cfg, pre)
    if cfg.inference:
        return y
    # straight-through estimator: the gradient flows as if y == x @ w
    # (the exact float product); (y - y_ste) is a constant of it
    y_ste = torch.matmul(x, w)
    return y_ste + (y - y_ste).detach()


def _act_axis(x, cfg: QuantConfig):
    """Reduce axes for dynamic activation quantization: all axes, or
    with cfg.act_per_pos every axis except the sequence one."""
    if cfg.act_per_pos and x.ndim >= 3:
        return tuple(i for i in range(x.ndim) if i != x.ndim - 2)
    return None


def _quantize_act_static(x, pre, lo, hi):
    """Quantize activations with the calibrated static (scale, zp)."""
    sx = pre.act_scale.reshape(())
    zx = (pre.act_zp.reshape(()) if pre.act_zp is not None
          else torch.zeros((), dtype=torch.float32, device=x.device))
    qx = torch.clamp(torch.round(x / sx) + zx, lo, hi).to(torch.int32)
    return qx, sx, zx


def _qdot_asym(x, w, cfg, pre=None):
    """uint8 path: zero-point decomposition around the unsigned
    approximate product."""
    if _use_fused(cfg, pre):
        return _qdot_fused(x, pre, cfg, signed=False)
    if pre is not None and pre.act_scale is not None:
        qx, sx, zx = _quantize_act_static(x, pre, 0, 255)
    else:
        qx, sx, zx = quantize_uint8(x, _act_axis(x, cfg))
    if pre is not None and pre.q is not None:
        qw = pre.q
        sw = _wparam(pre.scale, pre.per_channel)
        zw = _wparam(pre.zp, pre.per_channel)
        colsum = pre.colsum.reshape(1, pre.colsum.shape[-1]) \
            if pre.colsum is not None else None
    else:
        qw, sw, zw = quantize_uint8(w, _weight_axis(w, cfg.w_per_channel))
        if cfg.w_per_channel:
            sw, zw = _wparam(sw, True), _wparam(zw, True)
        colsum = None
    K = x.shape[-1]
    if pre is not None and pre.dlut is not None:
        prod = _delta_prod(qx, qw, pre, signed=False)
    else:
        prod = ops.approx_matmul(qx, qw, cfg.design, cfg.backend, cfg.rank)
    if cfg.compensate:
        mu_r, mu_c, mu = _site_comp_tables(pre, cfg, False, x.device)
        comp = (mu_r[qx.long()].sum(-1, keepdim=True)
                + mu_c[qw.long()].sum(0, keepdim=True)
                - K * mu)
        prod = prod - comp
    rowsum = qx.sum(-1, keepdim=True).float()
    if colsum is None:
        colsum = qw.to(torch.int32).sum(0, keepdim=True).float()
    y = prod - zw * rowsum - zx * colsum + K * zx * zw
    return y * (sx * sw)


def _qdot_signed(x, w, cfg, pre=None):
    """Symmetric int8 path: Q_x (x)_signed Q_w, no zero-point terms."""
    if _use_fused(cfg, pre):
        return _qdot_fused(x, pre, cfg, signed=True)
    if pre is not None and pre.act_scale is not None:
        qx, sx, _ = _quantize_act_static(x, pre, -128, 127)
    else:
        qx, sx = quantize_int8(x, _act_axis(x, cfg))
    if pre is not None and pre.q is not None:
        qw, sw = pre.q, _wparam(pre.scale, pre.per_channel)
    else:
        qw, sw = quantize_int8(w, _weight_axis(w, cfg.w_per_channel))
        if cfg.w_per_channel:
            sw = _wparam(sw, True)
    K = x.shape[-1]
    if pre is not None and pre.dlut is not None:
        prod = _delta_prod(qx, qw, pre, signed=True)
    else:
        prod = ops.approx_matmul(qx, qw, cfg.design, cfg.backend, cfg.rank,
                                 signed=True)
    if cfg.compensate:
        mu_r, mu_c, mu = _site_comp_tables(pre, cfg, True, x.device)
        comp = (mu_r[qx.long() + 128].sum(-1, keepdim=True)
                + mu_c[qw.long() + 128].sum(0, keepdim=True)
                - K * mu)
        prod = prod - comp
    return prod * (sx * sw)


def _bcast_col(p, lead, n: int):
    """Broadcast a cached weight-quant parameter to an explicit
    per-column (..., 1, n) table."""
    if p is None:
        return None
    return torch.broadcast_to(p.reshape(*lead, 1, -1), (*lead, 1, n))


def _merge_group(parts, name: str):
    """Concatenate a group of prequantized same-input projections into one
    QuantizedWeight along the output axis, or return None when the group
    is not safely mergeable.  Per-column epilogue parameters keep each
    member's values on its own column block, so the merged output equals
    the separate calls per column."""
    if not all(isinstance(p, QuantizedWeight) and p.q is not None
               for p in parts):
        return None
    lead = tuple(int(d) for d in parts[0].w.shape[:-2])
    K = parts[0].w.shape[-2]
    if any(p.mode != parts[0].mode or tuple(p.w.shape[:-2]) != lead
           or p.w.shape[-2] != K for p in parts):
        return None
    # the members consume the SAME activations, so calibrated static
    # quantizers must agree: refuse a tree where they do not
    acts = [p.act_scale for p in parts]
    if any((a is None) != (acts[0] is None) for a in acts):
        return None
    if acts[0] is not None and not all(torch.equal(a, acts[0])
                                       for a in acts[1:]):
        return None
    # per-layer design plans: mergeable only when every member gathers
    # the same delta table on every layer (one table per fused call)
    if any(p.dlut is not None for p in parts):
        if any(p.dlut is None or p.dlut_bank is None for p in parts):
            return None
        for li in range(int(np.prod(lead)) if lead else 1):
            tabs = [get_dlut_bank(p.dlut_bank, p.w.device)[
                int(p.dlut.reshape(-1)[li])] for p in parts]
            if not all(torch.equal(t, tabs[0]) for t in tabs[1:]):
                return None
    ns = [int(p.w.shape[-1]) for p in parts]
    comp_cols = [p.comp_col for p in parts]
    merged_comp_col = (torch.cat(comp_cols, -1)
                       if all(c is not None for c in comp_cols) else None)
    prefix = parts[0].path.rsplit(".", 1)[0] if "." in parts[0].path else ""
    base = parts[0]
    return QuantizedWeight(
        w=torch.cat([p.w for p in parts], -1),
        q=torch.cat([p.q for p in parts], -1),
        scale=torch.cat([_bcast_col(p.scale, lead, n)
                         for p, n in zip(parts, ns)], -1),
        zp=(torch.cat([_bcast_col(p.zp, lead, n)
                       for p, n in zip(parts, ns)], -1)
            if base.zp is not None else None),
        colsum=(torch.cat([p.colsum for p in parts], -1)
                if base.colsum is not None else None),
        act_scale=base.act_scale, act_zp=base.act_zp,
        dlut=base.dlut, dlut_bank=base.dlut_bank,
        comp_r=base.comp_r, comp_c=base.comp_c, comp_mu=base.comp_mu,
        comp_col=merged_comp_col, mode=base.mode,
        path=(prefix + "." if prefix else "") + name,
        per_channel=True, merged=True)


def fuse_projections(params):
    """Serving-time projection merging over the decoder units: attention
    wq|wk|wv -> wqkv and mlp w_gate|w_up -> w_gateup, concatenated along
    the output axis (7 qdot calls per layer become 4).  Groups that are
    not safely mergeable are left untouched (among them plan layers
    whose members gather different tables), and so are the MoE dicts'
    expert stacks and the mLSTM block's wq|wk|wv.  The reference merges
    the latter too (its merge takes any dict with wq, wk and wv), and its
    mLSTM then reads a wq that is gone (KeyError: 'wq'), so a fused
    xlstm serve of the reference fails; here the block keeps its three
    projections, and a fused serve equals the reference's
    --no-fuse-proj serve.  Apply after prequantize -> calibrate -> plan
    -> comp cols (launch.serve does, unless --no-fuse-proj)."""
    def visit(node):
        if isinstance(node, dict):
            node = {k: visit(v) for k, v in node.items()}
            if "router" in node:          # MoE dict: expert stacks stay
                return node
            if "wi" in node and "wf" in node:   # an mLSTM (or sLSTM) block
                return node
            if all(k in node for k in ("wq", "wk", "wv")):
                m = _merge_group([node["wq"], node["wk"], node["wv"]],
                                 "wqkv")
                if m is not None:
                    node = {k: v for k, v in node.items()
                            if k not in ("wq", "wk", "wv")}
                    node["wqkv"] = m
            if "w_gate" in node and "w_up" in node:
                m = _merge_group([node["w_gate"], node["w_up"]],
                                 "w_gateup")
                if m is not None:
                    node = {k: v for k, v in node.items()
                            if k not in ("w_gate", "w_up")}
                    node["w_gateup"] = m
            return node
        if isinstance(node, (list, tuple)):
            return type(node)(visit(v) for v in node)
        return node

    out = dict(params)
    out["units"] = visit(params["units"])
    return out


def qeinsum_heads(x: torch.Tensor, w: torch.Tensor,
                  cfg: QuantConfig) -> torch.Tensor:
    """Batched per-head projection: x (..., K) @ w (H, K, D) -> (..., H, D).

    Implemented as a single qdot against w reshaped to (K, H*D) so the
    approximate product is applied uniformly.
    """
    H, K, D = w.shape
    y = qdot(x, w.permute(1, 0, 2).reshape(K, H * D), cfg)
    return y.reshape(*x.shape[:-1], H, D)
