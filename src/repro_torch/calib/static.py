"""Static-quantization path: install calibrated activation scales.

``apply_calibration(pparams, table)`` walks a prequantized params tree
and attaches, to every QuantizedWeight, the static activation quantizer
fixed by the calibration table: per-layer (scale, zp) stacked along the
wrapper's leading layer axes.  qdot then quantizes activations with the
fixed scale, and with backend 'fused' the fused kernel takes the whole
projection.  ``attach_comp_cols`` caches the column-compensation sums
the fused kernel's epilogue reads.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant import linear as qlin
from .observe import CalibrationTable, site_key


def _lead_indices(lead):
    return list(np.ndindex(*lead)) if lead else [()]


# -- clipping calibrators ---------------------------------------------------
#
# CalibrationTable stores, besides min/max/absmax, the full 256-bin
# histograms of the QUANTIZED operands.  Reconstructing approximate
# operand values for the bins (bin centres over the site's final
# [lo, hi] / [-amax, amax] span — per-batch dynamic grids pool into one
# span, a documented approximation) makes clipping calibrators a
# drop-in replacement for the minmax act_quant: the 99.9th-percentile
# and MSE-optimal ranges ignore the outlier tail the minmax range is
# hostage to.  Selected by apply_calibration(clip=...) / serve --clip.

CLIP_MODES = ("minmax", "pct999", "mse")


def _hist_values(site: dict, mode: str) -> np.ndarray:
    """Approximate operand value at each histogram bin centre."""
    i = np.arange(256, dtype=np.float64)
    if mode == "sym_i8":
        return (i - 128.0) / 127.0 * site["amax"]
    return site["lo"] + (i + 0.5) * (site["hi"] - site["lo"]) / 256.0


def _quant_mse(v: np.ndarray, p: np.ndarray, mode: str,
               lo_c: float, hi_c: float) -> float:
    """Histogram-weighted MSE of quantizing values ``v`` (mass ``p``)
    with the clip range [lo_c, hi_c] on the mode's 256-entry grid."""
    if mode == "sym_i8":
        scale = max(hi_c / 127.0, 1e-8)
        q = np.clip(np.round(v / scale), -128, 127)
        deq = q * scale
    else:
        scale = max((hi_c - lo_c) / 255.0, 1e-8)
        zp = float(np.clip(np.round(-lo_c / scale), 0, 255))
        q = np.clip(np.round(v / scale) + zp, 0, 255)
        deq = (q - zp) * scale
    return float(p @ np.square(deq - v))


def act_quant_clipped(table: CalibrationTable, key: str,
                      clip: str = "minmax"):
    """The static activation quantizer for a site under a clipping
    policy: (scale, zp) for asym_u8, (scale, None) for sym_i8.

      minmax  the observed extremes (CalibrationTable.act_quant)
      pct999  the tightest range covering 99.9% of the histogram mass
              (0.05% trimmed per tail; |x| percentile for sym_i8)
      mse     the range minimizing histogram-weighted quantization MSE
              over a ladder of symmetric shrinks of the minmax range
    """
    if clip not in CLIP_MODES:
        raise ValueError(f"unknown clip mode {clip!r}; one of {CLIP_MODES}")
    if clip == "minmax":
        return table.act_quant(key)
    s = table.sites[key]
    hist = np.asarray(s["hist_x"], np.float64)
    p = hist / max(hist.sum(), 1.0)
    v = _hist_values(s, table.mode)
    sym = table.mode == "sym_i8"
    if clip == "pct999":
        q = 0.999
        if sym:
            order = np.argsort(np.abs(v))
            cum = np.cumsum(p[order])
            j = int(np.searchsorted(cum, q))
            amax_c = float(np.abs(v)[order][min(j, 255)])
            return max(amax_c / 127.0, 1e-8), None
        cdf = np.cumsum(p)
        lo_j = int(np.searchsorted(cdf, (1.0 - q) / 2.0))
        hi_j = int(np.searchsorted(cdf, 1.0 - (1.0 - q) / 2.0))
        lo_c, hi_c = float(v[min(lo_j, 255)]), float(v[min(hi_j, 255)])
        if hi_c <= lo_c:                      # degenerate histogram
            return table.act_quant(key)
        scale = max((hi_c - lo_c) / 255.0, 1e-8)
        return scale, float(np.clip(np.round(-lo_c / scale), 0, 255))
    # mse: sweep shrinks of the minmax span — absmax ladder for sym,
    # independent per-end shrinks for asym (activation mass is often
    # one-sided, e.g. post-ReLU/SiLU, so the ends must move separately)
    best = None
    if sym:
        for alpha in np.linspace(0.2, 1.0, 33):
            err = _quant_mse(v, p, table.mode, 0.0, alpha * s["amax"])
            if best is None or err < best[0]:
                best = (err, 0.0, alpha * s["amax"])
    else:
        span = s["hi"] - s["lo"]
        for a_lo in np.linspace(0.0, 0.8, 17):
            for a_hi in np.linspace(0.0, 0.8, 17):
                lo_c = s["lo"] + a_lo * span
                hi_c = s["hi"] - a_hi * span
                if hi_c <= lo_c:
                    continue
                err = _quant_mse(v, p, table.mode, lo_c, hi_c)
                if best is None or err < best[0]:
                    best = (err, lo_c, hi_c)
    if best is None:               # degenerate site (lo == hi)
        return table.act_quant(key)
    _, lo_c, hi_c = best
    if sym:
        return max(hi_c / 127.0, 1e-8), None
    scale = max((hi_c - lo_c) / 255.0, 1e-8)
    return scale, float(np.clip(np.round(-lo_c / scale), 0, 255))


def apply_calibration(pparams, table: CalibrationTable, *,
                      strict: bool = True, clip: str = "minmax"):
    """Return a copy of ``pparams`` (a prequantize_weights tree) whose
    QuantizedWeights carry static activation quantizers from ``table``.

    strict=True raises on sites the calibration pass never visited;
    strict=False leaves them dynamic.  ``clip`` selects the range
    calibrator (minmax | pct999 | mse — see act_quant_clipped)."""

    def install(node):
        if node.mode != table.mode:
            raise ValueError(
                f"calibration table was observed under mode "
                f"{table.mode!r} but weights are prequantized for "
                f"{node.mode!r} (site {node.path!r})")
        lead = tuple(int(d) for d in node.w.shape[:-2])
        scales = np.zeros(lead, np.float32)
        zps = np.zeros(lead, np.float32)
        for idx in _lead_indices(lead):
            key = site_key(node.path, idx)
            if key not in table.sites:
                if strict:
                    raise KeyError(
                        f"site {key!r} missing from the calibration "
                        f"table ({len(table.sites)} sites recorded); "
                        f"run more representative batches or pass "
                        f"strict=False to leave it dynamic")
                return node
            s, z = act_quant_clipped(table, key, clip)
            scales[idx] = s
            zps[idx] = 0.0 if z is None else z
        dev = node.w.device
        return node.replace(
            act_scale=torch.from_numpy(scales).to(dev),
            act_zp=(torch.from_numpy(zps).to(dev)
                    if table.mode == "asym_u8" else None))

    return qlin.map_quantized(pparams, install)


def attach_comp_cols(pparams, qcfg):
    """Cache the column-compensation colsum on every prequantized weight
    that carries no per-layer plan tables: ``take(mu_c, q).sum(K)`` for
    the serving design's mean-field table, summed in float64 and rounded
    to float32 as the reference does.  The fused kernel's epilogue then
    reads the cached (..., 1, N) vector.  Plan-installed wrappers (comp_c
    present) are skipped: ``calib.plan.apply_plan`` caches theirs.
    Design-specific: re-run after changing ``QuantConfig.design``.  No-op
    when qcfg.compensate or qcfg.enabled is off."""
    if not (qcfg.enabled and qcfg.compensate):
        return pparams
    _, mu_c, _ = qlin._mean_field_tables(qcfg.design, signed=qcfg.signed)
    off = 128 if qcfg.signed else 0

    def install(node):
        if node.q is None or node.comp_c is not None:
            return node
        mu = torch.from_numpy(mu_c.astype(np.float64)).to(node.q.device)
        lead = tuple(node.q.shape[:-2])
        out = torch.empty((*lead, 1, node.q.shape[-1]), dtype=torch.float32,
                          device=node.q.device)
        for idx in _lead_indices(lead):   # one (K, N) slice at a time
            g = mu[node.q[idx].long() + off]
            out[idx] = g.sum(-2, keepdim=True).to(torch.float32)
        return node.replace(comp_col=out)

    return qlin.map_quantized(pparams, install)



def coverage(pparams, table: CalibrationTable) -> dict:
    """How much of the model the table covers: {sites_expected,
    sites_recorded, missing}."""
    expected = []

    def visit(node):
        lead = tuple(int(d) for d in node.w.shape[:-2])
        expected.extend(site_key(node.path, idx)
                        for idx in _lead_indices(lead))
        return node

    qlin.map_quantized(pparams, visit)
    missing = [k for k in expected if k not in table.sites]
    return {"sites_expected": len(expected),
            "sites_recorded": len(table.sites),
            "missing": missing}
