"""Error metrics for approximate multipliers (paper Eqs. 3, 7, 8)."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .multipliers import exhaustive_products, mult_exact

N = 8
MAX_ED = (2 ** N - 1) ** 2  # (2^n-1)^2, Eq. 8 denominator


def error_surface(fn: Callable) -> np.ndarray:
    """(256,256) signed error  e(a,b) = approx(a,b) - a*b."""
    approx = exhaustive_products(fn)
    exact = exhaustive_products(mult_exact)
    return approx - exact


def multiplier_stats(fn: Callable) -> Dict[str, float]:
    """MED (Eq. 7), NED (Eq. 8), ER, plus max |ED| and RMS ED."""
    e = error_surface(fn)
    abs_e = np.abs(e)
    med = float(abs_e.mean())
    return {
        "MED": med,
        "NED": med / MAX_ED,
        "ER": float((e != 0).mean()),
        "max_ED": float(abs_e.max()),
        "rmse": float(np.sqrt((e.astype(np.float64) ** 2).mean())),
        "mean_signed": float(e.mean()),
    }


def heatmap(fn: Callable) -> np.ndarray:
    """|ED| surface for Fig. 13-style visualization/analysis."""
    return np.abs(error_surface(fn))


def border_error_ratio(fn: Callable, border: int = 32) -> float:
    """Paper Fig. 13 analysis: mean |ED| in the small-operand border
    (a<border or b<border) relative to overall mean |ED|.  >1 means the
    multiplier errs disproportionately on small operands, the failure
    mode of [14,15,20] in the sharpening application."""
    h = heatmap(fn).astype(np.float64)
    mask = np.zeros_like(h, dtype=bool)
    mask[:border, :] = True
    mask[:, :border] = True
    overall = h.mean()
    if overall == 0:
        return 0.0
    return float(h[mask].mean() / overall)
