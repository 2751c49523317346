"""16x16 multipliers recomposed from four 8x8 approximate blocks.

With a = AH·2^8 + AL and b = BH·2^8 + BL (AH/AL etc. unsigned bytes):

    a·b = (AH·BH) << 16  +  (AH·BL + AL·BH) << 8  +  AL·BL

Each of the four 8x8 block products goes through a *configurable*
registered unsigned design (core.multipliers.MULTIPLIERS), which is the
classic accuracy/speed knob: the high-high block dominates the output
magnitude, so "exact HH + approximate low blocks" buys most of the area
saving at a fraction of the error.  Signed 16x16 variants wrap the
unsigned recomposition in sign-magnitude (|int16| <= 2^15 fits the
17-bit-free unsigned datapath).

Block products are evaluated through the 256x256 LUTs (core.lut), which
are bit-exact vs the gate-level cores, so the recomposed multipliers are
bit-exact models of the composed hardware.

``RECOMPOSED`` maps name -> ``Recomposed16`` (callable).  A 16x16
exhaustive sweep is 2^32 products, so error metrics come from a
deterministic sampled sweep (``sampled_stats``) + structured corners.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict

import numpy as np

INT16_MIN, INT16_MAX = -(1 << 15), (1 << 15) - 1
U16_MAX = (1 << 16) - 1


@lru_cache(maxsize=None)
def _table(design: str) -> np.ndarray:
    """(256,256) int64 unsigned product table for a registered design."""
    from ..core import lut as lutmod
    if design == "exact":
        a = np.arange(256, dtype=np.int64)
        return a[:, None] * a[None, :]
    return lutmod.build_lut(design).astype(np.int64)


@dataclass(frozen=True)
class Recomposed16:
    """16x16 multiplier from four 8x8 blocks with per-block designs.

    hh/hl/lh/ll name registered unsigned designs for the AH·BH, AH·BL,
    AL·BH, AL·BL blocks.  ``signed=True`` wraps sign-magnitude int16
    semantics around the unsigned composition.
    """
    hh: str = "exact"
    hl: str = "exact"
    lh: str = "exact"
    ll: str = "exact"
    signed: bool = False

    def _unsigned(self, a, b):
        ah, al = a >> 8, a & 0xFF
        bh, bl = b >> 8, b & 0xFF
        return ((_table(self.hh)[ah, bh] << 16)
                + (_table(self.hl)[ah, bl] << 8)
                + (_table(self.lh)[al, bh] << 8)
                + _table(self.ll)[al, bl])

    def __call__(self, a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        if not self.signed:
            return self._unsigned(a, b)
        sign = np.sign(a) * np.sign(b)
        return sign * self._unsigned(np.abs(a), np.abs(b))

    @property
    def blocks(self) -> Dict[str, str]:
        return {"hh": self.hh, "hl": self.hl, "lh": self.lh, "ll": self.ll}


RECOMPOSED: Dict[str, Recomposed16] = {
    # unsigned 16x16
    "u16_exact": Recomposed16(),
    "u16_design1": Recomposed16("design1", "design1", "design1", "design1"),
    "u16_design2": Recomposed16("design2", "design2", "design2", "design2"),
    "u16_hh_exact": Recomposed16("exact", "design2", "design2", "design2"),
    "u16_ll_only": Recomposed16("exact", "exact", "exact", "design2"),
    # signed (sign-magnitude) 16x16
    "s16_exact": Recomposed16(signed=True),
    "s16_design2": Recomposed16("design2", "design2", "design2", "design2",
                                signed=True),
    "s16_hh_exact": Recomposed16("exact", "design2", "design2", "design2",
                                 signed=True),
}


def sample_operands(name: str, n: int = 1 << 16, seed: int = 0):
    """Deterministic operand sample incl. corners for a registered entry."""
    spec = RECOMPOSED[name]
    rng = np.random.default_rng(seed)
    if spec.signed:
        lo, hi = INT16_MIN, INT16_MAX + 1
        corners = np.array([INT16_MIN, INT16_MIN + 1, -1, 0, 1,
                            255, 256, INT16_MAX], dtype=np.int64)
    else:
        lo, hi = 0, U16_MAX + 1
        corners = np.array([0, 1, 255, 256, 257, 1 << 15, U16_MAX],
                           dtype=np.int64)
    a = rng.integers(lo, hi, n, dtype=np.int64)
    b = rng.integers(lo, hi, n, dtype=np.int64)
    a = np.concatenate([a, corners, corners])
    b = np.concatenate([b, corners[::-1], corners])
    return a, b


def sampled_stats(name: str, n: int = 1 << 16, seed: int = 0
                  ) -> Dict[str, float]:
    """MED/ER/NMED of a recomposed multiplier over a sampled sweep."""
    spec = RECOMPOSED[name]
    a, b = sample_operands(name, n, seed)
    approx = spec(a, b)
    exact = a * b
    e = approx - exact
    abs_e = np.abs(e)
    max_prod = float(1 << 30) if spec.signed else float(U16_MAX) ** 2
    med = float(abs_e.mean())
    return {
        "MED": med,
        "NMED": med / max_prod,
        "ER": float((e != 0).mean()),
        "max_ED": float(abs_e.max()),
        "mean_signed": float(e.mean()),
        "n_samples": float(a.size),
    }
