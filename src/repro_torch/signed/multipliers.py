"""Signed int8 x int8 variants of the paper's 8x8 multipliers.

Two derivation strategies, both reusing the unsigned gate-level cores as
the single source of truth:

1. **Sign-magnitude** (``sign_magnitude``): the signed product is
   ``sgn(a)·sgn(b) · U(|a|, |b|)`` where U is any registered unsigned
   core.  |−128| = 128 fits the 8-bit unsigned datapath (the cores accept
   any value in [0, 255]).  Hardware-wise this is the XOR-sign wrapper
   around the unsigned array; error-wise it mirrors the unsigned error
   surface into all four quadrants.

2. **Sign-focused Baugh-Wooley** (``mult_bw_design1``): a two's-complement
   partial-product array in Baugh-Wooley form (sign-row/column bits
   complemented, +2^8 and +2^15 correction constants), reduced with the
   SAME two-stage structure as the paper's Design #1 — multicolumn 3,3:2
   inexact compressor cells (core.compressors) in the low columns, the
   exact 4:2 chain + RCA in the sign-carrying high columns.  This is the
   "sign-focused" split of Krishna et al. (arXiv:2510.22674): magnitude
   columns tolerate the inexact cells, sign-propagating columns stay
   exact.  The 16-bit output is interpreted as two's complement.

``SIGNED_MULTIPLIERS`` mirrors ``core.multipliers.MULTIPLIERS`` (same
design names resolve in both, so a ``QuantConfig.design`` string selects
either the unsigned or signed variant depending on the quant mode).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..core import compressors as comp
from ..core.multipliers import (
    DESIGN1_CELL_PAIRS, DESIGN1_RCA_FROM, DESIGN1_STAGE1, MULTIPLIERS,
    N_BITS, N_COLS, apply_stage1, apply_stage2, assemble, bits_of,
    mult_design1, mult_design2, mult_initial)

INT8_MIN, INT8_MAX = -128, 127


# ---------------------------------------------------------------------------
# Strategy 1: sign-magnitude around the unsigned cores
# ---------------------------------------------------------------------------

def sign_magnitude(core_fn: Callable) -> Callable:
    """Signed multiplier from an unsigned core: sgn(a)sgn(b)·U(|a|,|b|)."""

    def fn(a, b):
        a = np.asarray(a, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        sign = np.sign(a) * np.sign(b)
        return sign * np.asarray(core_fn(np.abs(a), np.abs(b)),
                                 dtype=np.int64)

    fn.__name__ = f"signed_sm_{getattr(core_fn, '__name__', 'core')}"
    return fn


def mult_exact_signed(a, b):
    """Behavioural exact signed product (oracle)."""
    return np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64)


# ---------------------------------------------------------------------------
# Strategy 2: Baugh-Wooley array + Design-#1-style two-stage reduction
# ---------------------------------------------------------------------------

def partial_products_bw(a, b) -> Dict[int, List]:
    """Baugh-Wooley two's-complement partial-product columns for 8x8.

    With a = -a7·2^7 + Σ a_i 2^i (same for b):

        a·b = Σ_{i,j<7} a_i b_j 2^{i+j}
            + Σ_{j<7} ¬(a7 b_j) 2^{7+j}  + Σ_{i<7} ¬(a_i b7) 2^{7+i}
            + a7 b7 2^14 + 2^8 + 2^15                      (mod 2^16)

    using -t·2^k ≡ ¬t·2^k + 2^k - 2^{k+?} algebra folded into the two
    correction constants.  Column heights: cols 0..7 as unsigned, col 8
    gains the +2^8 constant (height 8), col 15 holds the +2^15 constant.
    """
    a = np.asarray(a)
    abits, bbits = bits_of(a), bits_of(b)
    one = np.ones(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
    cols: Dict[int, List] = {k: [] for k in range(N_COLS + 1)}
    for i in range(N_BITS - 1):
        for j in range(N_BITS - 1):
            cols[i + j].append(abits[j] & bbits[i])
    for j in range(N_BITS - 1):
        cols[7 + j].append(1 - (abits[j] & bbits[7]))   # ¬(a_j b7)
        cols[7 + j].append(1 - (abits[7] & bbits[j]))   # ¬(a7 b_j)
    cols[14].append(abits[7] & bbits[7])
    cols[8].append(one)
    cols[15].append(one)
    return cols


def twos_complement16(r):
    """Interpret a 16-bit (mod 2^16) result as signed two's complement."""
    r = np.asarray(r, dtype=np.int64) & 0xFFFF
    return r - ((r >> 15) << 16)


# Design-#1 Stage-1 plan adapted to the BW heights: col 8 carries one
# extra bit (the +2^8 constant) so an HA drains it after the 3,3:2 cell,
# and the col-9 cell takes a Cin to absorb the extra carry.
BW_DESIGN1_STAGE1 = [
    ("13c", 3), ("13c", 4), ("13c", 5),
    ("33", 6), ("13", 6),
    ("33c", 7), ("33c", 8), ("ha", 8), ("13c", 9),
    ("c42first", 10), ("c42", 11), ("c42_3", 12), ("fa_h", 13),
]
BW_CELL_PAIRS = DESIGN1_CELL_PAIRS   # 3,3:2 cells on magnitude cols 0..9
BW_RCA_FROM = DESIGN1_RCA_FROM       # exact adder over sign cols 10..15


def mult_bw_design1(a, b):
    """Sign-focused BW multiplier: Design-#1 reduction of the BW array."""
    a = np.asarray(a)
    zero = np.zeros(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
    cols = partial_products_bw(a, b)
    apply_stage1(cols, BW_DESIGN1_STAGE1, zero)
    F = apply_stage2(cols, zero, BW_CELL_PAIRS, BW_RCA_FROM)
    return twos_complement16(assemble(F))


def mult_bw_exact(a, b):
    """Exact reduction of the BW array (validates the array itself)."""
    a = np.asarray(a)
    cols = partial_products_bw(a, b)
    total = np.zeros(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
    for k, bits in cols.items():
        for bit in bits:
            total = total + (np.asarray(bit, dtype=np.int64) << k)
    return twos_complement16(total)


# ---------------------------------------------------------------------------
# Registry + exhaustive evaluation
# ---------------------------------------------------------------------------

SIGNED_MULTIPLIERS: Dict[str, Callable] = {
    "exact": mult_exact_signed,
    "initial": sign_magnitude(mult_initial),
    "design1": sign_magnitude(mult_design1),
    "design2": sign_magnitude(mult_design2),
    "design1_trunc4": sign_magnitude(MULTIPLIERS["design1_trunc4"]),
    "bw_exact": mult_bw_exact,
    "bw_design1": mult_bw_design1,
}


def exhaustive_signed_products(fn: Callable) -> np.ndarray:
    """(256,256) table of fn over all int8 pairs, indexed [a+128, b+128]."""
    a = np.arange(INT8_MIN, INT8_MAX + 1, dtype=np.int64)[:, None]
    b = np.arange(INT8_MIN, INT8_MAX + 1, dtype=np.int64)[None, :]
    A, B = np.broadcast_arrays(a, b)
    return np.asarray(fn(A.copy(), B.copy()), dtype=np.int64)


MAX_ED_SIGNED = 2 ** (N_BITS - 1) * 2 ** (N_BITS - 1)  # |(-128)·(-128)|


def signed_multiplier_stats(name_or_fn) -> Dict[str, float]:
    """MED/ER/NMED over the exhaustive signed sweep (65,536 pairs)."""
    fn = (SIGNED_MULTIPLIERS[name_or_fn]
          if isinstance(name_or_fn, str) else name_or_fn)
    approx = exhaustive_signed_products(fn)
    exact = exhaustive_signed_products(mult_exact_signed)
    e = approx - exact
    abs_e = np.abs(e)
    med = float(abs_e.mean())
    return {
        "MED": med,
        "NMED": med / MAX_ED_SIGNED,
        "ER": float((e != 0).mean()),
        "max_ED": float(abs_e.max()),
        "mean_signed": float(e.mean()),
    }
