"""Bit-exact 8x8 column-compression multipliers (exact + approximate).

A multiplier is a pure function ``f(a, b) -> product`` over integer arrays
(vectorized numpy).  Internally each is a column-compression
dataflow:

  phase 1: partial-product generation  pp[i+j] += bit_j(a) & bit_i(b)
  phase 2: Stage #1 — one level of (in)exact compressors
  phase 3: Stage #2 — multicolumn inexact cells (low cols, cout->cin
           chained) + ripple-carry adder (high cols) -> final bits.

The paper's Design #1 (Fig. 8(d)) and Design #2 (Fig. 10(f)) merge phases
2+3 into exactly two hardware stages; the code mirrors that structure so
stage count and the cost model derive from the same description.

Figure reconstruction note
--------------------------
The paper gives dot-diagrams (Figs. 7-10) but no netlist; the exact
placement is reconstructed here from the stated constraints ("fewest
possible compressors", "<=3 partial products at Stage #2", the precise
component chain of Fig. 8(c)-(g), truncation of Fig. 10) via exhaustive
search over feasible placements (see tests).  Error statistics of the
reconstruction are validated against the paper's Table 4 values.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from . import compressors as comp

N_BITS = 8
N_COLS = 2 * N_BITS  # product columns 0..15


# ---------------------------------------------------------------------------
# Partial products
# ---------------------------------------------------------------------------

def bits_of(x, n=N_BITS):
    """LSB-first bit planes of an integer array."""
    return [(x >> i) & 1 for i in range(n)]


def partial_products(a, b, truncate_below: int = 0) -> Dict[int, List]:
    """cols[k] = list of bit arrays with weight 2^k (heights 1..8..1).

    ``truncate_below``: columns < this index get no AND gates at all
    (Design #2 truncation strategy, Fig. 10).
    """
    abits, bbits = bits_of(a), bits_of(b)
    cols: Dict[int, List] = {k: [] for k in range(N_COLS + 1)}
    for i in range(N_BITS):
        for j in range(N_BITS):
            if i + j >= truncate_below:
                cols[i + j].append(abits[j] & bbits[i])
    return cols


# ---------------------------------------------------------------------------
# Stage-1 ops
# ---------------------------------------------------------------------------
# Inexact multicolumn cells ("c" suffix = with Cin, consuming one extra bit
# of column k). Each is (fn(a..., b..., [cin]), n_a, n_b, has_cout, has_cin).
_S1_CELLS = {
    "33":  (comp.compressor_332_nocin, 3, 3, True, False),
    "33c": (comp.compressor_332,       3, 3, True, True),
    "23":  (lambda a1, a2, a3, b1, b2: comp.compressor_232(a1, a2, a3, b1, b2, 0), 3, 2, True, False),
    "23c": (comp.compressor_232,       3, 2, True, True),
    "32":  (comp.compressor_322_nocin, 2, 3, True, False),
    "22":  (lambda a1, a2, b1, b2: comp.compressor_222(a1, a2, b1, b2, 0), 2, 2, True, False),
    "22c": (comp.compressor_222,       2, 2, True, True),
    "13":  (lambda a1, a2, a3, b1: comp.compressor_132(a1, a2, a3, b1, 0), 3, 1, False, False),
    "13c": (comp.compressor_132,       3, 1, False, True),
    "12":  (comp.compressor_122_nocin, 2, 1, False, False),
    "12c": (comp.compressor_122,       2, 1, False, True),
}


def _pop(cols, k, n):
    assert len(cols[k]) >= n, f"col {k}: {len(cols[k])} bits, need {n}"
    out = cols[k][:n]
    del cols[k][:n]
    return out


def apply_stage1(cols: Dict[int, List], plan: Sequence[Tuple[str, int]], zero):
    """Apply a Stage-#1 placement plan in-place (one compressor level).

    Ops:
      (<cell>, k)   inexact multicolumn cell at columns (k, k+1)
      ("ha"|"fa", k)  precise half/full adder on column k
      ("c42first", k) exact 4:2, cin=0       (head of the precise chain)
      ("c42", k)      exact 4:2, cin=chain; carry -> held
      ("c42_3", k)    exact 4:2 on 3 pps + held carry, cin=chain
      ("fa_h", k)     FA on 2 pps + held carry; then the chain cout lands @k
      ("ha_h", k)     HA on 1 pp + held carry
    The precise-chain semantics follow Fig. 8(c)-(g): couts ripple via
    `chain` within the cell row; the carry of each 4:2 after the first is
    absorbed by the next precise component ("to avoid sending the output
    carry of the 4:2 compressor in column 11 to the next stage").
    """
    chain = zero
    held = zero
    for op, k in plan:
        if op in _S1_CELLS:
            fn, na, nb, has_cout, has_cin = _S1_CELLS[op]
            a = _pop(cols, k, na + (1 if has_cin else 0))
            b = _pop(cols, k + 1, nb)
            if has_cin:
                cin = a[-1]
                a = a[:-1]
                outs = fn(*a, *b, cin)
            else:
                outs = fn(*a, *b)
            if has_cout:
                s, c, co = outs
                cols[k + 2].append(co)
            else:
                s, c = outs
            cols[k].append(s)
            cols[k + 1].append(c)
        elif op == "ha":
            x = _pop(cols, k, 2)
            s, c = comp.half_adder(*x)
            cols[k].append(s)
            cols[k + 1].append(c)
        elif op == "fa":
            x = _pop(cols, k, 3)
            s, c = comp.full_adder(*x)
            cols[k].append(s)
            cols[k + 1].append(c)
        elif op == "c42first":
            x = _pop(cols, k, 4)
            s, carry, cout = comp.compressor_42_exact(*x, zero)
            cols[k].append(s)
            cols[k + 1].append(carry)   # first carry goes to Stage #2
            chain = cout
        elif op == "c42":
            x = _pop(cols, k, 4)
            s, carry, cout = comp.compressor_42_exact(*x, chain)
            cols[k].append(s)
            held, chain = carry, cout
        elif op == "c42_3":
            x = _pop(cols, k, 3)
            s, carry, cout = comp.compressor_42_exact(*x, held, chain)
            cols[k].append(s)
            held, chain = carry, cout
        elif op == "fa_h":
            x = _pop(cols, k, 2)
            s, c = comp.full_adder(*x, held)
            cols[k].append(s)
            cols[k + 1].append(c)
            cols[k].append(chain)   # residual cout of the previous 4:2
            held, chain = zero, zero
        elif op == "ha_h":
            x = _pop(cols, k, 1)
            s, c = comp.half_adder(x[0], held)
            cols[k].append(s)
            cols[k + 1].append(c)
            held = zero
        else:
            raise ValueError(op)


# ---------------------------------------------------------------------------
# Stage-2: multicolumn inexact cells (low) + RCA (high)
# ---------------------------------------------------------------------------

def apply_stage2(cols: Dict[int, List], zero, cell_pairs: Sequence[int],
                 rca_from: int, drop_msb: bool = False):
    """Stage #2: 3,3:2 cells at (k, k+1) for k in cell_pairs (cout of cell
    k feeds cin of cell k+2), then a ripple-carry adder from `rca_from`.

    Each cell consumes ALL remaining bits of cols k,k+1 (must be <=3 each;
    zero-padded) and yields F_k = Sum, F_{k+1} = Carry.  The last cell's
    cout enters the RCA's least-significant column, which may hold up to
    2 own bits (plus the chain bit).  `drop_msb`: the initial design
    (Fig. 7) has no RCA and structurally outputs F15 = 0.
    """
    F = [zero] * 16
    cout_chain = zero
    for k in cell_pairs:
        a = cols[k] + [zero] * (3 - len(cols[k]))
        b = cols[k + 1] + [zero] * (3 - len(cols[k + 1]))
        assert len(a) == 3 and len(b) == 3, \
            f"stage2 cell @{k}: heights {len(cols[k])},{len(cols[k + 1])}"
        s, c, co = comp.compressor_332(*a, *b, cout_chain)
        F[k], F[k + 1] = s, c
        cols[k], cols[k + 1] = [], []
        cout_chain = co
    if drop_msb:
        F[15] = zero  # Fig. 7: F15 structurally '0'; top cout also dropped
        return F
    # Exact adder over the remaining columns.  The head column may hold up
    # to 3 own bits + the cell-chain cout (gated as FA+HA, see cost model);
    # beyond the head it degenerates to a plain ripple-carry adder.
    carries: List = [cout_chain] if rca_from < 16 else []
    for k in range(rca_from, 16):
        bits = list(cols.get(k, [])) + carries
        cols[k] = []
        carries = []
        while len(bits) > 1:
            if len(bits) >= 3:
                s, c = comp.full_adder(bits[0], bits[1], bits[2])
                bits = bits[3:] + [s]
            else:
                s, c = comp.half_adder(bits[0], bits[1])
                bits = bits[2:] + [s]
            carries.append(c)
        F[k] = bits[0] if bits else zero
    return F


def assemble(F, out_dtype=np.int64):
    out = None
    for k, bit in enumerate(F):
        term = bit.astype(out_dtype) << k
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Concrete designs
# ---------------------------------------------------------------------------

# Stage-1 plan for the proposed designs (reconstructed; see module docstring).
# 8 inexact cells reduce cols 3..9 to <=3; exact 4:2 chain at cols 10..13.
DESIGN1_STAGE1 = [
    ("13c", 3), ("13c", 4), ("13c", 5),
    ("33", 6), ("13", 6),
    ("33c", 7), ("33c", 8), ("13", 9),
    ("c42first", 10), ("c42", 11), ("c42_3", 12), ("fa_h", 13),
]
DESIGN1_CELL_PAIRS = (0, 2, 4, 6, 8)
DESIGN1_RCA_FROM = 10


def mult_design1(a, b):
    """Proposed Design #1 (Fig. 8(d)): 4 precise components at Stage #1."""
    a = np.asarray(a)
    zero = np.zeros(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
    cols = partial_products(a, b)
    apply_stage1(cols, DESIGN1_STAGE1, zero)
    F = apply_stage2(cols, zero, DESIGN1_CELL_PAIRS, DESIGN1_RCA_FROM)
    return assemble(F)


def make_truncated_design(n_trunc: int) -> Callable:
    """Design #1 with the `n_trunc` least-significant columns truncated
    (Fig. 10).  n_trunc=6 is Design #2.  Truncation removes the AND gates
    and every compressor that only fed those columns; stage-1 cells whose
    columns survive are kept, with their plans adjusted to the reduced
    heights (searched; see tests for validity)."""
    plan, pairs, rca_from = _truncated_plan(n_trunc)

    def fn(a, b):
        a = np.asarray(a)
        zero = np.zeros(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
        cols = partial_products(a, b, truncate_below=n_trunc)
        apply_stage1(cols, plan, zero)
        F = apply_stage2(cols, zero, pairs, rca_from)
        return assemble(F)

    fn.__name__ = f"mult_design1_trunc{n_trunc}"
    return fn


def _truncated_plan(n_trunc: int):
    """Stage plans for truncated variants (Fig. 10(a)-(g))."""
    if n_trunc == 0:
        return DESIGN1_STAGE1, DESIGN1_CELL_PAIRS, DESIGN1_RCA_FROM
    _PRECISE = [("c42first", 10), ("c42", 11), ("c42_3", 12), ("fa_h", 13)]
    _CELLS = [("13c", 3), ("13c", 4), ("13c", 5), ("33", 6), ("13", 6),
              ("33c", 7), ("33c", 8), ("13", 9)]
    plans = {
        # Keep Design #1 cells whose a-column survives; pairs shrink with t.
        # Truncated columns contribute nothing (F_k = 0 for k < t).
        1: (_CELLS, (0, 2, 4, 6, 8)),
        2: (_CELLS, (2, 4, 6, 8)),
        3: (_CELLS, (2, 4, 6, 8)),
        4: (_CELLS[1:], (4, 6, 8)),
        5: (_CELLS[2:], (4, 6, 8)),
        6: (_CELLS[3:], (6, 8)),
        # t=7: col 7 keeps all 8 pps but no b-side feeders remain; needs its
        # own arrangement (searched like Design #1's — see module docstring).
        7: ([("33c", 7), ("13c", 7), ("22c", 8), ("13c", 9)], (6, 8)),
    }
    cells, pairs = plans[n_trunc]
    return cells + _PRECISE, pairs, 10


mult_design2 = make_truncated_design(6)


def mult_initial(a, b):
    """The initial all-inexact design (Fig. 7): no precise components,
    Stage-2 cells over every pair, F15 structurally 0."""
    a = np.asarray(a)
    zero = np.zeros(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
    cols = partial_products(a, b)
    plan = [("13c", 3), ("13c", 4), ("13c", 5), ("33", 6), ("13", 6),
            ("33c", 7), ("33c", 8), ("33", 9), ("32", 10), ("23", 12)]
    apply_stage1(cols, plan, zero)
    F = apply_stage2(cols, zero, (0, 2, 4, 6, 8, 10, 12, 14), 16,
                     drop_msb=True)
    return assemble(F)


# ---------------------------------------------------------------------------
# Exact baselines
# ---------------------------------------------------------------------------

def mult_exact(a, b):
    """Behavioural exact product (oracle)."""
    return np.asarray(a, dtype=np.int64) * np.asarray(b, dtype=np.int64)


def mult_dadda(a, b):
    """Structural Dadda multiplier (exact): FA/HA stages 8->6->4->3->2 + RCA.

    Used by the cost model for the Table 3 baseline; functionally equal to
    mult_exact (asserted in tests)."""
    a = np.asarray(a)
    zero = np.zeros(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
    cols = partial_products(a, b)
    for target in (6, 4, 3, 2):
        carries: Dict[int, List] = {k: [] for k in range(N_COLS + 2)}
        for k in range(N_COLS + 1):
            bits = cols[k] + carries[k]  # incl. same-stage carries from k-1
            while len(bits) > target:
                if len(bits) == target + 1:
                    s, c = comp.half_adder(bits[0], bits[1])
                    bits = bits[2:] + [s]
                else:
                    s, c = comp.full_adder(bits[0], bits[1], bits[2])
                    bits = bits[3:] + [s]
                carries[k + 1].append(c)
            cols[k] = bits
            carries[k] = []
    # final two rows -> RCA
    F = [zero] * 16
    carry = zero
    for k in range(16):
        bits = cols.get(k, [])
        if len(bits) == 0:
            F[k], carry = carry, zero
        elif len(bits) == 1:
            F[k], carry = comp.half_adder(bits[0], carry)
        elif len(bits) == 2:
            F[k], carry = comp.full_adder(bits[0], bits[1], carry)
        else:
            raise AssertionError(f"dadda col {k}: {len(bits)} rows left")
    return assemble(F)


# ---------------------------------------------------------------------------
# Competitor approximate multipliers [13..21]
# ---------------------------------------------------------------------------
# Methodology of the references: 8x8 reduction where the approximate 4:2
# compressor replaces exact reduction in every column ([15]-style fully
# approximate designs).  MED/NED of competitors in the paper were
# "extracted from the original papers"; our re-implementations follow
# each reference's published cell, so values are comparable but not
# guaranteed identical.  See EXPERIMENTS.md.

def _hybrid_multiplier(approx_cell, approx_cols=range(0, 15)):
    """Build an 8x8 multiplier: approx 4:2-style reduction in approx_cols,
    exact Dadda elsewhere."""
    approx_cols = set(approx_cols)

    def fn(a, b):
        a = np.asarray(a)
        zero = np.zeros(np.broadcast(a, np.asarray(b)).shape, dtype=np.int64)
        cols = partial_products(a, b)
        # one 4:2 level: reduce every column to <=2 using the cell
        out: Dict[int, List] = {k: [] for k in range(N_COLS + 2)}
        for k in range(N_COLS + 1):
            bits = list(cols[k])
            while len(bits) > 2:
                if k in approx_cols:
                    take = bits[:4] + [zero] * (4 - len(bits[:4]))
                    res = approx_cell(*take)
                    s, c = res[0], res[1]
                    bits = bits[4:] + [s]
                    out[k + 1].append(c)
                else:
                    if len(bits) >= 3:
                        s, c = comp.full_adder(bits[0], bits[1], bits[2])
                        bits = bits[3:] + [s]
                    else:
                        s, c = comp.half_adder(bits[0], bits[1])
                        bits = bits[2:] + [s]
                    out[k + 1].append(c)
            out[k] = bits + out[k]
        # now columns hold <=2 bits + deferred carries; repeat exactly until
        # every column <=2 (carries may have pushed some to 3+)
        cols2 = out
        changed = True
        while changed:
            changed = False
            nxt: Dict[int, List] = {k: [] for k in range(N_COLS + 2)}
            for k in range(N_COLS + 1):
                bits = cols2[k] + nxt[k]
                nxt[k] = []
                while len(bits) > 2:
                    s, c = comp.full_adder(bits[0], bits[1], bits[2])
                    bits = bits[3:] + [s]
                    nxt[k + 1].append(c)
                    changed = True
                cols2[k] = bits
            for k in range(N_COLS + 1):
                cols2[k] = cols2[k] + nxt[k]
                if len(cols2[k]) > 2:
                    changed = True
        F = [zero] * 16
        carry = zero
        for k in range(16):
            bits = cols2.get(k, [])
            if len(bits) == 0:
                F[k], carry = carry, zero
            elif len(bits) == 1:
                F[k], carry = comp.half_adder(bits[0], carry)
            else:
                F[k], carry = comp.full_adder(bits[0], bits[1], carry)
        return assemble(F)

    return fn


def _cell_momeni(x1, x2, x3, x4):
    return comp.compressor_42_momeni(x1, x2, x3, x4)


def _cell_sabetzadeh(x1, x2, x3, x4):
    # [14]: truncates x4
    return comp.compressor_42_sabetzadeh(x1, x2, x3)


def _cell_venkatachalam(x1, x2, x3, x4):
    return comp.compressor_42_venkatachalam(x1, x2, x3, x4)


COMPETITORS: Dict[str, Callable] = {}


def _register_competitors():
    COMPETITORS["momeni15"] = _hybrid_multiplier(_cell_momeni)
    COMPETITORS["sabetzadeh14"] = _hybrid_multiplier(_cell_sabetzadeh)
    COMPETITORS["venkatachalam16"] = _hybrid_multiplier(_cell_venkatachalam)


_register_competitors()


# ---------------------------------------------------------------------------
# Registry + exhaustive evaluation
# ---------------------------------------------------------------------------

MULTIPLIERS: Dict[str, Callable] = {
    "exact": mult_exact,
    "dadda": mult_dadda,
    "initial": mult_initial,
    "design1": mult_design1,
    "design2": mult_design2,
    **{f"design1_trunc{t}": make_truncated_design(t) for t in range(1, 8)},
    **COMPETITORS,
}


def exhaustive_products(fn: Callable) -> np.ndarray:
    """(256,256) table of fn over all operand pairs; fn vectorized."""
    a = np.arange(256, dtype=np.int64)[:, None]
    b = np.arange(256, dtype=np.int64)[None, :]
    A, B = np.broadcast_arrays(a, b)
    return np.asarray(fn(A.copy(), B.copy()), dtype=np.int64)
