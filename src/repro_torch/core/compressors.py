"""Bit-exact gate-level compressor models.

Every compressor is a pure function on integer arrays holding {0,1} bits.
They work identically on numpy arrays and torch tensors (only `&`, `|`, `^`,
`~`-free ops are used: XOR/AND/OR via arithmetic-safe bitwise operators).

Conventions
-----------
- Single-column exact cells return (sum, carry[, cout]) with weights
  (2^k, 2^(k+1)[, 2^(k+1)]).
- The proposed multicolumn cells take ``a`` bits from column 2^k and ``b``
  bits from column 2^(k+1) and return (sum, carry, cout) with weights
  (2^k, 2^(k+1), 2^(k+2)) — see Fig. 2 of the paper.
- All functions are vectorized: inputs may be arrays of any (equal) shape.

Gate-level structures follow the paper's figures exactly so that the
cost model (core/cost.py) can count primitives from the same definitions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np

Bits = "array-like of {0,1}"


# ---------------------------------------------------------------------------
# Exact cells
# ---------------------------------------------------------------------------

def half_adder(a, b):
    """HA: sum = a^b, carry = a&b. Cost: 1 XOR, 1 AND."""
    return a ^ b, a & b


def full_adder(a, b, c):
    """FA: sum = a^b^c, carry = majority. Cost: 2 XOR, 2 AND, 1 OR."""
    s = a ^ b ^ c
    carry = (a & b) | (c & (a ^ b))
    return s, carry


def compressor_42_exact(x1, x2, x3, x4, cin):
    """Exact 4:2 compressor built from two chained FAs.

    Returns (sum, carry, cout); carry and cout both weight 2^(k+1).
    cout is independent of cin (no horizontal ripple).
    """
    s1, cout = full_adder(x1, x2, x3)
    s, carry = full_adder(s1, x4, cin)
    return s, carry, cout


def compressor_62_exact(x1, x2, x3, x4, x5, x6, cin1, cin2):
    """Exact 6:2 compressor per Ma & Li [37] (paper Fig. 3).

    Structure: two FAs compress each triple (col k); their sums plus cin1
    feed a third FA; its sum plus cin2 feeds an HA producing the final Sum.
    The carries of the first two FAs feed an HA chain producing Carry and
    two Couts. Exhaustive identity (tested):
        Σin + cin1 + cin2 == sum + 2*(carry + cout1 + cout2) + 4*cout3
    i.e. strictly this classic cell is a 6:2 with 3 carry outputs at 2^(k+1)
    and one at 2^(k+2). We expose exactly that.
    Returns (sum, carry, cout1, cout2, cout3).
    """
    sa, ca = full_adder(x1, x2, x3)
    sb, cb = full_adder(x4, x5, x6)
    s3, cout1 = full_adder(sa, sb, cin1)
    s, cout2 = half_adder(s3, cin2)
    carry, cout3 = half_adder(ca, cb)
    return s, carry, cout1, cout2, cout3


# ---------------------------------------------------------------------------
# Proposed multicolumn inexact compressors (paper Section II + Appendix I)
# ---------------------------------------------------------------------------

def compressor_332(a1, a2, a3, b1, b2, b3, cin):
    """Proposed multicolumn 3,3:2 inexact compressor (paper Fig. 2(b)).

    Inputs: a1..a3 at column 2^k, b1..b3 at column 2^(k+1), cin at 2^k.
    Outputs: (sum @2^k, carry @2^(k+1), cout @2^(k+2)).

    Inner structure (Fig. 2(b)): FA over the a's, FA over the b's, then the
    approximation merges them:
        sum   = sa ^ cin                    (sa = a1^a2^a3)
        carry = ca | sa&cin | sb            (sb = b1^b2^b3)
        cout  = cb                          (cb = maj(b))
    where (sa, ca) = FA(a1,a2,a3), (sb, cb) = FA(b1,b2,b3).

    This reproduces the paper's Table 1 exactly (verified exhaustively in
    tests): ED ∈ {0, −2, −4}, 48/128 rows erroneous, NED_C = 0.08125 with
    max(error) = 3·1 + 3·2 + 1 = 10.
    """
    sa, ca = full_adder(a1, a2, a3)
    sb, cb = full_adder(b1, b2, b3)
    s, c_lo = half_adder(sa, cin)
    carry = ca | c_lo | sb
    cout = cb
    return s, carry, cout


def compressor_222(a1, a2, b1, b2, cin):
    """2,2:2 derivative (Fig. 5(c)): FAs replaced with HAs.

    Inputs: a1,a2 @2^k; b1,b2 @2^(k+1); cin @2^k.
    Outputs: (sum @2^k, carry @2^(k+1), cout @2^(k+2)).
    NED_C = 0.07143 (max error = 2·1 + 2·2 + 1 = 7).
    """
    sa, ca = half_adder(a1, a2)
    sb, cb = half_adder(b1, b2)
    s, c_lo = half_adder(sa, cin)
    carry = ca | c_lo | sb
    cout = cb
    return s, carry, cout


def compressor_332_nocin(a1, a2, a3, b1, b2, b3):
    """3,3:2 without Cin (Appendix I row 2). NED 0.0555."""
    sa, ca = full_adder(a1, a2, a3)
    sb, cb = full_adder(b1, b2, b3)
    carry = ca | sb
    return sa, carry, cb


def compressor_322_nocin(a1, a2, b1, b2, b3):
    """3,2:2 without Cin (Appendix I): 2 bits @2^k, 3 bits @2^(k+1).

    Per the paper's naming '3,2:2' = M_{k+1}=3, M_k=2. NED 0.03125.
    """
    sa, ca = half_adder(a1, a2)
    sb, cb = full_adder(b1, b2, b3)
    carry = ca | sb
    return sa, carry, cb


def compressor_232(a1, a2, a3, b1, b2, cin):
    """2,3:2 (Appendix I): M_{k+1}=2, M_k=3, with Cin. NED 0.10156."""
    sa, ca = full_adder(a1, a2, a3)
    sb, cb = half_adder(b1, b2)
    s, c_lo = half_adder(sa, cin)
    carry = ca | c_lo | sb
    cout = cb
    return s, carry, cout


def compressor_132(a1, a2, a3, b1, cin):
    """1,3:2 (Appendix I): 3 bits @2^k, 1 bit @2^(k+1), Cin. NED 0.13542.

    Single b bit: sb = b1, cb = 0 — cout would always be 0, so the cell
    returns only (sum, carry).
    """
    sa, ca = full_adder(a1, a2, a3)
    s, c_lo = half_adder(sa, cin)
    carry = ca | c_lo | b1
    return s, carry


def compressor_122(a1, a2, b1, cin):
    """1,2:2 (Appendix I): 2 bits @2^k, 1 bit @2^(k+1), Cin. NED 0.1."""
    sa, ca = half_adder(a1, a2)
    s, c_lo = half_adder(sa, cin)
    carry = ca | c_lo | b1
    return s, carry


def compressor_122_nocin(a1, a2, b1):
    """1,2:2 without Cin (Appendix I). NED 0.0625."""
    sa, ca = half_adder(a1, a2)
    carry = ca | b1
    return sa, carry


# ---------------------------------------------------------------------------
# Inexact 4:2 competitor compressors [14..21] used inside competitor
# multipliers (Section IV comparisons).
# ---------------------------------------------------------------------------

def compressor_42_momeni(x1, x2, x3, x4):
    """Momeni et al. [15] approximate 4:2 (design 2, carry-free form).

    Published value table (carry, sum): sum=0 -> (0,1) [ED +1!],
    sum=1 -> (0,1), sum=2 -> (1,0), sum=3 -> (1,1), sum=4 -> (1,1) [ED -1].
    The +1 error at the ALL-ZERO input is what makes [15]'s multiplier
    fail on small operands (paper Fig. 13: dark top/left border, ruined
    sharpened images, SSIM ~1e-6)."""
    s1 = x1 ^ x2
    s2 = x3 ^ x4
    or4 = x1 | x2 | x3 | x4
    and4 = x1 & x2 & x3 & x4
    s = (s1 ^ s2) | (1 - or4) | and4
    carry = (x1 & x2) | (x3 & x4) | (s1 & s2)
    return s, carry


def compressor_42_sabetzadeh(x1, x2, x3):
    """Sabetzadeh et al. [14] majority-based imprecise 4:2 — truncates one
    input (x4) entirely; carry = maj(x1,x2,x3), sum = x1|x2|x3 approx."""
    carry = (x1 & x2) | (x1 & x3) | (x2 & x3)
    s = x1 | x2 | x3
    return s, carry


def compressor_42_venkatachalam(x1, x2, x3, x4):
    """Venkatachalam & Ko [16] approximate 4:2 (no carries):
        sum = (x1^x2) | (x3^x4);  carry = (x1&x2) | (x3&x4).
    Errs for Σx ∈ {2 (both pairs split? no), 4}. NED 0.078125."""
    s = (x1 ^ x2) | (x3 ^ x4)
    carry = (x1 & x2) | (x3 & x4)
    return s, carry


def compressor_42_strollo(x1, x2, x3, x4, cin):
    """Strollo et al. [19] c1 compressor — nearly exact 4:2; single error
    row. We model it as exact 4:2 with the one published deviation:
    when x1=x2=x3=x4=1, (sum,carry,cout) = (1,1,1) i.e. 7 instead of 4+cin.
    To keep ED small we use their published: error only at all-ones,
    output encodes 5+cin vs exact 4+cin → ED = -1... The exact published
    table errs 2/32 with ED=±1. Simplified faithful-NED model below.
    """
    s, carry, cout = compressor_42_exact(x1, x2, x3, x4, cin)
    allones = x1 & x2 & x3 & x4
    # inject +1 on sum when all ones (ED = -1 on 2 of 32 rows)
    s = s | allones
    return s, carry, cout


REGISTRY: Dict[str, Callable] = {
    "ha": half_adder,
    "fa": full_adder,
    "4:2-exact": compressor_42_exact,
    "6:2-exact": compressor_62_exact,
    "3,3:2": compressor_332,
    "2,2:2": compressor_222,
    "3,3:2-nocin": compressor_332_nocin,
    "3,2:2-nocin": compressor_322_nocin,
    "2,3:2": compressor_232,
    "1,3:2": compressor_132,
    "1,2:2": compressor_122,
    "1,2:2-nocin": compressor_122_nocin,
}


# ---------------------------------------------------------------------------
# Truth-table + error characterization (paper Table 1 / Eq. 1-6)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CompressorSpec:
    """Weights metadata for error analysis of a multicolumn compressor."""
    name: str
    in_weights: Tuple[int, ...]    # weight of each input bit (incl. cin)
    out_weights: Tuple[int, ...]   # weight of each output bit


SPECS: Dict[str, CompressorSpec] = {
    "3,3:2": CompressorSpec("3,3:2", (1, 1, 1, 2, 2, 2, 1), (1, 2, 4)),
    "2,2:2": CompressorSpec("2,2:2", (1, 1, 2, 2, 1), (1, 2, 4)),
    "3,3:2-nocin": CompressorSpec("3,3:2-nocin", (1, 1, 1, 2, 2, 2), (1, 2, 4)),
    "3,2:2-nocin": CompressorSpec("3,2:2-nocin", (1, 1, 2, 2, 2), (1, 2, 4)),
    "2,3:2": CompressorSpec("2,3:2", (1, 1, 1, 2, 2, 1), (1, 2, 4)),
    "1,3:2": CompressorSpec("1,3:2", (1, 1, 1, 2, 1), (1, 2)),
    "1,2:2": CompressorSpec("1,2:2", (1, 1, 2, 1), (1, 2)),
    "1,2:2-nocin": CompressorSpec("1,2:2-nocin", (1, 1, 2), (1, 2)),
}

_FN_ARG_ORDER = {
    # maps spec name -> function + the order its args map onto in_weights
    "3,3:2": compressor_332,
    "2,2:2": compressor_222,
    "3,3:2-nocin": compressor_332_nocin,
    "3,2:2-nocin": lambda a1, a2, b1, b2, b3: compressor_322_nocin(a1, a2, b1, b2, b3),
    "2,3:2": compressor_232,
    "1,3:2": compressor_132,
    "1,2:2": compressor_122,
    "1,2:2-nocin": compressor_122_nocin,
}


def truth_table(name: str) -> np.ndarray:
    """Exhaustive truth table of an inexact multicolumn compressor.

    Returns an array of rows
    ``[in_bits..., out_bits..., exact_value, inexact_value, ED]``
    with ED = inexact − exact, matching the sign convention actually used
    in the paper's Table 1 (which prints −2/−4; Eq. 3 as written would
    give the opposite sign).
    """
    spec = SPECS[name]
    fn = _FN_ARG_ORDER[name]
    n_in = len(spec.in_weights)
    rows = []
    for pattern in range(2 ** n_in):
        bits = [(pattern >> i) & 1 for i in range(n_in)]
        outs = fn(*[np.asarray(b) for b in bits])
        outs = [int(o) for o in outs]
        exact = sum(b * w for b, w in zip(bits, spec.in_weights))
        inexact = sum(o * w for o, w in zip(outs, spec.out_weights))
        rows.append(bits + outs + [exact, inexact, inexact - exact])
    return np.array(rows, dtype=np.int64)


def compressor_stats(name: str) -> Dict[str, float]:
    """MED_C, NED_C (Eq. 5-6), error-rate over the uniform input space."""
    spec = SPECS[name]
    tt = truth_table(name)
    ed = tt[:, -1]
    med = float(np.mean(np.abs(ed)))
    max_err = float(sum(spec.in_weights))  # Σ M_i 2^i + P, cin counted in weights
    ned = med / max_err
    er = float(np.mean(ed != 0))
    return {"MED_C": med, "NED_C": ned, "ER": er, "max_error": max_err}
