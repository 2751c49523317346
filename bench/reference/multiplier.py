"""The paper's Design #2 8x8 approximate multiplier, gate by gate.

A frozen copy of the column-compression arithmetic that defines the
multiplier (partial products with the 6 least-significant columns
truncated, one stage of inexact 3,3:2 / 1,3:2 cells beside an exact 4:2
chain, then 3,3:2 cells and a ripple-carry adder), so that the
benchmark's reference builds the product table without the program.
"""
from __future__ import annotations

import numpy as np


def _ha(a, b):
    return a ^ b, a & b


def _fa(a, b, c):
    return a ^ b ^ c, (a & b) | (c & (a ^ b))


def _c42(x1, x2, x3, x4, cin):
    s1, cout = _fa(x1, x2, x3)
    s, carry = _fa(s1, x4, cin)
    return s, carry, cout


def _c332(a1, a2, a3, b1, b2, b3, cin):
    sa, ca = _fa(a1, a2, a3)
    sb, cb = _fa(b1, b2, b3)
    s, c_lo = _ha(sa, cin)
    return s, ca | c_lo | sb, cb


def _c332_nocin(a1, a2, a3, b1, b2, b3):
    sa, ca = _fa(a1, a2, a3)
    sb, cb = _fa(b1, b2, b3)
    return sa, ca | sb, cb


def _c132(a1, a2, a3, b1, cin):
    sa, ca = _fa(a1, a2, a3)
    s, c_lo = _ha(sa, cin)
    return s, ca | c_lo | b1


def _take(cols, k, n):
    out = cols[k][:n]
    if len(out) != n:
        raise ValueError(f"column {k} holds {len(cols[k])} bits, needs {n}")
    del cols[k][:n]
    return out


def design2(a, b) -> np.ndarray:
    """The Design #2 product of uint8 arrays ``a`` and ``b`` (int64)."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    zero = np.zeros(np.broadcast(a, b).shape, np.int64)
    abits = [(a >> i) & 1 for i in range(8)]
    bbits = [(b >> i) & 1 for i in range(8)]
    cols = {k: [] for k in range(17)}
    for i in range(8):
        for j in range(8):
            if i + j >= 6:                    # columns 0-5 truncated
                cols[i + j].append(abits[j] & bbits[i])
    # stage 1: inexact multicolumn cells on columns 6-10
    s, c, co = _c332_nocin(*_take(cols, 6, 3), *_take(cols, 7, 3))
    cols[6].append(s), cols[7].append(c), cols[8].append(co)
    s, c = _c132(*_take(cols, 6, 3), *_take(cols, 7, 1), zero)
    cols[6].append(s), cols[7].append(c)
    for k in (7, 8):                          # 3,3:2 with carry-in
        x = _take(cols, k, 4)
        s, c, co = _c332(*x[:3], *_take(cols, k + 1, 3), x[3])
        cols[k].append(s), cols[k + 1].append(c), cols[k + 2].append(co)
    x = _take(cols, 9, 3)
    s, c = _c132(*x, *_take(cols, 10, 1), zero)
    cols[9].append(s), cols[10].append(c)
    # stage 1: the exact 4:2 chain on columns 10-13
    s, carry, chain = _c42(*_take(cols, 10, 4), zero)
    cols[10].append(s), cols[11].append(carry)
    s, held, chain = _c42(*_take(cols, 11, 4), chain)
    cols[11].append(s)
    s, held, chain = _c42(*_take(cols, 12, 3), held, chain)
    cols[12].append(s)
    s, c = _fa(*_take(cols, 13, 2), held)
    cols[13].append(s), cols[14].append(c), cols[13].append(chain)
    # stage 2: 3,3:2 cells on (6, 7) and (8, 9), then a ripple-carry adder
    F = [zero] * 16
    chain = zero
    for k in (6, 8):
        lo = cols[k] + [zero] * (3 - len(cols[k]))
        hi = cols[k + 1] + [zero] * (3 - len(cols[k + 1]))
        F[k], F[k + 1], chain = _c332(*lo, *hi, chain)
        cols[k], cols[k + 1] = [], []
    carries = [chain]
    for k in range(10, 16):
        bits = cols[k] + carries
        carries = []
        while len(bits) > 1:
            if len(bits) >= 3:
                s, c = _fa(*bits[:3])
                bits = bits[3:] + [s]
            else:
                s, c = _ha(*bits[:2])
                bits = bits[2:] + [s]
            carries.append(c)
        F[k] = bits[0] if bits else zero
    return sum(bit << k for k, bit in enumerate(F))


def product_table() -> np.ndarray:
    """(256, 256) int64: design2(a, b) at [a, b]."""
    r = np.arange(256, dtype=np.int64)
    return design2(r[:, None], r[None, :])
