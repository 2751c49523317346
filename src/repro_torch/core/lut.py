"""256x256 product, error and delta tables of the registered multipliers.

Any 8x8 multiplier is exactly a 256x256 table, generated here from the
gate-level simulation (the single source of truth).  The kernels consume
the delta table ``D[a, b] = approx(a, b) - a*b``: stage 1 of the two-stage
product is the exact integer product, stage 2 gathers D and adds it, so
the sum is bit-exact against the gate level by construction.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np

from .multipliers import MULTIPLIERS, exhaustive_products


@lru_cache(maxsize=None)
def build_lut(name: str) -> np.ndarray:
    """(256,256) int32 product table for a registered multiplier."""
    fn = MULTIPLIERS[name]
    return exhaustive_products(fn).astype(np.int32)


@lru_cache(maxsize=None)
def build_signed_lut(name: str) -> np.ndarray:
    """(256,256) int32 signed product table, indexed [a+128, b+128]."""
    from ..signed.multipliers import (SIGNED_MULTIPLIERS,
                                      exhaustive_signed_products)
    if name not in SIGNED_MULTIPLIERS:
        raise ValueError(
            f"no signed variant of design {name!r}; registered signed "
            f"designs: {sorted(SIGNED_MULTIPLIERS)}")
    return exhaustive_signed_products(SIGNED_MULTIPLIERS[name]).astype(
        np.int32)


@lru_cache(maxsize=None)
def error_table(name: str) -> np.ndarray:
    """(256,256) int32  e(a,b) = approx(a,b) - a*b."""
    exact = np.arange(256, dtype=np.int64)[:, None] * np.arange(256)[None, :]
    return (build_lut(name).astype(np.int64) - exact).astype(np.int32)


@lru_cache(maxsize=None)
def signed_error_table(name: str) -> np.ndarray:
    """(256,256) int32  e(a,b) = approx(a,b) - a*b, indexed [a+128, b+128]."""
    r = np.arange(-128, 128, dtype=np.int64)
    exact = r[:, None] * r[None, :]
    return (build_signed_lut(name).astype(np.int64) - exact).astype(np.int32)


@lru_cache(maxsize=None)
def build_delta_lut(name: str, signed: bool = False) -> np.ndarray:
    """(256,256) delta table  D[i,j] = approx(a,b) - a*b  for the kernels.

    Indexing matches the product tables: D[a, b] unsigned, D[a+128, b+128]
    signed (``signed=True`` resolves ``name`` in SIGNED_MULTIPLIERS).

    dtype is the narrowest that holds the design's error range: int16
    (128 KiB, the size that fits a Hopper block's shared memory beside
    its operand tiles) for every paper design; designs whose error range
    overflows int16 (only the pedagogical 'initial' array, min ED -48744)
    fall back to int32, as the reference keeps them; the CUDA kernels
    take that one as a biased uint16 table (kernels.ops.narrow_delta).
    The round trip is asserted exact either way.
    """
    e = signed_error_table(name) if signed else error_table(name)
    i16 = np.iinfo(np.int16)
    if i16.min <= e.min() and e.max() <= i16.max:
        d = e.astype(np.int16)
    else:
        d = e  # int32 fallback (overflow designs)
    assert (d.astype(np.int64) == e.astype(np.int64)).all(), \
        f"delta LUT narrowing overflowed for design {name!r}"
    return d


def delta_fits_int16(name: str, signed: bool = False) -> bool:
    """Whether the design's delta table packs into int16 (all paper
    designs do; see build_delta_lut)."""
    return build_delta_lut(name, signed).dtype == np.int16


def exact_rank(name: str) -> int:
    """Exact linear-algebra rank of the error surface over the rationals."""
    e = error_table(name).astype(np.float64)
    return int(np.linalg.matrix_rank(e, tol=1e-6))


def _svd_factors(e: np.ndarray, rank: Optional[int]
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    u, s, vt = np.linalg.svd(e, full_matrices=False)
    if rank is None:
        rank = int((s > s[0] * 1e-12).sum()) if s[0] > 0 else 0
    F = u[:, :rank] * s[:rank]
    G = vt[:rank, :]
    resid = float(np.abs(F @ G - e).max()) if rank else float(np.abs(e).max())
    return F.astype(np.float32), G.astype(np.float32), resid


@lru_cache(maxsize=None)
def error_factors(name: str, rank: Optional[int] = None,
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """SVD factorization  e ~= F @ G  with F (256,r), G (r,256) float32.

    Returns (F, G, max_abs_residual).  rank=None takes the exact rank of
    the error surface (the factorization is then exact up to float
    rounding)."""
    return _svd_factors(error_table(name).astype(np.float64), rank)


@lru_cache(maxsize=None)
def signed_error_factors(name: str, rank: Optional[int] = None,
                         ) -> Tuple[np.ndarray, np.ndarray, float]:
    """SVD factors of the SIGNED error surface; rows/cols indexed by the
    offset-shifted operand (a+128), matching build_signed_lut."""
    return _svd_factors(signed_error_table(name).astype(np.float64), rank)


def rank_profile(name: str, tol_meds=(0.0, 0.5, 2.0, 8.0)
                 ) -> Dict[str, object]:
    """How fast the error surface compresses: rank needed for a given mean
    |residual| budget (in output ULPs)."""
    e = error_table(name).astype(np.float64)
    u, s, vt = np.linalg.svd(e, full_matrices=False)
    out = {"exact_rank": int((s > (s[0] if s[0] else 1) * 1e-12).sum())}
    for tol in tol_meds:
        lo = None
        for r in range(0, len(s) + 1):
            resid = u[:, :r] * s[:r] @ vt[:r] - e if r else -e
            if np.abs(resid).mean() <= tol:
                lo = r
                break
        out[f"rank@med<={tol}"] = lo
    return out
