"""Signed int8 x int8 variants of the multipliers (the ``sym_i8`` mode)
and 16x16 multipliers recomposed from four 8x8 blocks (``recompose``)."""
from . import multipliers, recompose  # noqa: F401
from .multipliers import SIGNED_MULTIPLIERS  # noqa: F401
from .recompose import RECOMPOSED  # noqa: F401

__all__ = ["multipliers", "recompose", "SIGNED_MULTIPLIERS", "RECOMPOSED"]
