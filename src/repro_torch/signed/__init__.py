"""Signed int8 x int8 variants of the multipliers (the ``sym_i8`` mode)."""
from . import multipliers  # noqa: F401
from .multipliers import SIGNED_MULTIPLIERS  # noqa: F401

__all__ = ["multipliers", "SIGNED_MULTIPLIERS"]
