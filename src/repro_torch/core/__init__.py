"""The paper's gate-level 3,3:2 compressors, the multiplier registry and
the 256x256 tables derived from them (plain numpy)."""
from . import compressors, lut, multipliers  # noqa: F401

__all__ = ["compressors", "multipliers", "lut"]
