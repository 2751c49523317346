"""The paper's gate-level 3,3:2 compressors, the multiplier registry,
the 256x256 tables derived from them, their error metrics and the
unit-gate cost model (plain numpy)."""
from . import compressors, cost, lut, metrics, multipliers  # noqa: F401

__all__ = ["compressors", "multipliers", "metrics", "cost", "lut"]
