"""Serving steps (the training half of the reference's train package is
not ported yet)."""
from .step import make_prefill_step, make_serve_step  # noqa: F401
