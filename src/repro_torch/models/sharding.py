"""Logical sharding annotations for model internals.

Models call ``constrain(x, *axes)`` with *logical* axis names where the
reference calls its ``with_sharding_constraint`` wrapper; the launcher
activates a mapping from logical names to mesh axes
(``logical_axis_rules``).

On one card every mesh axis has size 1, so a constraint decides a
placement and moves nothing: ``constrain`` returns its argument itself
(no copy, no launch), and ``constrain_spec`` gives the spec the
reference would pass to ``with_sharding_constraint`` for a shape, with
the same divisibility drop, for a multi-card port or an analysis of
the production meshes (launch.dryrun) to read.

Logical axes:
  "batch"   -> ("pod", "data")   (pod axis also folds into data for DP)
  "seq"     -> None (replicated) or "data" for sequence parallelism
  "heads"/"ffn"/"vocab"/"experts"/"kv" -> "model" (tensor/expert parallel)
  "layers"  -> "pod" when pipeline-style layer sharding is active
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

_state = threading.local()

Spec = Tuple[object, ...]


def _rules() -> Optional[Dict[str, Optional[Tuple[str, ...]]]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_axis_rules(rules: Dict[str, Optional[Tuple[str, ...]]],
                       axis_sizes: Optional[Dict[str, int]] = None):
    """Activate logical->mesh axis mapping (launcher only).

    axis_sizes: mesh axis name -> size; when provided, constraints on
    dims not divisible by the mapped axes are dropped (lets e.g. 8
    experts stay replicated on a 16-wide model axis)."""
    prev = (_rules(), getattr(_state, "sizes", None))
    _state.rules = rules
    _state.sizes = axis_sizes
    try:
        yield
    finally:
        _state.rules, _state.sizes = prev


# Default production mapping (see launch/mesh.py).
PRODUCTION_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    # Megatron-style sequence parallelism: the residual stream between
    # blocks shards its seq axis over "model"; attention/mixing gathers.
    "seq_shard": ("model",),
    "heads": ("model",),
    "kv": None,                  # kv heads usually < model-axis size
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_cap": ("data",),
    "embed": None,
    "layers": None,
}

SINGLE_POD_RULES = dict(PRODUCTION_RULES, batch=("data",))


@contextlib.contextmanager
def remat_scope(on: bool = True):
    """The reference's per-layer rematerialization flag, thread-local as
    there, kept for a multi-card port.  Nothing in the port reads it:
    forward_train / make_loss_fn take remat as an explicit argument."""
    prev = getattr(_state, "remat", False)
    _state.remat = on
    try:
        yield
    finally:
        _state.remat = prev


def remat_active() -> bool:
    return getattr(_state, "remat", False)


def constrain_spec(shape, *logical_axes: Optional[str]) -> Optional[Spec]:
    """The spec ``constrain`` stands for on a tensor of ``shape``: one
    entry a dim, None (replicated), a mesh axis name, or a tuple of
    names.  None when no rules are active (the reference then leaves
    the tensor alone).  Constraints on dims not divisible by the mapped
    mesh axes are dropped, as the reference drops them."""
    rules = _rules()
    if rules is None:
        return None
    sizes = getattr(_state, "sizes", None)
    spec = []
    for dim, ax in zip(shape, logical_axes):
        m = rules.get(ax) if ax is not None else None
        if not m:
            spec.append(None)
            continue
        if sizes is not None:
            total = 1
            for a in m:
                total *= sizes.get(a, 1)
            if total <= 1 or dim % total != 0:
                spec.append(None)
                continue
        spec.append(m[0] if len(m) == 1 else tuple(m))
    return tuple(spec)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's sharding constraint by logical axis names, at its
    call sites.  On one card it is ``x`` itself: every mesh axis has
    size 1, so the spec (constrain_spec(x.shape, *logical_axes))
    places nothing."""
    return x
