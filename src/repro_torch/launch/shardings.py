"""Parameter/optimizer/cache sharding policy (TP x FSDP) for the
production mesh.

Policy (MaxText-style, path+shape driven), the reference's rule for rule:
  * tensor-parallel ("model") axis: ffn / heads / vocab / experts;
  * FSDP ("data" [+ "pod"]) axis: one more large axis of every big
    weight, so params+grads+opt state all scale 1/N_chips;
  * small tensors (norms, routers, scalars) replicate;
  * axes only shard when divisible by the mesh axis size (else replicate
    that axis) — keeps every config lowerable on any mesh.

The same policy shards optimizer state (same shape as params) and, for
serving, KV caches (batch -> data, feature -> model).

A spec is a tuple with one entry a dim: None (replicated), a mesh axis
name, or a tuple of names, which is what the reference's PartitionSpec
holds.  On one card (launch.mesh.make_host_mesh) every axis has size 1,
so every spec is all None: the functions decide placements and nothing
is moved.  On the production meshes they say what each device would
hold (launch.dryrun's per-device argument bytes).
"""
from __future__ import annotations

import re
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..train.optimizer import OptState
from .mesh import Mesh, data_axes, mesh_axis_sizes

Spec = Tuple[object, ...]

# (path regex, spec builder) — first match wins. Specs name LOGICAL roles;
# axis indices are resolved against the actual rank (stacked layer dims).
_RULES = [
    (r"moe/(w_up|w_gate|w_down)$", ("expert",)),   # before generic w_* !
    (r"embed$",            ("vocab_d",)),
    (r"frontend_proj$",    ("last_model",)),
    (r"(wq|wk|wv|w_gate|w_up|wz|wi|wf|wo_gate|w_in|w_gate_x|w_gate_a)$",
                           ("last_model",)),
    (r"(wo|w_down|w_out)$", ("m2_model",)),
    (r"router$",           ("rep",)),
    (r"(norm|a_param|conv|q_norm|k_norm)", ("rep",)),
]


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0 and dim >= size


def param_spec(path: str, shape, mesh: Mesh) -> Spec:
    sizes = mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    fsdp_axes = data_axes(mesh)
    fsdp = int(np.prod([sizes[a] for a in fsdp_axes]))
    fsdp_name = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    rank = len(shape)
    spec = [None] * rank

    kind = None
    for pat, (k,) in _RULES:
        if re.search(pat, path):
            kind = k
            break
    if kind in (None, "rep") or rank == 0:
        return tuple(spec)

    if kind == "vocab_d":           # (vocab, d)
        if _fits(shape[0], model):
            spec[0] = "model"
        if rank > 1 and _fits(shape[1], fsdp):
            spec[1] = fsdp_name
    elif kind == "expert":          # (n_units, E, d, f) or (E, d, f)
        e_ax = rank - 3
        if _fits(shape[e_ax], model):
            spec[e_ax] = "model"     # expert parallelism
        elif _fits(shape[rank - 1], model):
            spec[rank - 1] = "model"  # E < axis: TP inside each expert
        if _fits(shape[rank - 2], fsdp):
            spec[rank - 2] = fsdp_name
    elif kind == "last_model":      # (..., d_in, d_out): TP on out, FSDP in
        if _fits(shape[-1], model):
            spec[-1] = "model"
        if rank >= 2 and _fits(shape[-2], fsdp):
            spec[-2] = fsdp_name
    elif kind == "m2_model":        # (..., d_in, d_out): TP on in, FSDP out
        if rank >= 2 and _fits(shape[-2], model):
            spec[-2] = "model"
        if _fits(shape[-1], fsdp):
            spec[-1] = fsdp_name
    return tuple(spec)


def tree_paths(tree, prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) of every tensor leaf, in jax.tree.leaves order (dict
    keys sorted), the path as the reference's ``_path_str`` writes a
    jax key path: dict keys and list indices joined by "/", an OptState
    field as its attribute key prints (".mu/units/0/attn/wq")."""
    if isinstance(tree, OptState):
        for name in tree._fields:
            yield from tree_paths(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _map_with_path(fn, tree, prefix: Tuple[str, ...] = ()):
    """fn(path, leaf) over the tensor leaves, keeping the structure (an
    OptState stays one, None stays None)."""
    if isinstance(tree, OptState):
        return OptState(*(_map_with_path(fn, getattr(tree, n),
                                         prefix + (f".{n}",))
                          for n in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def tree_shardings(tree, mesh: Mesh):
    """The spec tree matching ``tree`` (params or an OptState)."""
    return _map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), mesh), tree)


def batch_spec(mesh: Mesh, ndim: int = 2, batch_dim: int = 0,
               batch_size: Optional[int] = None) -> Spec:
    """Shard the batch dim over the data axes; replicate when the global
    batch is not divisible (e.g. long_500k's batch=1)."""
    sizes = mesh_axis_sizes(mesh)
    ax = data_axes(mesh)
    total = int(np.prod([sizes[a] for a in ax]))
    spec = [None] * ndim
    if batch_size is None or _fits(batch_size, total):
        spec[batch_dim] = ax if len(ax) > 1 else ax[0]
    return tuple(spec)


def batch_shardings(specs_tree, mesh: Mesh):
    """batch_spec of every input of a {name: tensor} tree."""
    return {k: batch_spec(mesh, s.dim(), batch_size=s.shape[0])
            for k, s in specs_tree.items()}


def cache_spec(mesh: Mesh, shape) -> Spec:
    """Decode state (KV cache (L, B, S, n_kv, hd), recurrent state (L, B,
    ...)): batch over the data axes; the trailing feature axis over
    'model' (Megatron-style contracted-dim sharding, as the reference
    chose it over sharding the seq axis)."""
    sizes = mesh_axis_sizes(mesh)
    ax = data_axes(mesh)
    lead = ax if len(ax) > 1 else ax[0]
    spec = [None] * len(shape)
    total_data = int(np.prod([sizes[a] for a in ax]))
    # state leaves are stacked over layers: (L, B, ...); batch is axis 1
    b_ax = 1 if len(shape) >= 2 else 0
    if len(shape) > b_ax and _fits(shape[b_ax], total_data):
        spec[b_ax] = lead
    if len(shape) >= 3 and _fits(shape[-1], sizes.get("model", 1)):
        spec[-1] = "model"
    return tuple(spec)


def cache_shardings(state, mesh: Mesh):
    """cache_spec of every leaf of a decode state."""
    return _map_with_path(
        lambda path, leaf: cache_spec(mesh, tuple(leaf.shape)), state)


def spec_ways(spec: Spec, mesh: Mesh) -> int:
    """How many ways ``spec`` splits a tensor: the product of the sizes
    of the mesh axes it names."""
    sizes = mesh_axis_sizes(mesh)
    ways = 1
    for entry in spec:
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            ways *= sizes[name]
    return ways
