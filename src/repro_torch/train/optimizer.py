"""AdamW with global-norm clipping and int8 gradient compression with
error feedback.

Plain tensor trees (nested dicts and lists), as the reference's pytrees.
The arithmetic is float32 in the reference's order: ``step`` is an int32
0-dim tensor, and ``step / warmup`` and ``b1 ** step`` are evaluated in
float32, as JAX's weak typing evaluates them.  Leaves are walked in the
order of ``jax.tree.leaves`` (dict keys sorted), which fixes the order of
the ``gnorm`` sum.  Divisions by a scalar go through a same-device 0-dim
tensor (``device.true_div``), never a multiply by the reciprocal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..device import true_div


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_clip: float = 1.0
    compress_grads: bool = False   # int8 compression + error feedback


class OptState(NamedTuple):
    step: torch.Tensor        # int32, 0-dim
    mu: Dict
    nu: Dict
    err: Optional[Dict]       # error-feedback residual (compress_grads)


def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and the same positions of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, lists
    in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are ``leaves``, given in
    tree_leaves order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(tree)


def init(params, cfg: OptConfig) -> OptState:
    dev = tree_leaves(params)[0].device

    def zeros(p):
        # a factory, not zeros_like: on meta params (launch.dryrun) an op
        # on a meta tensor first loads torch's reference decompositions
        return torch.zeros(p.shape, dtype=p.dtype, device=p.device)
    err = tree_map(zeros, params) if cfg.compress_grads else None
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params), err)


def lr_schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of cfg.lr (float32)."""
    warm = torch.clamp_max(true_div(step.float(),
                                    float(max(cfg.warmup_steps, 1))), 1.0)
    prog = torch.clamp(
        true_div((step - cfg.warmup_steps).float(),
                 float(max(cfg.total_steps - cfg.warmup_steps, 1))),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Symmetric int8 quantization of g + err with error feedback;
    returns (dequantized gradient, new residual).  Emulates a compressed
    gradient all-reduce: the residual is fed back next step so the bias
    does not accumulate.  ``err`` is updated in place (it becomes the new
    residual)."""
    gc = err.add_(g)
    scale = true_div(torch.clamp_min(torch.amax(torch.abs(gc)), 1e-12), 127.0)
    deq = torch.clamp(torch.round(gc / scale), -127, 127).mul_(scale)
    return deq, gc.sub_(deq)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (jax.tree.leaves order) of g . g."""
    total = None
    for g in tree_leaves(grads):
        d = torch.dot(g.reshape(-1), g.reshape(-1))
        total = d if total is None else total + d
    return torch.sqrt(total)


@torch.no_grad()
def apply(params, grads, state: OptState, cfg: OptConfig
          ) -> Tuple[Dict, OptState]:
    """One AdamW step; returns (params, state).

    IN PLACE: the params, the moments, the error-feedback residual and
    the grads are updated in their own storage (the reference returns
    new arrays and its launcher donates the old ones).  At full width a
    copy would double the 1.7B-parameter model's ~27.5 GiB of weights
    and moments.  Every op keeps the reference's float32 order; the
    in-place forms round exactly as the out-of-place ones."""
    step = state.step + 1
    if cfg.compress_grads:
        deq = [_compress_int8(g, e)[0] for g, e
               in zip(tree_leaves(grads), tree_leaves(state.err))]
    else:
        deq = tree_leaves(grads)
    gnorm = global_norm(deq)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    clip = torch.clamp_max(cfg.grad_clip * one
                           / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    c1 = 1 - torch.pow(b1 * one, sf)
    c2 = 1 - torch.pow(b2 * one, sf)
    for p, g, m, v in zip(tree_leaves(params), deq, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        g = g.mul_(clip)
        m.mul_(b1).add_((1 - b1) * g)               # b1*m + (1-b1)*g
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        mh = m / c1
        den = torch.sqrt(v / c2).add_(cfg.eps)
        upd = mh.div_(den).add_(cfg.weight_decay * p)
        p.sub_(upd.mul_(lr))                        # p - lr * (...)
    return params, OptState(step, state.mu, state.nu, state.err)
