"""Carry the JAX package's params and calibration tables into the port.

``jax.random`` cannot be replayed in torch, so holding the port against
the reference needs the reference's own weights: a test converts them
with ``jax.tree.map(np.asarray, params)`` (nested dicts and lists of
numpy arrays) and hands the tree to ``params_from_numpy``.
Calibration tables share one JSON format in both packages.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .calib.observe import CalibrationTable
from .configs import ArchConfig
from .device import resolve


def params_from_numpy(tree, cfg: ArchConfig, device="cuda"):
    """The reference's params tree (numpy leaves) as the port's params
    (tensors on ``device``), checking the stacked layer shapes against
    ``cfg``: the query projection, and for an MoE block the router, the
    expert stacks and the shared expert."""
    dev = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node)).to(dev)

    params = conv(tree)
    L, D, E, F = cfg.n_units, cfg.d_model, cfg.n_experts, cfg.d_ff
    unit = params["units"][0]
    want = {"attn.wq": (L, D, cfg.n_heads * cfg.hd)}
    if "moe" in unit:
        # the reference's MoE tree: router (L, D, E), expert stacks
        # (L, E, K, N), the shared expert a dense MLP
        Fs = cfg.shared_expert_ff
        want.update({"moe.router": (L, D, E), "moe.w_up": (L, E, D, F),
                     "moe.w_down": (L, E, F, D)})
        if "w_gate" in unit["moe"]:
            want["moe.w_gate"] = (L, E, D, F)
        if "shared" in unit["moe"]:
            want.update({"moe.shared.w_up": (L, D, Fs),
                         "moe.shared.w_down": (L, Fs, D)})
            if "w_gate" in unit["moe"]["shared"]:
                want["moe.shared.w_gate"] = (L, D, Fs)
    for path, shape in want.items():
        leaf = unit
        for k in path.split("."):
            leaf = leaf[k]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"params do not match {cfg.name}: "
                             f"units.0.{path} is {tuple(leaf.shape)}, "
                             f"expected {shape}")
    return params


def table_from_json(src: str) -> CalibrationTable:
    """A CalibrationTable from either package's JSON: a path to the
    file, or the JSON text itself."""
    if os.path.exists(src):
        return CalibrationTable.load(src)
    return CalibrationTable.from_json(json.loads(src))
