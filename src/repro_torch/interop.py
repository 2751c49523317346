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
    ``cfg``."""
    dev = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node)).to(dev)

    params = conv(tree)
    wq = params["units"][0]["attn"]["wq"]
    want = (cfg.n_units, cfg.d_model, cfg.n_heads * cfg.hd)
    if tuple(wq.shape) != want:
        raise ValueError(f"params do not match {cfg.name}: "
                         f"units.0.attn.wq is {tuple(wq.shape)}, "
                         f"expected {want}")
    return params


def table_from_json(src: str) -> CalibrationTable:
    """A CalibrationTable from either package's JSON: a path to the
    file, or the JSON text itself."""
    if os.path.exists(src):
        return CalibrationTable.load(src)
    return CalibrationTable.from_json(json.loads(src))
