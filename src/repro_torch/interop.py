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


def _expected_shapes(cfg: ArchConfig, kind: str) -> dict:
    """The stacked shapes a pattern slot of ``kind`` must have, by path
    within the slot's params."""
    L, D, H, hd, E, F = (cfg.n_units, cfg.d_model, cfg.n_heads, cfg.hd,
                         cfg.n_experts, cfg.d_ff)
    want = {}
    if kind in ("attn", "moe"):
        want.update({"attn.wq": (L, D, H * hd),
                     "attn.wk": (L, D, cfg.n_kv * hd),
                     "attn.wo": (L, H * hd, D)})
    if kind == "moe":
        # the reference's MoE tree: router (L, D, E), expert stacks
        # (L, E, K, N), the shared expert a dense MLP
        want.update({"moe.router": (L, D, E), "moe.w_up": (L, E, D, F),
                     "moe.w_down": (L, E, F, D)})
    elif kind == "rec":
        R = cfg.d_rnn
        want.update({"rec.w_in": (L, D, R), "rec.w_gate_x": (L, D, R),
                     "rec.w_gate_a": (L, D, R), "rec.a_param": (L, R),
                     "rec.conv": (L, 4, R), "rec.w_out": (L, R, D)})
    elif kind == "mlstm":
        want.update({f"mlstm.{w}": (L, D, D) for w in ("wq", "wk", "wv",
                                                       "wo")})
        want.update({"mlstm.wi": (L, D, H), "mlstm.wf": (L, D, H),
                     "mlstm.norm": (L, D)})
    elif kind == "slstm":
        want.update({f"slstm.{w}": (L, D, D) for w in ("wz", "wi", "wf",
                                                       "wo_gate", "wo")})
        want["slstm.norm"] = (L, D)
    if kind in ("attn", "rec") and F:
        want.update({"mlp.w_up": (L, D, F), "mlp.w_down": (L, F, D)})
    return want


def _outside_units(cfg: ArchConfig) -> dict:
    """The shapes of the params outside the decoder units, by path: the
    encoder's layers (a stack over enc_layers), its final norm and the
    decoder layers' cross blocks (a stack over n_layers); the frontend
    projection."""
    D, H, Kv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                       cfg.d_ff)
    want = {}
    if cfg.family == "encdec":
        for pre, L in (("enc.layers", cfg.enc_layers),
                       ("enc.cross", cfg.n_layers)):
            want.update({f"{pre}.attn.wq": (L, D, H * hd),
                         f"{pre}.attn.wk": (L, D, Kv * hd),
                         f"{pre}.attn.wv": (L, D, Kv * hd),
                         f"{pre}.attn.wo": (L, H * hd, D)})
        E = cfg.enc_layers
        want.update({"enc.layers.norm1": (E, D), "enc.layers.norm2": (E, D),
                     "enc.layers.mlp.w_up": (E, D, F),
                     "enc.layers.mlp.w_down": (E, F, D),
                     "enc.norm": (D,), "enc.cross.norm": (cfg.n_layers, D)})
        if cfg.mlp_kind in ("geglu", "swiglu"):
            want["enc.layers.mlp.w_gate"] = (E, D, F)
    if cfg.frontend_dim and cfg.frontend_dim != D:
        want["frontend_proj"] = (cfg.frontend_dim, D)
    return want


def _check_shapes(root, want: dict, cfg: ArchConfig, prefix: str) -> None:
    for path, shape in want.items():
        leaf = root
        for k in path.split("."):
            if k not in leaf:
                raise ValueError(f"params do not match {cfg.name}: "
                                 f"{prefix}{path} is missing")
            leaf = leaf[k]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"params do not match {cfg.name}: "
                             f"{prefix}{path} is {tuple(leaf.shape)}, "
                             f"expected {shape}")


def params_from_numpy(tree, cfg: ArchConfig, device="cuda"):
    """The reference's params tree (numpy leaves) as the port's params
    (tensors on ``device``), checking the stacked layer shapes against
    ``cfg``: one unit per pattern slot, and in each the projections of
    its kind (attention; the MoE router, expert stacks and shared
    expert; the RG-LRU's, mLSTM's and sLSTM's kernels, gates, conv and
    norm gains; the MLP of an attention or recurrent block); the
    encoder's layers, norm and cross blocks, and the frontend
    projection, where the config has them."""
    dev = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node)).to(dev)

    params = conv(tree)
    units = params["units"]
    if len(units) != len(cfg.pattern):
        raise ValueError(f"params do not match {cfg.name}: {len(units)} "
                         f"units, expected one per slot of {cfg.pattern}")
    L, D, E, F = cfg.n_units, cfg.d_model, cfg.n_experts, cfg.d_ff
    for slot, kind in enumerate(cfg.pattern):
        unit = units[slot]
        want = _expected_shapes(cfg, kind)
        glu = cfg.mlp_kind in ("geglu", "swiglu")
        if "mlp" in want and glu:
            want["mlp.w_gate"] = (L, D, F)
        if kind == "moe":
            Fs = cfg.shared_expert_ff
            if "w_gate" in unit["moe"]:
                want["moe.w_gate"] = (L, E, D, F)
            if "shared" in unit["moe"]:
                want.update({"moe.shared.w_up": (L, D, Fs),
                             "moe.shared.w_down": (L, Fs, D)})
                if "w_gate" in unit["moe"]["shared"]:
                    want["moe.shared.w_gate"] = (L, D, Fs)
        _check_shapes(unit, want, cfg, f"units.{slot}.")
    _check_shapes(params, _outside_units(cfg), cfg, "")
    return params


def table_from_json(src: str) -> CalibrationTable:
    """A CalibrationTable from either package's JSON: a path to the
    file, or the JSON text itself."""
    if os.path.exists(src):
        return CalibrationTable.load(src)
    return CalibrationTable.from_json(json.loads(src))
