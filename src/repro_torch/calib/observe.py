"""Calibration runner: named observers over the model's qdot call sites.

``Observer`` hooks ``quant.linear.qdot`` (via ``set_observer``) and
records, per call site, the activation range (min/max/amax) plus 256-bin
histograms of the quantized activation and weight operands.  Sites are
named by the weight's params-tree path plus the layer index the decoder
loop pushes: ``units.0.attn.wq@3`` is layer 3 of unit-slot 0's query
projection; an MoE layer pushes the expert index after it
(``units.0.moe.w_up@3.5``: expert 5 of layer 3).  The output is a ``CalibrationTable`` in the reference's
JSON, so tables move freely between the two packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from ..device import resolve
from ..quant import linear as qlin
from ..quant.quantize import QuantConfig


def site_key(path: str, idx) -> str:
    """Canonical site name: tree path + layer indices ('p@i.j'; bare path
    for weights outside any stacked loop)."""
    idx = tuple(idx)
    return path if not idx else path + "@" + ".".join(str(i) for i in idx)


def _new_site():
    return {"lo": np.inf, "hi": -np.inf, "amax": 0.0, "count": 0,
            "hist_x": np.zeros(256, np.int64), "hist_w": None,
            "w_shape": None}


class Observer:
    """Accumulates per-site activation/weight statistics across batches
    (deterministic: pure reductions in a fixed traversal order)."""

    def __init__(self, qcfg: QuantConfig):
        self.qcfg = qcfg
        self.sites: Dict[str, dict] = {}
        self._idx: list = []

    def push(self, i: int) -> None:
        self._idx.append(i)

    def pop(self) -> None:
        self._idx.pop()

    def record(self, x, pre, cfg: QuantConfig) -> None:
        key = site_key(pre.path, self._idx)
        s = self.sites.setdefault(key, _new_site())
        xnp = x.detach().to("cpu", torch.float64).numpy().reshape(-1)
        s["lo"] = min(s["lo"], float(xnp.min()))
        s["hi"] = max(s["hi"], float(xnp.max()))
        s["amax"] = max(s["amax"], float(np.abs(xnp).max()))
        s["count"] += int(xnp.size)
        s["hist_x"] += np.bincount(self._quantize(xnp, cfg), minlength=256)
        if s["hist_w"] is None:
            s["w_shape"] = tuple(int(d) for d in pre.w.shape[-2:])
            if pre.q is not None:
                # counted where the weights live (an expert's slice
                # holds up to 59M entries at full width)
                qw = pre.q.reshape(-1).to(torch.int64)
                if cfg.signed:
                    qw = qw + 128
                s["hist_w"] = torch.bincount(qw, minlength=256).cpu() \
                    .numpy()
            else:
                qw = self._quantize(
                    pre.w.detach().to("cpu", torch.float64).numpy()
                    .reshape(-1), cfg, shift=False)
                if cfg.signed:
                    qw = qw + 128
                s["hist_w"] = np.bincount(qw, minlength=256)

    def _quantize(self, v: np.ndarray, cfg: QuantConfig,
                  shift: bool = True) -> np.ndarray:
        """Batch-dynamic quantization to the 256-entry index grid (what
        qdot does per call)."""
        if cfg.signed:
            scale = max(float(np.abs(v).max()) / 127.0, 1e-8)
            q = np.clip(np.round(v / scale), -128, 127).astype(np.int64)
            return q + 128 if shift else q
        lo, hi = float(v.min()), float(v.max())
        scale = max((hi - lo) / 255.0, 1e-8)
        zp = float(np.clip(np.round(-lo / scale), 0, 255))
        return np.clip(np.round(v / scale) + zp, 0, 255).astype(np.int64)

    def table(self) -> "CalibrationTable":
        return CalibrationTable(mode=self.qcfg.mode,
                                sites={k: dict(v) for k, v in
                                       sorted(self.sites.items())})


@dataclasses.dataclass
class CalibrationTable:
    """Per-site calibration statistics + the static quantizers they fix.

    mode: the QuantConfig.mode the table was observed under."""
    mode: str
    sites: Dict[str, dict]

    def act_quant(self, key: str):
        """The static activation quantizer for a site: (scale, zp) for
        asym_u8 (min/max), (scale, None) for sym_i8 (absmax)."""
        s = self.sites[key]
        if self.mode == "sym_i8":
            return max(s["amax"] / 127.0, 1e-8), None
        scale = max((s["hi"] - s["lo"]) / 255.0, 1e-8)
        zp = float(np.clip(np.round(-s["lo"] / scale), 0, 255))
        return scale, zp

    def merge(self, other: "CalibrationTable") -> "CalibrationTable":
        """Pool the statistics of two tables over the same model."""
        if self.mode != other.mode:
            raise ValueError(f"cannot merge calibration tables of modes "
                             f"{self.mode!r} and {other.mode!r}")
        sites = {k: dict(v) for k, v in self.sites.items()}
        for k, s in other.sites.items():
            if k not in sites:
                sites[k] = dict(s)
                continue
            d = sites[k]
            d["lo"] = min(d["lo"], s["lo"])
            d["hi"] = max(d["hi"], s["hi"])
            d["amax"] = max(d["amax"], s["amax"])
            d["count"] = d["count"] + s["count"]
            d["hist_x"] = np.asarray(d["hist_x"]) + np.asarray(s["hist_x"])
            if d["hist_w"] is None:
                d["hist_w"], d["w_shape"] = s["hist_w"], s["w_shape"]
        return CalibrationTable(mode=self.mode, sites=sites)

    def to_json(self) -> dict:
        sites = {}
        for k, s in self.sites.items():
            sites[k] = {
                "lo": s["lo"], "hi": s["hi"], "amax": s["amax"],
                "count": s["count"],
                "hist_x": np.asarray(s["hist_x"]).tolist(),
                "hist_w": (np.asarray(s["hist_w"]).tolist()
                           if s["hist_w"] is not None else None),
                "w_shape": (list(s["w_shape"]) if s["w_shape"] else None),
            }
        return {"version": 1, "kind": "CalibrationTable", "mode": self.mode,
                "sites": sites}

    @classmethod
    def from_json(cls, d: dict) -> "CalibrationTable":
        sites = {}
        for k, s in d["sites"].items():
            sites[k] = {
                "lo": float(s["lo"]), "hi": float(s["hi"]),
                "amax": float(s["amax"]), "count": int(s["count"]),
                "hist_x": np.asarray(s["hist_x"], np.int64),
                "hist_w": (np.asarray(s["hist_w"], np.int64)
                           if s["hist_w"] is not None else None),
                "w_shape": (tuple(s["w_shape"]) if s["w_shape"] else None),
            }
        return cls(mode=d["mode"], sites=sites)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh)

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


@contextlib.contextmanager
def observing(obs: Observer):
    """Install obs as THE process qdot observer for the duration."""
    qlin.set_observer(obs)
    try:
        yield obs
    finally:
        qlin.set_observer(None)


def calibrate(pparams, cfg, qcfg: QuantConfig, batches,
              device="cuda") -> CalibrationTable:
    """Training-shaped calibration: run forward_train over ``batches``
    (dicts of tokens/labels arrays, as configs.make_smoke_batch makes
    them) with the observer installed, and return the table.
    ``pparams`` must be prequantized (quant.prequantize_weights) so
    sites carry tree-path names."""
    from ..models import transformer as T
    dev = resolve(device)
    obs = Observer(qcfg)
    with observing(obs), torch.no_grad():
        for batch in batches:
            T.forward_train(pparams, {k: torch.as_tensor(np.asarray(v),
                                                         device=dev)
                                      for k, v in batch.items()}, cfg, qcfg)
    return obs.table()


def calibrate_decode(pparams, cfg, qcfg: QuantConfig, prompts,
                     gen_len: int = 0, device="cuda",
                     enc_frontend=None) -> CalibrationTable:
    """Decode-shaped calibration: feed ``prompts`` (B, P) int32 token by
    token (plus ``gen_len`` greedy continuations) through the decode
    step with the observer installed.  An encdec model first runs its
    encoder over ``enc_frontend`` (B, S_enc, frontend_dim or d_model),
    observed too, and every step's cross blocks read its output.
    ``pparams`` must be prequantized (quant.prequantize_weights) so
    sites carry tree-path names."""
    from ..models import transformer as T
    dev = resolve(device)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                              device=dev)
    B, P = prompts.shape
    obs = Observer(qcfg)
    with observing(obs):
        enc_out = None
        if cfg.family == "encdec":
            enc_out = T._run_encoder(
                pparams, torch.as_tensor(np.asarray(enc_frontend),
                                         device=dev), cfg, qcfg)
        state = T.init_decode_state(cfg, B, P + max(gen_len, 1), device=dev,
                                    enc_out=enc_out)
        logits = None
        for i in range(P):
            logits, state = T.forward_decode(pparams, state,
                                             prompts[:, i:i + 1], cfg, qcfg)
        for _ in range(gen_len):
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            logits, state = T.forward_decode(pparams, state, tok, cfg, qcfg)
    return obs.table()
