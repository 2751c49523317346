"""Architecture configs: the ``ArchConfig`` dataclass and the registry.

``get(name)`` returns the full-size config, ``get_smoke(name)`` its
reduced same-family config for CPU tests.  ``ARCHS`` lists the configs
this package serves: every config of the reference (the dense, MoE,
hybrid and ssm families, the encoder-decoder whisper-small and the VLM
internvl2-76b).  ``SHAPES`` is the reference's input-shape grid,
``supported_cells(name)`` the (arch x shape) cells a config runs and
``input_specs(cfg, shape)`` meta-tensor stand-ins for a cell's inputs
(launch.dryrun).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the ported configs, one module each (dense, moe, hybrid, ssm, encdec,
# vlm)
ARCHS = ("qwen3_1_7b", "gemma_7b", "minitron_8b", "nemotron_4_340b",
         "mixtral_8x7b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
         "xlstm_125m", "whisper_small", "internvl2_76b")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp_kind: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window size (None = full)
    n_experts: int = 0
    top_k: int = 0
    shared_expert_ff: int = 0
    pattern: Tuple[str, ...] = ("attn",)
    d_rnn: int = 0
    enc_layers: int = 0
    enc_seq: int = 0
    frontend_dim: int = 0
    n_prefix: int = 0
    max_seq: int = 32768
    sub_quadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_units(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError((self.name, self.n_layers, self.pattern))
        return self.n_layers // len(self.pattern)

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.n_heads * self.hd + 2 * d * self.n_kv * self.hd \
            + self.n_heads * self.hd * d

    def _mlp_params(self) -> int:
        glu = self.mlp_kind in ("geglu", "swiglu")
        return self.d_model * self.d_ff * (3 if glu else 2)

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline math), as the
        reference counts it."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        att, mlp = self._attn_params(), self._mlp_params()
        per_layer = 0.0
        for kind in self.pattern:
            if kind == "attn":
                per_layer += att + (mlp if f else 0)
            elif kind == "moe":
                per_layer += att + self.n_experts * mlp \
                    + (d * self.shared_expert_ff * 3
                       if self.shared_expert_ff else 0)
            elif kind == "rec":
                per_layer += 3 * d * self.d_rnn + self.d_rnn * d \
                    + (mlp if f else 0)
            elif kind in ("mlstm", "slstm"):
                per_layer += (4 * d * d) if kind == "mlstm" else (5 * d * d)
        total = per_layer / len(self.pattern) * self.n_layers + v * d
        if self.enc_layers:
            total += self.enc_layers * (att + mlp) + att * self.enc_layers
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        per_layer = self._attn_params() + self.top_k * self._mlp_params() \
            + (d * self.shared_expert_ff * 3 if self.shared_expert_ff else 0)
        return int(per_layer * self.n_layers + self.vocab * d)


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str) -> ArchConfig:
    return importlib.import_module(f"{__name__}.{canon(name)}").CONFIG


def get_smoke(name: str) -> ArchConfig:
    return importlib.import_module(f"{__name__}.{canon(name)}").SMOKE


# shape grid: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, tuple] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def supported_cells(name: str):
    """The (arch x shape) cells this arch runs (long_500k needs
    sub-quadratic mixing)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if get(name).sub_quadratic:
        cells.append("long_500k")
    return cells


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins (shape and dtype, no storage) for every model
    input of this cell, as the reference's ShapeDtypeStructs: 'train' and
    'prefill' take the full sequence, 'decode' one new token against a
    seq_len-deep cache or state.  whisper's sequence is clamped to its
    positional capacity of 448 and its frontend is its 1,500 encoder
    frames; the VLM's prefix patches come with train and prefill only."""
    seq, batch, kind = SHAPES[shape_name]
    if cfg.family == "encdec":
        seq = min(seq, 448)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {"tokens": spec((batch, seq if kind != "decode" else 1),
                            torch.int32)}
    if kind == "train":
        specs["labels"] = spec((batch, seq), torch.int32)
    width = cfg.frontend_dim or cfg.d_model
    if cfg.family == "encdec":
        specs["frontend"] = spec((batch, 1500, width), torch.float32)
    if cfg.family == "vlm" and kind != "decode":
        specs["frontend"] = spec((batch, cfg.n_prefix, width), torch.float32)
    return specs


def make_smoke_batch(cfg: ArchConfig, batch: int = 2, seq: int = 16,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Random tokens and labels (batch, seq) int32 from a numpy seed, as
    the reference draws them, then from the same rng the stub frontend's
    float32 embeddings: (batch, 8, frontend_dim or d_model) encoder
    frames for encdec, (batch, n_prefix, ...) prefix patches for vlm."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(
             np.int32),
         "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(
             np.int32)}
    width = cfg.frontend_dim or cfg.d_model
    if cfg.family == "encdec":
        b["frontend"] = rng.normal(size=(batch, 8, width)).astype(
            np.float32)
    if cfg.family == "vlm":
        b["frontend"] = rng.normal(size=(batch, cfg.n_prefix, width)
                                   ).astype(np.float32)
    return b
