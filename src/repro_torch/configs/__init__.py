"""Architecture configs: the ``ArchConfig`` dataclass and the registry.

``get(name)`` returns the full-size config, ``get_smoke(name)`` its
reduced same-family config for CPU tests.  Only the dense family is
served by this package so far (``qwen3-1.7b``).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


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


def canon(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str) -> ArchConfig:
    return importlib.import_module(f"{__name__}.{canon(name)}").CONFIG


def get_smoke(name: str) -> ArchConfig:
    return importlib.import_module(f"{__name__}.{canon(name)}").SMOKE


def make_smoke_batch(cfg: ArchConfig, batch: int = 2, seq: int = 16,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """Random tokens and labels (batch, seq) int32 from a numpy seed, as
    the reference draws them (dense family: no frontend)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(
                np.int32)}
