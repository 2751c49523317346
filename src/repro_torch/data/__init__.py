"""Deterministic, stateless-indexable synthetic token pipeline (numpy
only; the port's own copy of the reference's, byte for byte in what it
yields).

batch(step) is a pure function of (seed, step, shard), so any host can
recompute any shard after a restart with no loader state to checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0


def _tokens_for(cfg: DataConfig, step: int, index: int) -> np.ndarray:
    """One sequence: a reproducible 'language' with local structure
    (Zipf-ish unigram + short-range copy patterns) so losses move."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, index]))
    z = rng.zipf(1.5, size=cfg.seq_len + 1)
    toks = np.minimum(z, cfg.vocab - 1).astype(np.int32)
    # copy structure: with p=.3, a token repeats the one 8 back
    mask = rng.random(cfg.seq_len + 1) < 0.3
    idx = np.arange(cfg.seq_len + 1)
    src = np.maximum(idx - 8, 0)
    return np.where(mask, toks[src], toks)


def host_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """This host's shard of the global batch at ``step`` (stateless)."""
    per_host = cfg.global_batch // cfg.n_hosts
    lo = cfg.host_id * per_host
    seqs = np.stack([_tokens_for(cfg, step, lo + i)
                     for i in range(per_host)])
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield host_batch(cfg, step)
        step += 1
