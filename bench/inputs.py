"""The benchmark's inputs, made from the seed: the weights (drawn on the
device in one call a stacked leaf, in the program's params layout), the
prompts of every round, the calibration prompts and the train batches.
Both the program and the reference are handed these."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .arith import head_dim

# The serving ladder's calibration prompts: --calibrate 1 draws 4 x 64
# token ids from numpy's default_rng(4242), whatever the traffic.
CALIB_SEED, CALIB_REQUESTS, CALIB_PROMPT_LEN = 4242, 4, 64


def draw_params(m: Dict, seed: int, device) -> Dict:
    """Random weights of the model ``m`` (a config file's ``model``): dense
    kernels N(0, 1/fan_in), the embedding N(0, 0.02^2),
    norm gains 1, stacked over the layers, in the program's tree
    (``{"embed", "final_norm", "units": [unit]}``)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    L, D, H, Kv = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv"]
    hd, F = head_dim(m), m["d_ff"]

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=dev)
        return w.mul_(std)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    unit = {"norm1": ones(L, D),
            "attn": {"wq": normal((L, D, H * hd), D ** -0.5),
                     "wk": normal((L, D, Kv * hd), D ** -0.5),
                     "wv": normal((L, D, Kv * hd), D ** -0.5),
                     "wo": normal((L, H * hd, D), (H * hd) ** -0.5)},
            "norm2": ones(L, D)}
    glu = m["mlp_kind"] in ("swiglu", "geglu")
    mlp = {"w_up": normal((L, D, F), 1.0 / math.sqrt(D)),
           "w_down": normal((L, F, D), 1.0 / math.sqrt(F))}
    if glu:
        mlp["w_gate"] = normal((L, D, F), 1.0 / math.sqrt(D))
    unit["mlp"] = mlp
    return {"embed": normal((m["vocab"], D), 0.02),
            "final_norm": ones(D), "units": [unit]}


def round_prompts(m: Dict, seed: int, rounds: int, batch: int,
                  prompt_len: int) -> np.ndarray:
    """(rounds, batch, prompt_len) int32 token ids, uniform over the
    vocabulary."""
    rng = np.random.default_rng([int(seed), 1])
    return rng.integers(0, m["vocab"], (rounds, batch, prompt_len)) \
        .astype(np.int32)


def calibration_prompts(m: Dict) -> np.ndarray:
    rng = np.random.default_rng(CALIB_SEED)
    return rng.integers(0, m["vocab"], (CALIB_REQUESTS, CALIB_PROMPT_LEN)) \
        .astype(np.int32)


def sample_index(seed: int, n: int) -> int:
    """Which of n finished rounds the reference checks."""
    return int(np.random.default_rng([int(seed), 2]).integers(0, n))
