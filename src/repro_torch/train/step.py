"""Serving steps: one batched decode step and the full-sequence prefill."""
from __future__ import annotations

import dataclasses

import torch

from ..configs import ArchConfig
from ..models import transformer as T
from ..quant import QuantConfig


def make_serve_step(cfg: ArchConfig, qcfg: QuantConfig):
    """One batched decode step: (params, state, tokens) -> (next_tok,
    logits, state), greedy sampling included."""
    def serve_step(params, state, tokens):
        logits, state = T.forward_decode(params, state, tokens, cfg, qcfg)
        next_tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        return next_tok, logits, state
    return serve_step


def make_prefill_step(cfg: ArchConfig, qcfg: QuantConfig):
    """Full-sequence prefill: one M = B*S pass through the decode stack.
    (params, state, tokens (B, P)) -> (next_tok (B, 1), logits (B, P, V),
    state).  Dynamic activation quantization runs per position
    (QuantConfig.act_per_pos), so each sequence slice quantizes over the
    block the token loop would; static scales ignore the flag."""
    qcfg_prefill = dataclasses.replace(qcfg, act_per_pos=True)

    def prefill_step(params, state, tokens):
        logits, state = T.forward_decode(params, state, tokens, cfg,
                                         qcfg_prefill)
        next_tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        return next_tok, logits, state
    return prefill_step
