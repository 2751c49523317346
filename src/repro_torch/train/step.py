"""Train and serving step factories: the QAT train step (microbatched
gradient accumulation, remat, int8 gradient compression with error
feedback), one batched decode step, the full-sequence prefill and the
cache-free prefill forward of the dry run's prefill cells."""
from __future__ import annotations

import dataclasses

import torch

from .. import trace
from ..configs import ArchConfig
from ..device import true_div
from ..models import layers
from ..models import transformer as T
from ..quant import QuantConfig, qdot
from . import optimizer as opt_mod
from .optimizer import OptConfig, tree_leaves, tree_map, tree_unflatten


def make_loss_fn(cfg: ArchConfig, qcfg: QuantConfig, remat: bool = False,
                 params_transform=None):
    """(params, batch) -> (loss, metrics): forward_train, with every
    decoder layer recomputed in the backward pass when ``remat``.
    ``params_transform``: an optional function applied to the params
    inside the loss (calib.plan.make_plan_injector, wrapping the raw
    weights with the plan's per-layer tables); autograd sees through it,
    so the gradients and the optimizer state stay on the raw leaves."""
    def loss_fn(params, batch):
        if params_transform is not None:
            params = params_transform(params)
        return T.forward_train(params, batch, cfg, qcfg, remat=remat)
    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) with grads shaped like ``params``: the
    counterpart of jax.value_and_grad(loss_fn, has_aux=True)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(live, batch)
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(live))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, qcfg: QuantConfig, ocfg: OptConfig,
                    microbatches: int = 1, remat: bool = True,
                    params_transform=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``microbatches`` > 1 the batch is split along its first axis and
    the gradients summed over the pieces in order, then divided by the
    count (the reference's lax.scan, as a loop).  The optimizer updates
    the params and its state in place (optimizer.apply).
    ``params_transform``: see make_loss_fn."""
    loss_fn = make_loss_fn(cfg, qcfg, remat, params_transform)

    def train_step(params, opt_state, batch):
        with trace.span("train.step"):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            def split(x):
                return x.reshape(microbatches, x.shape[0] // microbatches,
                                 *x.shape[1:])
            mbs = {k: split(v) for k, v in batch.items()}
            grads = tree_map(torch.zeros_like, params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                loss_i, _, g = _value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in mbs.items()})
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
                loss_sum = loss_sum + loss_i
            grads = tree_map(lambda g: true_div(g, float(microbatches)),
                             grads)
            loss = true_div(loss_sum, float(microbatches))
            metrics = {"loss": loss}
        with trace.span("train.optimizer"):
            # before the optimizer, which updates the grads in place
            grad_norm = opt_mod.global_norm(grads)
            params, opt_state = opt_mod.apply(params, grads, opt_state, ocfg)
        metrics = dict(metrics, loss=loss, grad_norm=grad_norm)
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ArchConfig, qcfg: QuantConfig):
    """One batched decode step: (params, state, tokens) -> (next_tok,
    logits, state), greedy sampling included."""
    def serve_step(params, state, tokens):
        with trace.span("serve.step"):
            logits, state = T.forward_decode(params, state, tokens, cfg,
                                             qcfg)
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
        with trace.span("serve.prefill"):
            logits, state = T.forward_decode(params, state, tokens, cfg,
                                             qcfg_prefill)
            next_tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        return next_tok, logits, state
    return prefill_step


def make_prefill_logits(cfg: ArchConfig, qcfg: QuantConfig):
    """Cache-free full-sequence forward (the dry run's prefill-shape
    step): (params, batch) -> the logits of the last 128 positions, (B,
    min(128, S'), V), S' the tokens plus a VLM's prefix.  The encdec
    family runs the encoder over ``batch["frontend"]`` and every decoder
    layer's cross block over its output; the VLM projects its prefix
    (frontend_proj) and prepends it to the tokens.  Every projection
    runs through the kernel ``qcfg`` picks (residual_matmul for
    'residual_xla', delta_matmul for the default 'delta'); attention is
    torch ops, as the reference's outside Pallas.  No autograd."""
    @torch.no_grad()
    def prefill_logits(params, batch):
        tokens = batch["tokens"]
        x = layers.embed(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=x.device)
        cross = None
        if cfg.family == "encdec":
            cross = T._run_encoder(params, batch["frontend"], cfg, qcfg)
        if cfg.family == "vlm":
            prefix = batch["frontend"]
            if "frontend_proj" in params:
                prefix = qdot(prefix, params["frontend_proj"], qcfg)
            x = torch.cat([prefix.to(x.dtype), x], 1)
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
        x, _, _ = T._decoder_stack(params, x, positions, cfg, qcfg,
                                   cross_ctx=cross)
        x = layers.rmsnorm(x, params["final_norm"])
        return layers.unembed(params["embed"], x[:, -128:], qcfg)
    return prefill_logits
