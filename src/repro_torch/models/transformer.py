"""The decoder of every decoder-only family: params init, the layer
loop and the decode step.

Params keep the reference's tree: ``{"embed", "final_norm", "units":
[slot params with a leading n_units axis on every leaf]}``, one stacked
unit per slot of the config's pattern, so both packages name sites
alike (``units.0.attn.wq``, ``units.1.rec.w_in``) and a reference tree
carries over (interop.params_from_numpy).  Each slot's stacked layers
are walked by a Python loop (``_decoder_stack``), all the slot's layers
before the next slot's, as the reference scans them; the loop pushes
each layer index onto an active calibration observer the way the
reference's pscan does.

Ported patterns: dense ``("attn",)`` (the MLP kinds swiglu, geglu,
relu2 and gelu), MoE ``("moe",)`` (an attention block whose MLP is
``models.moe``; expert stacks (n_units, n_experts, K, N)), the hybrid
``("rec", "rec", "attn")`` (RG-LRU blocks and local attention of the
config's window) and the ssm ``("mlstm", "mlstm", "slstm")``
(models.recurrent).  An attention block's decode state is its KV cache
(k, v, idx); a recurrent block's is its state (h and conv; C, n and m;
c, n and m), which has no position.

API:
  init_params(generator, cfg, device)              -> params
  forward_train(params, batch, cfg, qcfg, remat)   -> (loss, metrics)
  forward_decode(params, state, tokens, cfg, qcfg) -> (logits, state)
  init_decode_state(cfg, batch, s_max, device, per_slot) -> state
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..configs import ArchConfig
from ..device import resolve
from ..quant import QuantConfig
from ..quant.linear import QuantizedWeight, get_observer
from . import layers
from . import moe as moe_mod
from . import recurrent

# (family, pattern) pairs the port serves and trains
PORTED = {("dense", ("attn",)), ("moe", ("moe",)),
          ("hybrid", ("rec", "rec", "attn")),
          ("ssm", ("mlstm", "mlstm", "slstm"))}
# block kinds whose decode state is a KV cache
ATTENTION_KINDS = ("attn", "moe")


def _check_ported(cfg: ArchConfig) -> None:
    """Refuse a family or pattern the port has not ported yet, naming it."""
    if (cfg.family, tuple(cfg.pattern)) not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with pattern "
            f"{tuple(cfg.pattern)} is not ported (ported: "
            f"{sorted(PORTED)})")


def _kind_window(cfg: ArchConfig, kind: str):
    """Sliding window policy: 'attn' in hybrids is local attention."""
    if cfg.family == "hybrid" and kind == "attn":
        return cfg.window or 2048
    return cfg.window


def _mlp_init(dense, D: int, F: int, kind: str):
    """An MLP's kernels: gate, up and down for the GLU kinds, up and down
    for relu2 and gelu."""
    if kind in ("geglu", "swiglu"):
        return {"w_gate": dense(D, F), "w_up": dense(D, F),
                "w_down": dense(F, D)}
    return {"w_up": dense(D, F), "w_down": dense(F, D)}


def _block_init(generator, cfg: ArchConfig, kind: str, dense, ones, dev):
    """One pattern slot's params, stacked over the n_units layers."""
    L, D, H, Kv, hd, F = (cfg.n_units, cfg.d_model, cfg.n_heads, cfg.n_kv,
                          cfg.hd, cfg.d_ff)
    unit = {"norm1": ones(L, D)}
    if kind in ATTENTION_KINDS:
        unit["attn"] = {"wq": dense(D, H * hd), "wk": dense(D, Kv * hd),
                        "wv": dense(D, Kv * hd), "wo": dense(H * hd, D)}
        if cfg.qk_norm:
            unit["attn"]["q_norm"] = ones(L, hd)
            unit["attn"]["k_norm"] = ones(L, hd)
    elif kind == "rec":
        unit["rec"] = recurrent.rglru_init(generator, L, D, cfg.d_rnn,
                                           device=dev)
    elif kind == "mlstm":
        unit["mlstm"] = recurrent.mlstm_init(generator, L, D, H, device=dev)
    elif kind == "slstm":
        unit["slstm"] = recurrent.slstm_init(generator, L, D, device=dev)
    else:
        raise ValueError(kind)
    if kind == "moe":
        unit["norm2"] = ones(L, D)
        unit["moe"] = moe_mod.moe_init(generator, L, D, F, cfg.n_experts,
                                       cfg.mlp_kind, cfg.shared_expert_ff,
                                       device=dev)
    elif kind in ("attn", "rec") and F:
        unit["norm2"] = ones(L, D)
        unit["mlp"] = _mlp_init(dense, D, F, cfg.mlp_kind)
    return unit


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device="cuda") -> Dict:
    """Random params with the reference's shapes and init scales: dense
    kernels N(0, 1/in_dim), embedding N(0, 0.02^2), norm gains 1, the
    recurrent blocks' own (models.recurrent).  Drawn on ``generator``'s
    device, then moved to ``device``.  One stacked unit per pattern slot;
    a moe layer's block is attention plus models.moe.moe_init's params."""
    _check_ported(cfg)
    dev = resolve(device)
    gdev = generator.device
    L = cfg.n_units

    def dense(in_dim, out_dim):
        w = torch.randn((L, in_dim, out_dim), generator=generator,
                        device=gdev) * (1.0 / math.sqrt(in_dim))
        return w.to(dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    units = [_block_init(generator, cfg, kind, dense, ones, dev)
             for kind in cfg.pattern]
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                        device=gdev) * 0.02
    return {"embed": embed.to(dev), "final_norm": ones(cfg.d_model),
            "units": units}


def take_layer(tree, i: int):
    """Layer i of a stacked params tree (views; QuantizedWeight slices
    are memoized on the wrapper)."""
    if isinstance(tree, dict):
        return {k: take_layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedWeight):
        return tree.layer(i)
    return tree[i]


def _block_apply(p, x, positions, cfg: ArchConfig, qcfg: QuantConfig,
                 kind: str, cache=None):
    """One decoder layer of ``kind``.  ``cache``: an attention block's KV
    cache (appended to in place), a recurrent block's state, or None.
    Returns (x, new_cache, aux), aux the MoE load-balancing term (the
    float 0.0 for the other kinds, so their path launches nothing for
    it); a recurrent block's new_cache is its final state (new
    tensors)."""
    aux = 0.0
    h = layers.rmsnorm(x, p["norm1"])
    if kind in ATTENTION_KINDS:
        att, new_cache = layers.attention(
            p["attn"], h, positions, qcfg, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv, head_dim=cfg.hd, causal=True,
            window=_kind_window(cfg, kind), qk_norm=cfg.qk_norm,
            cache=cache, rope_theta=cfg.rope_theta)
        x = x + att
    elif kind == "rec":
        y, new_cache = recurrent.rglru(p["rec"], h, qcfg, state=cache)
        x = x + y
    elif kind == "mlstm":
        y, new_cache = recurrent.mlstm(p["mlstm"], h, qcfg, cfg.n_heads,
                                       state=cache)
        return x + y, new_cache, aux
    elif kind == "slstm":
        y, new_cache = recurrent.slstm(p["slstm"], h, qcfg, state=cache)
        return x + y, new_cache, aux
    else:
        raise ValueError(kind)
    if "norm2" in p:
        h2 = layers.rmsnorm(x, p["norm2"])
        if kind == "moe":
            y, aux = moe_mod.moe(p["moe"], h2, qcfg, n_experts=cfg.n_experts,
                                 top_k=cfg.top_k, kind=cfg.mlp_kind,
                                 shared=bool(cfg.shared_expert_ff))
        else:
            y = layers.mlp(p["mlp"], h2, qcfg, cfg.mlp_kind)
        x = x + y
    return x, new_cache, aux


def _decoder_stack(params, x, positions, cfg: ArchConfig,
                   qcfg: QuantConfig, caches=None):
    """Loop the stacked layers, slot by slot. caches: list per pattern
    slot of stacked (n_units, ...) cache or state trees, updated in place
    (an attention cache appended to, a recurrent state overwritten with
    the layer's final state).  Returns (x, new_caches, aux summed over
    the layers); an attention slot's idx advances by the tokens, a
    recurrent slot has none."""
    _check_ported(cfg)
    new_caches = []
    aux_total = 0.0
    obs = get_observer()
    for slot, kind in enumerate(cfg.pattern):
        slot_params = params["units"][slot]
        sc = caches[slot] if caches is not None else None
        for i in range(cfg.n_units):
            lp = take_layer(slot_params, i)
            cache_l = None if sc is None else {k: v[i] for k, v in sc.items()}
            if obs is not None:
                obs.push(i)
            try:
                x, nc, a = _block_apply(lp, x, positions, cfg, qcfg, kind,
                                        cache=cache_l)
            finally:
                if obs is not None:
                    obs.pop()
            if sc is not None and kind not in ATTENTION_KINDS:
                for k, v in nc.items():
                    sc[k][i].copy_(v)
            aux_total = aux_total + a
        if sc is not None and kind in ATTENTION_KINDS:
            sc = {"k": sc["k"], "v": sc["v"], "idx": sc["idx"] + x.shape[1]}
        new_caches.append(sc)
    return x, new_caches, aux_total


def _unstack(tree, n: int):
    """The n per-layer views of a stacked params tree, as a list of
    trees.  torch.unbind gives every view's gradient back to the stacked
    (n_units, ...) leaf in one stack, not one leaf-sized select gradient
    per layer; a QuantizedWeight's layer slice takes its master weights
    from the same unbind."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    if isinstance(tree, QuantizedWeight):
        ws = torch.unbind(tree.w, 0)
        return [tree.layer(i).replace(w=ws[i]) for i in range(n)]
    return list(torch.unbind(tree, 0))


def _train_stack(params, x, positions, cfg: ArchConfig, qcfg: QuantConfig,
                 remat: bool):
    """The decoder layers of a training forward.  With ``remat`` each
    layer runs inside torch.utils.checkpoint (non-reentrant), so its
    activations are recomputed in the backward pass, as jax.checkpoint
    does under the reference's remat_scope; the dynamic quantizers are
    deterministic, so the recompute reproduces every quantized
    operand.  An active calibration observer gets each layer's index,
    as in _decoder_stack.  Returns (x, aux summed over the layers)."""
    _check_ported(cfg)
    obs = get_observer()
    aux_total = 0.0

    for slot, kind in enumerate(cfg.pattern):
        def layer(lp, h, kind=kind):
            out, _, a = _block_apply(lp, h, positions, cfg, qcfg, kind)
            return out, a

        for i, lp in enumerate(_unstack(params["units"][slot],
                                        cfg.n_units)):
            if obs is not None:
                obs.push(i)
                try:
                    x, a = layer(lp, x)
                finally:
                    obs.pop()
            elif remat:
                # the layer draws no random numbers: no RNG state to keep
                x, a = torch_checkpoint.checkpoint(
                    functools.partial(layer, lp), x, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, a = layer(lp, x)
            aux_total = aux_total + a
    return x, aux_total


def forward_train(params, batch, cfg: ArchConfig, qcfg: QuantConfig,
                  remat: bool = False):
    """batch: tokens (B, S), labels (B, S), optional mask (B, S).
    Returns (loss, metrics) with metrics loss (the masked mean NLL plus
    0.01 aux), aux (the MoE load-balancing term summed over the layers, 0
    for the dense family) and ppl_proxy = exp(min(loss, 20))."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    x, aux = _train_stack(params, x, positions, cfg, qcfg, remat)
    x = layers.rmsnorm(x, params["final_norm"])
    logits = layers.unembed(params["embed"], x, qcfg)
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    loss = loss + 0.01 * aux
    return loss, {"loss": loss, "aux": aux,
                  "ppl_proxy": torch.exp(torch.clamp_max(loss, 20.0))}


def forward_decode(params, state, tokens, cfg: ArchConfig,
                   qcfg: QuantConfig):
    """One decode step, or a full-sequence prefill: tokens (B, S) with
    S > 1 run the whole block causally against the fresh KV region in
    one pass (every qdot sees M = B*S rows).  ``state`` (from
    init_decode_state) has its caches appended to in place and is handed
    back with the new positions."""
    x = layers.embed(params["embed"], tokens)
    x, new_caches, _ = _decoder_stack(params, x, None, cfg, qcfg,
                                      caches=state["caches"])
    x = layers.rmsnorm(x, params["final_norm"])
    logits = layers.unembed(params["embed"], x, qcfg)
    return logits, dict(state, caches=new_caches)


def init_decode_state(cfg: ArchConfig, batch: int, s_max: int,
                      device="cuda", per_slot: bool = False) -> Dict:
    """Each pattern slot's zeroed decode state, stacked over its layers:
    an attention slot's bf16 KV cache, k/v (n_units, B, s_max, n_kv, hd)
    and idx (n_units,), or with ``per_slot`` idx (n_units, B), each slot
    at its own depth (continuous batching: launch.serve --continuous); a
    recurrent slot's float32 state (n_units, B, ...): h and conv (rec),
    C, n and m (mlstm), c, n and m (slstm)."""
    _check_ported(cfg)
    dev = resolve(device)
    caches = []
    for kind in cfg.pattern:
        if kind in ATTENTION_KINDS:
            one = layers.make_cache(batch, s_max, cfg.n_kv, cfg.hd,
                                    device=dev, per_slot=per_slot)
        elif kind == "rec":
            one = recurrent.rglru_state(batch, cfg.d_rnn, device=dev)
        elif kind == "mlstm":
            one = recurrent.mlstm_state(batch, cfg.n_heads,
                                        cfg.d_model // cfg.n_heads,
                                        device=dev)
        else:
            one = recurrent.slstm_state(batch, cfg.d_model, device=dev)
        caches.append({k: torch.zeros((cfg.n_units, *v.shape),
                                      dtype=v.dtype, device=dev)
                       for k, v in one.items()})
    return {"caches": caches}
