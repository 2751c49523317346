"""Every family's model: params init, the encoder, the layer loop and
the decode step.

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

The encoder-decoder family (whisper-small) adds ``params["enc"]``: a
stack of non-causal encoder layers over the stub frontend's frames
(``_run_encoder``, roped from position 0) and, for every decoder layer,
a cross block (``enc.cross``: norm, then attention whose k and v are
the encoder output's projections), applied after the layer's
self-attention and MLP, as the reference orders it.  The decode state
carries the encoder output (``enc_out``), and every step projects its k
and v again.  The VLM family (internvl2-76b) projects the stub
frontend's patches (``frontend_proj``) and prepends them to the tokens
in ``forward_train``; its serve is the dense decode path, with no
prefix.

API:
  init_params(generator, cfg, device)              -> params
  param_shapes(cfg)                                -> meta params
  forward_train(params, batch, cfg, qcfg, remat)   -> (loss, metrics)
  forward_decode(params, state, tokens, cfg, qcfg) -> (logits, state)
  init_decode_state(cfg, batch, s_max, device, per_slot, enc_out) -> state
  _run_encoder(params, frontend, cfg, qcfg)        -> enc_out
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from .. import trace
from ..configs import ArchConfig
from ..device import resolve
from ..quant import QuantConfig, qdot
from ..quant.linear import QuantizedWeight, get_observer
from . import layers
from . import moe as moe_mod
from . import recurrent
from .sharding import constrain

# (family, pattern) pairs the port serves and trains
PORTED = {("dense", ("attn",)), ("moe", ("moe",)),
          ("hybrid", ("rec", "rec", "attn")),
          ("ssm", ("mlstm", "mlstm", "slstm")),
          ("encdec", ("attn",)), ("vlm", ("attn",))}
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
        unit["attn"] = _attn_init(dense, D, H, Kv, hd)
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


def init_params(generator: Optional[torch.Generator], cfg: ArchConfig,
                device="cuda") -> Dict:
    """Random params with the reference's shapes and init scales: dense
    kernels N(0, 1/in_dim), embedding N(0, 0.02^2), norm gains 1, the
    recurrent blocks' own (models.recurrent).  Drawn on ``generator``'s
    device, then moved to ``device``.  One stacked unit per pattern slot;
    a moe layer's block is attention plus models.moe.moe_init's params.
    The encdec family adds ``enc`` (``_init_encoder``), a frontend wider
    or narrower than d_model adds ``frontend_proj`` (frontend_dim,
    d_model).  On ``device="meta"`` with no generator, the tree's shapes
    and dtypes and nothing else: no value is drawn and no memory is
    allocated (param_shapes)."""
    _check_ported(cfg)
    dev = resolve(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init_params draws from a torch.Generator; only "
                         "device='meta' (shapes alone) takes none")
    gdev = generator.device if generator is not None else dev

    def dense_n(L, in_dim, out_dim):
        if generator is None:             # meta: no value, no op on one
            return torch.empty((*L, in_dim, out_dim), device=dev)
        w = torch.randn((*L, in_dim, out_dim), generator=generator,
                        device=gdev) * (1.0 / math.sqrt(in_dim))
        return w.to(dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    units = [_block_init(generator, cfg, kind,
                         functools.partial(dense_n, (cfg.n_units,)), ones,
                         dev)
             for kind in cfg.pattern]
    embed = (torch.empty((cfg.vocab, cfg.d_model), device=dev)
             if generator is None else
             torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                         device=gdev) * 0.02)
    params = {"embed": embed.to(dev), "final_norm": ones(cfg.d_model),
              "units": units}
    if cfg.family == "encdec":
        params["enc"] = _init_encoder(cfg, dense_n, ones)
    if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
        params["frontend_proj"] = dense_n((), cfg.frontend_dim, cfg.d_model)
    return params


def param_shapes(cfg: ArchConfig) -> Dict:
    """The params tree as meta tensors: the leaf paths, shapes and
    dtypes of init_params (those of the reference's
    jax.eval_shape(init_params)), with no weight allocated."""
    return init_params(None, cfg, device="meta")


def _attn_init(dense, D, H, Kv, hd):
    return {"wq": dense(D, H * hd), "wk": dense(D, Kv * hd),
            "wv": dense(D, Kv * hd), "wo": dense(H * hd, D)}


def _init_encoder(cfg: ArchConfig, dense_n, ones) -> Dict:
    """The encoder's params, as the reference's ``_init_encoder`` builds
    them: ``layers``, a stack over enc_layers of norm1, attention (wq, wk,
    wv, wo; no qk-norm), norm2 and the MLP; ``norm``; and ``cross``, a
    stack over all n_layers decoder layers of a norm and an attention."""
    E, L, D = cfg.enc_layers, cfg.n_layers, cfg.d_model
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    enc_dense = functools.partial(dense_n, (E,))
    cross_dense = functools.partial(dense_n, (L,))
    return {"layers": {"norm1": ones(E, D),
                       "attn": _attn_init(enc_dense, D, H, Kv, hd),
                       "norm2": ones(E, D),
                       "mlp": _mlp_init(enc_dense, D, cfg.d_ff,
                                        cfg.mlp_kind)},
            "norm": ones(D),
            "cross": {"norm": ones(L, D),
                      "attn": _attn_init(cross_dense, D, H, Kv, hd)}}


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


def _cross_block(xp, x, cross_ctx, cfg: ArchConfig, qcfg: QuantConfig):
    """A decoder layer's cross block: rmsnorm, then attention of x's
    queries over the encoder output, whose k and v this call projects
    (wk, wv) again, and the residual.  No rope, no cache, no mask."""
    hc = layers.rmsnorm(x, xp["norm"])
    ap = xp["attn"]
    ck = layers._split_heads(qdot(cross_ctx, ap["wk"], qcfg), cfg.n_kv,
                             cfg.hd)
    cv = layers._split_heads(qdot(cross_ctx, ap["wv"], qcfg), cfg.n_kv,
                             cfg.hd)
    att, _ = layers.attention(ap, hc, None, qcfg, n_heads=cfg.n_heads,
                              n_kv=cfg.n_kv, head_dim=cfg.hd, causal=False,
                              cross_kv=(ck, cv), rope_theta=0.0)
    return x + att


def _has_cross(cfg: ArchConfig, kind: str, cross_ctx) -> bool:
    return cross_ctx is not None and kind == "attn" \
        and cfg.family == "encdec"


def _decoder_stack(params, x, positions, cfg: ArchConfig,
                   qcfg: QuantConfig, caches=None, cross_ctx=None):
    """Loop the stacked layers, slot by slot. caches: list per pattern
    slot of stacked (n_units, ...) cache or state trees, updated in place
    (an attention cache appended to, a recurrent state overwritten with
    the layer's final state).  cross_ctx: the encoder output (B, S_enc,
    D) of an encdec model: each layer's cross block follows it, under
    the layer's observer index (sites ``enc.cross.attn.wk@i``).  Returns
    (x, new_caches, aux summed over the layers); an attention slot's idx
    advances by the tokens, a recurrent slot has none."""
    _check_ported(cfg)
    new_caches = []
    aux_total = 0.0
    obs = get_observer()
    for slot, kind in enumerate(cfg.pattern):
        slot_params = params["units"][slot]
        sc = caches[slot] if caches is not None else None
        has_cross = _has_cross(cfg, kind, cross_ctx)
        for i in range(cfg.n_units):
            lp = take_layer(slot_params, i)
            cache_l = None if sc is None else {k: v[i] for k, v in sc.items()}
            if obs is not None:
                obs.push(i)
            try:
                x = constrain(x, "batch", "seq_shard", None)
                x, nc, a = _block_apply(lp, x, positions, cfg, qcfg, kind,
                                        cache=cache_l)
                x = constrain(x, "batch", "seq_shard", None)
                if has_cross:
                    x = _cross_block(take_layer(params["enc"]["cross"], i),
                                     x, cross_ctx, cfg, qcfg)
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
                 remat: bool, cross_ctx=None):
    """The decoder layers of a training forward.  With ``remat`` each
    layer (its cross block included) runs inside torch.utils.checkpoint
    (non-reentrant), so its activations are recomputed in the backward
    pass, as jax.checkpoint does under the reference's remat_scope; the
    dynamic quantizers are deterministic, so the recompute reproduces
    every quantized operand.  An active calibration observer gets each
    layer's index, as in _decoder_stack.  Returns (x, aux summed over
    the layers)."""
    _check_ported(cfg)
    obs = get_observer()
    aux_total = 0.0

    for slot, kind in enumerate(cfg.pattern):
        has_cross = _has_cross(cfg, kind, cross_ctx)
        crosses = (_unstack(params["enc"]["cross"], cfg.n_units)
                   if has_cross else [None] * cfg.n_units)

        def layer(lp, xp, h, ctx, kind=kind):
            # opened again by remat's recompute in the backward pass
            with trace.span("model.layer"):
                h = constrain(h, "batch", "seq_shard", None)
                out, _, a = _block_apply(lp, h, positions, cfg, qcfg, kind)
                out = constrain(out, "batch", "seq_shard", None)
                if xp is not None:
                    out = _cross_block(xp, out, ctx, cfg, qcfg)
            return out, a

        for i, lp in enumerate(_unstack(params["units"][slot],
                                        cfg.n_units)):
            if obs is not None:
                obs.push(i)
                try:
                    x, a = layer(lp, crosses[i], x, cross_ctx)
                finally:
                    obs.pop()
            elif remat:
                # the layer draws no random numbers: no RNG state to keep
                x, a = torch_checkpoint.checkpoint(
                    functools.partial(layer, lp, crosses[i]), x, cross_ctx,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, a = layer(lp, crosses[i], x, cross_ctx)
            aux_total = aux_total + a
    return x, aux_total


def _run_encoder(params, frontend, cfg: ArchConfig, qcfg: QuantConfig):
    """The encoder over the stub frontend's embeddings, frontend (B,
    S_enc, frontend_dim or d_model) float32: the optional frontend_proj,
    then per layer rmsnorm -> non-causal self-attention roped from
    position 0 (rope_theta 10,000, the attention's default, as the
    reference has it) -> residual -> rmsnorm -> MLP -> residual, each
    layer's index pushed on an active observer (sites
    ``enc.layers.attn.wq@i``); a final rmsnorm.  Returns (B, S_enc, D)."""
    x = frontend
    if "frontend_proj" in params:
        x = qdot(x, params["frontend_proj"], qcfg)
    enc = params["enc"]
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    obs = get_observer()
    for i in range(cfg.enc_layers):
        lp = take_layer(enc["layers"], i)
        if obs is not None:
            obs.push(i)
        try:
            h = layers.rmsnorm(x, lp["norm1"])
            att, _ = layers.attention(lp["attn"], h, pos, qcfg,
                                      n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                      head_dim=cfg.hd, causal=False)
            x = x + att
            x = x + layers.mlp(lp["mlp"], layers.rmsnorm(x, lp["norm2"]),
                               qcfg, cfg.mlp_kind)
        finally:
            if obs is not None:
                obs.pop()
    return layers.rmsnorm(x, enc["norm"])


def forward_train(params, batch, cfg: ArchConfig, qcfg: QuantConfig,
                  remat: bool = False):
    """batch: tokens (B, S), labels (B, S), optional mask (B, S), and for
    the encdec and vlm families the stub frontend's embeddings
    ``frontend``: encdec runs the encoder over them and every decoder
    layer's cross block over its output; vlm projects them
    (frontend_proj) and prepends them to the tokens, positions running
    over prefix + S, and keeps the last S rows for the loss.  Returns
    (loss, metrics) with metrics loss (the masked mean NLL plus 0.01
    aux), aux (the MoE load-balancing term summed over the layers, 0
    for the other families) and ppl_proxy = exp(min(loss, 20))."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens)
    x = constrain(x, "batch", None, "embed")
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cross_ctx = None
    if cfg.family == "encdec":
        cross_ctx = _run_encoder(params, batch["frontend"], cfg, qcfg)
    if cfg.family == "vlm":
        prefix = batch["frontend"]
        if "frontend_proj" in params:
            prefix = qdot(prefix, params["frontend_proj"], qcfg)
        x = torch.cat([prefix.to(x.dtype), x], 1)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
    x, aux = _train_stack(params, x, positions, cfg, qcfg, remat,
                          cross_ctx=cross_ctx)
    x = layers.rmsnorm(x, params["final_norm"])
    if cfg.family == "vlm":
        x = x[:, -S:]
    logits = layers.unembed(params["embed"], x, qcfg)
    logits = constrain(logits, "batch", None, "vocab")
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
    back with the new positions.  An encdec state's ``enc_out`` feeds
    every layer's cross block."""
    x = layers.embed(params["embed"], tokens)
    x, new_caches, _ = _decoder_stack(params, x, None, cfg, qcfg,
                                      caches=state["caches"],
                                      cross_ctx=state.get("enc_out"))
    x = layers.rmsnorm(x, params["final_norm"])
    logits = layers.unembed(params["embed"], x, qcfg)
    return logits, dict(state, caches=new_caches)


def init_decode_state(cfg: ArchConfig, batch: int, s_max: int,
                      device="cuda", per_slot: bool = False,
                      enc_out=None) -> Dict:
    """Each pattern slot's zeroed decode state, stacked over its layers:
    an attention slot's bf16 KV cache, k/v (n_units, B, s_max, n_kv, hd)
    and idx (n_units,), or with ``per_slot`` idx (n_units, B), each slot
    at its own depth (continuous batching: launch.serve --continuous); a
    recurrent slot's float32 state (n_units, B, ...): h and conv (rec),
    C, n and m (mlstm), c, n and m (slstm).  ``enc_out``: an encdec
    model's encoder output (B, S_enc, D), kept as ``state["enc_out"]``."""
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
    state = {"caches": caches}
    if enc_out is not None:
        state["enc_out"] = enc_out
    return state
