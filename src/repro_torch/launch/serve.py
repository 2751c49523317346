"""Batched-request serving driver: fused full-sequence prefill + batched
greedy decode with a KV cache, on the card, and continuous batching with
per-slot cache positions.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 4 --prompt-len 64 --gen-len 16 --calibrate 1

--arch takes every config of the reference (configs.ARCHS): the dense
qwen3-1.7b, gemma-7b, minitron-8b and nemotron-4-340b, the MoE
mixtral-8x7b and llama4-scout-17b-a16e (the experts' projections are
qdots of their own, one per expert), the hybrid recurrentgemma-2b
(RG-LRU blocks and local attention), the ssm xlstm-125m (mLSTM and
sLSTM blocks; its mLSTM keeps wq/wk/wv unmerged, quant.fuse_projections
says why), the encoder-decoder whisper-small and the VLM internvl2-76b.
Under --continuous an MoE request's ids can depend on its batch: an
expert's capacity is shared by the tokens of a forward, so a token
dropped in a full batch may be kept alone (the reference's too).

whisper-small's requests carry stub encoder frames, (B, 16, d_model)
drawn after the prompts: serve encodes them once, before the warm-up,
and every prefill and decode step's cross blocks read the output (the
encoder's time has a line of its own).  Calibration runs the encoder
too, on frames drawn before its prompts.  --continuous refuses
encdec, as the reference does.  internvl2-76b serves as the dense
decoder it holds: serving prepends no prefix, so --calibrate never
visits its frontend_proj and apply_calibration raises KeyError for
that site, as the reference's does; --prequantize serves it.

Quantization precomputation ladder (quant/linear.py):
  --prequantize      cache weight quantization once (q/scale/zp/colsum)
  --per-channel      per-output-channel weight scales
  --calibrate N      run N calibration batches token by token through the
                     decode path and fix STATIC per-layer activation
                     scales
  --clip MODE        activation-range calibrator: minmax | pct999 | mse
  --plan FILE        serve a per-layer design plan (calib.plan, ``python
                     -m repro_torch.calib``): each layer's projections
                     gather their own design's delta table, a row of the
                     site's bank
--calibrate and --plan imply --prequantize.  The order is prequantize ->
calibrate -> apply_plan -> attach_comp_cols -> fuse_projections.  With
prequantized weights the attention wq|wk|wv and mlp gate|up projections
are merged where their tables agree (--no-fuse-proj keeps them apart).

--backend picks the approximate product (quant.QuantConfig; every name
the reference takes).  Its default is the reference's: 'fused' with
static scales installed (--calibrate / --plan: one kernel quantizes,
multiplies and dequantizes each projection), else 'xla' (the product-LUT
gather, the lut_matmul kernel).  'delta' runs the same integer products
through delta_matmul, 'residual' the rank-32 emulation through
residual_matmul.

--continuous N serves N requests through the --requests slots with
per-slot cache positions: a slot that has generated --gen-len tokens is
prefilled at once with the next queued request while the other slots
keep decoding.  The cache holds P + 2G + 2 positions, as the
reference's; idle slots keep stepping, and serve raises (never
clamps) before any slot would write past the cache.

Timing is steady state: the kernels are built and the steps warmed up
first (reported on their own lines), and each timed region starts and
ends with torch.cuda.synchronize().

--trace-out PATH records the run's spans (repro_torch.trace: the prefill
and decode steps, attention, each projection, the head; host and device
time) and writes them to PATH as a Chrome trace (chrome://tracing,
Perfetto).  It costs a CUDA event pair a span: time the run without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import configs, trace
from ..device import resolve
from ..models import transformer as T
from ..quant import QuantConfig
from ..train import make_prefill_step, make_serve_step


# stub encoder frames a request carries (the reference's serve)
ENC_FRAMES = 16


def _calibration_prompts(cfg, rng, batches: int, requests: int,
                         prompt_len: int):
    return [rng.integers(0, cfg.vocab, (requests, prompt_len))
            .astype(np.int32) for _ in range(batches)]


def prepare_params(params, cfg, qcfg, args, device="cuda", table=None):
    """Apply the requested precomputation ladder to a params tree.
    Returns (params, notes, the calibration table or None).  Calibration
    draws from its own rng (seed 4242), so enabling --calibrate never
    shifts the serving prompts.  ``table``: the table an earlier run with
    the same arguments calibrated, installed without calibrating again
    (calibration is deterministic)."""
    from ..quant import fuse_projections, prequantize_weights
    notes = []
    if not (args.prequantize or args.calibrate or args.plan):
        return params, notes, None
    params = prequantize_weights(params, qcfg)
    notes.append("prequantized weights"
                 + (" (per-channel)" if qcfg.w_per_channel else ""))
    if args.calibrate:
        from ..calib import apply_calibration, calibrate_decode
        if table is None:
            crng = np.random.default_rng(4242)
            enc_frontend = None
            if cfg.family == "encdec":      # drawn before the prompts
                enc_frontend = crng.normal(size=(
                    args.requests, ENC_FRAMES,
                    cfg.frontend_dim or cfg.d_model)).astype(np.float32)
            for prompts in _calibration_prompts(cfg, crng, args.calibrate,
                                                args.requests,
                                                args.prompt_len):
                t = calibrate_decode(params, cfg, qcfg, prompts, gen_len=2,
                                     device=device,
                                     enc_frontend=enc_frontend)
                table = t if table is None else table.merge(t)
        params = apply_calibration(params, table, clip=args.clip)
        notes.append(f"static act scales ({len(table.sites)} sites, "
                     f"{args.calibrate} calib batches, clip={args.clip})")
    if args.plan:
        from ..calib import DesignPlan, apply_plan
        plan = DesignPlan.load(args.plan)
        params = apply_plan(params, plan, qcfg)
        notes.append(f"design plan {args.plan} (histogram "
                     f"{plan.histogram()})")
    if qcfg.backend == "fused" and qcfg.compensate:
        # after apply_plan: its wrappers carry their own comp_col
        from ..calib import attach_comp_cols
        params = attach_comp_cols(params, qcfg)
        notes.append("fused backend (cached compensation colsums)")
    if not args.no_fuse_proj:
        params = fuse_projections(params)
        notes.append("merged wq|wk|wv -> wqkv, w_gate|w_up -> w_gateup "
                     "(fuse_projections)")
    return params, notes, table


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--design", default="design2")
    ap.add_argument("--backend", default=None,
                    help="approximate-matmul backend (quant.QuantConfig). "
                         " Default: 'fused' when static act scales are "
                         "installed (--calibrate/--plan), else 'xla'")
    ap.add_argument("--quant-mode", default="asym_u8",
                    choices=["asym_u8", "sym_i8"])
    ap.add_argument("--prequantize", action="store_true",
                    help="quantize the weights once up front")
    ap.add_argument("--per-channel", action="store_true",
                    help="per-output-channel weight scales")
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="run N calibration batches and serve with STATIC "
                         "activation scales")
    ap.add_argument("--clip", default="minmax",
                    choices=["minmax", "pct999", "mse"])
    ap.add_argument("--prefill", default="fused", choices=["fused", "loop"],
                    help="'fused' = one full-sequence M=B*S pass, 'loop' = "
                         "token by token through the decode step")
    ap.add_argument("--plan", default=None, metavar="FILE",
                    help="DesignPlan JSON: serve its per-layer designs "
                         "(implies --prequantize)")
    ap.add_argument("--no-fuse-proj", action="store_true",
                    help="keep wq/wk/wv and w_gate/w_up as separate calls")
    ap.add_argument("--continuous", type=int, default=None, metavar="N",
                    help="continuous batching: serve N total requests "
                         "through --requests slots with per-slot cache "
                         "positions (finished slots re-prefill from the "
                         "queue)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace the run's steps and layers (host and "
                         "device time) into a Chrome trace at PATH")
    return ap


def quant_config(args) -> QuantConfig:
    """The run's QuantConfig, with the reference's default backend."""
    backend = args.backend or (
        "fused" if (args.calibrate or args.plan) else "xla")
    return QuantConfig(design=args.design, backend=backend,
                       mode=args.quant_mode,
                       w_per_channel=args.per_channel, inference=True)


@dataclasses.dataclass
class Prepared:
    """A run's model, ready to serve: what ``prepare`` made."""
    cfg: object
    qcfg: QuantConfig
    device: torch.device
    params: dict
    notes: list
    table: object              # the calibration table (None uncalibrated)
    t_build: float             # kernel build (0 on the CPU or when cached)
    t_prepare: float           # init + prequantize + calibrate + plan


@dataclasses.dataclass
class ServeResult:
    out: np.ndarray            # (B, gen_len) generated ids
    logits: np.ndarray         # last step's logits
    t_build: float             # kernel build (0 on the CPU or when cached)
    t_prepare: float           # prequantize + calibrate + plan + install
    t_warmup: float            # first prefill + decode step
    t_prefill: float           # steady state, seconds
    t_decode: float            # steady state, seconds for gen_len-1 steps
    peak_bytes: int            # device memory high-water mark (cuda)
    t_encode: float = 0.0      # encdec: the requests' encoder pass


@dataclasses.dataclass
class ContinuousResult:
    out: np.ndarray            # (N, gen_len) generated ids, by request
    logits: np.ndarray         # last batched step's logits
    t_build: float
    t_prepare: float
    t_warmup: float            # the three steps' first calls
    t_serve: float             # steady state: prefills, refills, steps
    steps: int                 # batched decode steps
    slots: int                 # min(--requests, N)
    peak_bytes: int


@torch.no_grad()
def prepare(args, table=None, cfg=None) -> Prepared:
    """Build the kernels (on the card), draw the seeded params and apply
    the precomputation ladder (prepare_params; ``table``: an earlier
    Prepared's calibration table, for the same arguments).  A Prepared
    made from one set of arguments serves any run whose QuantConfig and
    model arguments agree (``run(args, prepared)``).  ``cfg``: the model
    config to serve in place of ``--arch``'s (a depth-cut variant of it,
    say)."""
    dev = resolve(args.device)
    if cfg is None:
        cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
            args.arch)
    qcfg = quant_config(args)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False   # exact f32 unembed
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    if dev.type == "cuda":
        from ..kernels import _build
        _build.build()
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, device=dev)
    params, notes, table = prepare_params(params, cfg, qcfg, args,
                                          device=dev, table=table)
    _sync(dev)
    return Prepared(cfg, qcfg, dev, params, notes, table, t_build,
                    time.perf_counter() - t0)


def _scatter_slot(state, one, slot: int) -> None:
    """Write a freshly prefilled single-slot state into the batched
    ``state`` at ``slot``, in place.  Every leaf is stacked (n_units, B,
    ...): an attention cache's k, v and per-slot idx, a recurrent
    state's h and conv, C, n and m, or c, n and m."""
    for c_full, c_one in zip(state["caches"], one["caches"]):
        for k, full in c_full.items():
            full[:, slot] = c_one[k][:, 0]


@torch.no_grad()
def serve_continuous(params, cfg, qcfg, args, rng, device="cuda"):
    """Continuous batching: --continuous N requests through --requests
    slots, each slot at its own cache position (init_decode_state
    per_slot=True).  A finished slot is prefilled at once with the next
    queued request (a B = 1 prefill scattered into the slot) while the
    rest decode.  Returns (out (N, gen_len), logits, t_warmup, t_serve,
    steps, slots).  Refuses encdec, as the reference does."""
    if cfg.family == "encdec":
        raise NotImplementedError("--continuous: encdec requests carry "
                                  "per-request encoder state")
    dev = resolve(device)
    P, G = args.prompt_len, args.gen_len
    N = args.continuous
    B = min(args.requests, N)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (N, P)).astype(np.int32), device=dev)
    s_max = P + 2 * G + 2          # slack: idle slots keep stepping
    prefill = make_prefill_step(cfg, qcfg)
    serve = make_serve_step(cfg, qcfg)

    def state(b):
        return T.init_decode_state(cfg, b, s_max, device=dev, per_slot=True)

    # warm the three steps (batched prefill, decode, B = 1 refill)
    t0 = time.perf_counter()
    tok_w, _, warm = prefill(params, state(B), prompts[:B])
    serve(params, warm, tok_w)
    prefill(params, state(1), prompts[:1])
    _sync(dev)
    del warm
    t_warmup = time.perf_counter() - t0

    t0 = time.perf_counter()
    st = state(B)
    tok, logits, st = prefill(params, st, prompts[:B])
    depth = [P] * B                # each slot's cache position, on the host
    slot_req = list(range(B))      # request id per slot (None: idle)
    produced = {r: [] for r in range(B)}
    next_req = B
    steps = 0
    while any(r is not None for r in slot_req):
        # harvest the slots' current tokens, refilling finished slots (the
        # refill's own prefill token is recorded here; the next batched
        # step consumes it to produce the slot's second token)
        toks = tok.cpu().numpy()
        for slot, r in enumerate(slot_req):
            if r is None:
                continue
            produced[r].append(int(toks[slot, 0]))
            while slot_req[slot] is not None and \
                    len(produced[slot_req[slot]]) >= G:
                if next_req < N:
                    t1, _, one = prefill(params, state(1),
                                         prompts[next_req:next_req + 1])
                    _scatter_slot(st, one, slot)
                    tok[slot] = t1[0]
                    slot_req[slot] = next_req
                    produced[next_req] = [int(t1[0, 0])]
                    depth[slot] = P
                    next_req += 1
                else:
                    slot_req[slot] = None
        if all(r is None for r in slot_req):
            break
        if max(depth) >= s_max:
            raise RuntimeError(
                f"continuous batching: slot {depth.index(max(depth))} would "
                f"write cache position {max(depth)} of a {s_max}-position "
                f"cache")
        tok, logits, st = serve(params, st, tok)
        depth = [d + 1 for d in depth]
        steps += 1
    out = np.asarray([produced[r] for r in range(N)], np.int32)
    _sync(dev)
    return (out, logits.float().cpu().numpy(), t_warmup,
            time.perf_counter() - t0, steps, B)


@torch.no_grad()
def run(args, prepared: Prepared = None, enc_frames: int = ENC_FRAMES):
    """Serve as ``main`` does and return the outputs and timings: a
    ServeResult, or with --continuous a ContinuousResult.  ``prepared``
    (from ``prepare``) skips the build and the ladder; its QuantConfig
    must be the one ``args`` asks for.  ``enc_frames``: the encoder
    frames an encdec request carries (the config's enc_seq, say, in
    place of serve's 16).  The peak memory is the device's high-water
    mark since ``prepare`` reset it (or since the caller did)."""
    p = prepared or prepare(args)
    if p.qcfg != quant_config(args):
        raise ValueError(f"prepared for {p.qcfg}, asked for "
                         f"{quant_config(args)}")
    cfg, qcfg, dev, params = p.cfg, p.qcfg, p.device, p.params
    for n in p.notes:
        print(f"[serve] {n}")
    rng = np.random.default_rng(0)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
            else 0

    if args.continuous:
        out, logits, t_warmup, t_serve, steps, slots = serve_continuous(
            params, cfg, qcfg, args, rng, dev)
        return ContinuousResult(out, logits, p.t_build, p.t_prepare,
                                t_warmup, t_serve, steps, slots, peak())

    B = args.requests
    s_max = args.prompt_len + args.gen_len
    prompts = rng.integers(0, cfg.vocab, (B, args.prompt_len)).astype(
        np.int32)
    prompts_dev = torch.as_tensor(prompts, device=dev)
    serve = make_serve_step(cfg, qcfg)
    prefill = make_prefill_step(cfg, qcfg)

    # encdec: the requests' frames, drawn after the prompts, encoded once
    # for the warm-up and the timed states
    enc_out, t_encode = None, 0.0
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.normal(size=(
            B, enc_frames, cfg.frontend_dim or cfg.d_model)).astype(
                np.float32), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        enc_out = T._run_encoder(params, frames, cfg, qcfg)
        _sync(dev)
        t_encode = time.perf_counter() - t0

    # warm both steps on a throwaway state, so the timed rows below are
    # steady state
    t0 = time.perf_counter()
    warm = T.init_decode_state(cfg, B, s_max, device=dev, enc_out=enc_out)
    tok0 = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    if args.prefill == "fused":
        _, _, warm = prefill(params, warm, prompts_dev)
    serve(params, warm, tok0)
    _sync(dev)
    del warm
    t_warmup = time.perf_counter() - t0

    state = T.init_decode_state(cfg, B, s_max, device=dev, enc_out=enc_out)
    _sync(dev)
    t0 = time.perf_counter()
    if args.prefill == "fused":
        tok, logits, state = prefill(params, state, prompts_dev)
    else:
        for i in range(args.prompt_len):
            tok, logits, state = serve(params, state,
                                       prompts_dev[:, i:i + 1])
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    generated = [tok]
    for _ in range(args.gen_len - 1):
        tok, logits, state = serve(params, state, tok)
        generated.append(tok)
    out = torch.cat(generated, 1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeResult(out.cpu().numpy(), logits.float().cpu().numpy(),
                       p.t_build, p.t_prepare, t_warmup, t_prefill,
                       t_decode, peak(), t_encode)


def main(argv=None):
    args = build_parser().parse_args(argv)
    with trace.recording(args.trace_out):
        r = run(args)
    B, P, G = args.requests, args.prompt_len, args.gen_len
    n_pre, n_dec = B * P, B * G
    dev = resolve(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] device: {where}")
    print(f"[serve] kernel build: {r.t_build:.2f}s; prepare (init, "
          f"prequantize, calibrate): {r.t_prepare:.2f}s; warmup: "
          f"{r.t_warmup:.2f}s (reported separately — steady-state rows "
          f"below exclude them)")
    if args.continuous:
        N = args.continuous
        print(f"[serve] continuous: {N} requests over {r.slots} slots, "
              f"{r.steps} batched decode steps: {r.t_serve:.3f}s, "
              f"{N * (P + G) / r.t_serve:.1f} tok/s")
    else:
        if r.t_encode:
            print(f"[serve] encoder: {B} x {ENC_FRAMES} frames in "
                  f"{r.t_encode * 1e3:.3f}ms (once, before the warm-up; "
                  f"not in the rows below)")
        print(f"[serve] prefill[{args.prefill}]: {n_pre} tokens in "
              f"{r.t_prefill * 1e3:.3f}ms ({n_pre / r.t_prefill:.1f} tok/s)")
        print(f"[serve] decode: {max(G - 1, 0)} steps in "
              f"{r.t_decode * 1e3:.3f}ms "
              f"({r.t_decode * 1e3 / max(G - 1, 1):.3f} ms/step, "
              f"{B * max(G - 1, 0) / max(r.t_decode, 1e-9):.1f} tok/s)")
        dt = r.t_prefill + r.t_decode
        print(f"[serve] {B} requests, {G} tokens each: {dt:.3f}s "
              f"steady-state, {(n_pre + n_dec) / dt:.1f} tok/s")
    if dev.type == "cuda":
        print(f"[serve] peak device memory: {r.peak_bytes / 2**30:.3f} GiB")
    print("[serve] sample output ids:", r.out[0][:12].tolist())
    return r.out, r.logits


if __name__ == "__main__":
    main()
