"""Batched-request serving driver: fused full-sequence prefill + batched
greedy decode with a KV cache, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 4 --prompt-len 64 --gen-len 16 --calibrate 1

Quantization precomputation ladder (quant/linear.py):
  --prequantize      cache weight quantization once (q/scale/zp/colsum)
  --calibrate N      run N calibration batches token by token through the
                     decode path and fix STATIC per-layer activation
                     scales; the backend is then 'fused': one kernel
                     quantizes, multiplies and dequantizes each projection
  --clip MODE        activation-range calibrator: minmax | pct999 | mse
  --plan FILE        serve a per-layer design plan (calib.plan, ``python
                     -m repro_torch.calib``): each layer's projections
                     gather their own design's delta table, a row of the
                     site's bank
--calibrate and --plan imply --prequantize and the 'fused' backend (the
unfused projections, without static scales, take delta_matmul).  The
order is prequantize -> calibrate -> apply_plan -> attach_comp_cols ->
fuse_projections.  With prequantized weights the attention wq|wk|wv and
mlp gate|up projections are merged where their tables agree
(--no-fuse-proj keeps them apart).

Timing is steady state: the kernels are built and both steps warmed up
first (reported on their own lines), and each timed region starts and
ends with torch.cuda.synchronize().
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import configs
from ..device import resolve
from ..models import transformer as T
from ..quant import QuantConfig
from ..train import make_prefill_step, make_serve_step


def _calibration_prompts(cfg, rng, batches: int, requests: int,
                         prompt_len: int):
    return [rng.integers(0, cfg.vocab, (requests, prompt_len))
            .astype(np.int32) for _ in range(batches)]


def prepare_params(params, cfg, qcfg, args, device="cuda"):
    """Apply the requested precomputation ladder to a params tree.
    Returns (params, notes).  Calibration draws from its own rng (seed
    4242), so enabling --calibrate never shifts the serving prompts."""
    from ..quant import fuse_projections, prequantize_weights
    notes = []
    if not (args.prequantize or args.calibrate or args.plan):
        return params, notes
    params = prequantize_weights(params, qcfg)
    notes.append("prequantized weights")
    if args.calibrate:
        from ..calib import apply_calibration, calibrate_decode
        crng = np.random.default_rng(4242)
        table = None
        for prompts in _calibration_prompts(cfg, crng, args.calibrate,
                                            args.requests,
                                            args.prompt_len):
            t = calibrate_decode(params, cfg, qcfg, prompts, gen_len=2,
                                 device=device)
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
    return params, notes


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
    ap.add_argument("--quant-mode", default="asym_u8",
                    choices=["asym_u8", "sym_i8"])
    ap.add_argument("--prequantize", action="store_true",
                    help="quantize the weights once up front")
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="run N calibration batches and serve with STATIC "
                         "activation scales through the fused kernel")
    ap.add_argument("--clip", default="minmax",
                    choices=["minmax", "pct999", "mse"])
    ap.add_argument("--prefill", default="fused", choices=["fused", "loop"],
                    help="'fused' = one full-sequence M=B*S pass, 'loop' = "
                         "token by token through the decode step")
    ap.add_argument("--plan", default=None, metavar="FILE",
                    help="DesignPlan JSON: serve its per-layer designs "
                         "(implies --prequantize and the fused backend)")
    ap.add_argument("--no-fuse-proj", action="store_true",
                    help="keep wq/wk/wv and w_gate/w_up as separate calls")
    ap.add_argument("--device", default="cuda")
    return ap


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


@torch.no_grad()
def run(args) -> ServeResult:
    """Serve as ``main`` does and return the outputs and timings."""
    dev = resolve(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    qcfg = QuantConfig(design=args.design,
                       backend=("fused" if args.calibrate or args.plan
                                else "delta"),
                       mode=args.quant_mode, inference=True)
    B = args.requests
    s_max = args.prompt_len + args.gen_len
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
    rng = np.random.default_rng(0)
    params, notes = prepare_params(params, cfg, qcfg, args, device=dev)
    _sync(dev)
    t_prepare = time.perf_counter() - t0
    for n in notes:
        print(f"[serve] {n}")

    prompts = rng.integers(0, cfg.vocab, (B, args.prompt_len)).astype(
        np.int32)
    prompts_dev = torch.as_tensor(prompts, device=dev)
    serve = make_serve_step(cfg, qcfg)
    prefill = make_prefill_step(cfg, qcfg)

    # warm both steps on a throwaway state, so the timed rows below are
    # steady state
    t0 = time.perf_counter()
    warm = T.init_decode_state(cfg, B, s_max, device=dev)
    tok0 = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    if args.prefill == "fused":
        _, _, warm = prefill(params, warm, prompts_dev)
    serve(params, warm, tok0)
    _sync(dev)
    del warm
    t_warmup = time.perf_counter() - t0

    state = T.init_decode_state(cfg, B, s_max, device=dev)
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
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return ServeResult(out.cpu().numpy(), logits.float().cpu().numpy(),
                       t_build, t_prepare, t_warmup, t_prefill, t_decode,
                       peak)


def main(argv=None):
    args = build_parser().parse_args(argv)
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
    print(f"[serve] prefill[{args.prefill}]: {n_pre} tokens in "
          f"{r.t_prefill * 1e3:.3f}ms ({n_pre / r.t_prefill:.1f} tok/s)")
    print(f"[serve] decode: {max(G - 1, 0)} steps in "
          f"{r.t_decode * 1e3:.3f}ms "
          f"({r.t_decode * 1e3 / max(G - 1, 1):.3f} ms/step, "
          f"{B * max(G - 1, 0) / max(r.t_decode, 1e-9):.1f} tok/s)")
    dt = r.t_prefill + r.t_decode
    print(f"[serve] {B} requests, {G} tokens each: {dt:.3f}s steady-state, "
          f"{(n_pre + n_dec) / dt:.1f} tok/s")
    if dev.type == "cuda":
        print(f"[serve] peak device memory: {r.peak_bytes / 2**30:.3f} GiB")
    print("[serve] sample output ids:", r.out[0][:12].tolist())
    return r.out, r.logits


if __name__ == "__main__":
    main()
