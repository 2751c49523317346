#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase catches an
error and carries on:
  1. device    a CUDA card is required; prints nvidia-smi name,power.limit
  2. build     nvcc builds the five kernels from src/repro_torch/kernels/
               csrc (one process per source, all at once); prints ptxas -v
  3. kernels   each kernel against its plain PyTorch version on the card,
               at the serving and training paths' full-width shapes and a
               ragged shape: fused_qdot at M = 1..4 (split-K) and 256,
               with and without compensation, two launches bit-equal;
               lut_matmul pre-shifted, through the offset and on three
               operand patterns
  4. serve     full-width qwen3-1.7b (28 layers, seeded random weights):
               --calibrate 1 with 4 requests, prompt 64, gen 16, in
               asym_u8 and sym_i8; launch counts must match the path, and
               no plain version may see a CUDA tensor
  5. parity    the serving path at 2 layers of full width, same weights,
               table and prompts: every kernel launch of the card's run
               held against its plain version on the CPU from the same
               inputs; the free-running CPU run reported beside it
  6. train     full-width qwen3-1.7b QAT through repro_torch.launch.train,
               --batch 4 --seq 128 (M=512 rows per projection), remat on,
               2 steps each of --backend xla and residual in asym_u8 and
               sym_i8 (one run with --compress-grads, one with
               --microbatches 2); launch counts must match the path; the
               residual sym_i8 run saves its full-width state through
               --ckpt-dir, which restores to tensors equal to it
  7. train parity  one train step at 2 layers of full width on the card
               and on the CPU: every lut_matmul / residual_matmul launch
               held against its plain version on the CPU; the free-running
               loss and gradient gaps reported
  8. timing    each kernel and its plain version with CUDA events at the
               paths' shapes: ``ms`` times back-to-back wrapper calls (what
               a host-driven path pays), ``device_ms`` the same calls
               queued behind a spin on the card (the kernels' device time);
               for the two gather kernels also gathers/s and their share
               of the load/store units' lane rate (SMs x 32 x the SM clock
               nvidia-smi reads beside the timing), lut_matmul on three
               operand patterns (uniform, bank-conflict-free, quantized
               normal)
The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# main path of qwen3-1.7b at full width
ARGS = ["--arch", "qwen3-1.7b", "--requests", "4", "--prompt-len", "64",
        "--gen-len", "16", "--calibrate", "1"]
B, P, G = 4, 64, 16
CALIB_TOKENS = P + 2            # calibrate_decode: prompt + 2 greedy steps
# training path of qwen3-1.7b at full width: --batch 4 --seq 128
TB, TS, TSTEPS = 4, 128, 2
TRAIN_RUNS = [("xla", "asym_u8", ["--compress-grads"]),
              ("xla", "sym_i8", ["--microbatches", "2"]),
              ("residual", "asym_u8", []),
              ("residual", "sym_i8", [])]
CKPT_RUN = ("residual", "sym_i8")          # saves its state: --ckpt-dir
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")
RANK = 32                        # QuantConfig.rank, the launcher's default
# H100 SXM data-sheet rates
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
SOURCES = {
    "delta_matmul": ("src/repro_torch/kernels/csrc/delta_matmul.cu",
                     "src/repro/kernels/approx_matmul.py:136"),
    "fused_qdot": ("src/repro_torch/kernels/csrc/fused_qdot.cu",
                   "src/repro/kernels/approx_matmul.py:266"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/attention.py:137"),
    "lut_matmul": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/approx_matmul.py:375"),
    "residual_matmul": ("src/repro_torch/kernels/csrc/residual_matmul.cu",
                        "src/repro/kernels/approx_matmul.py:440"),
}


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"\n=== {name} ===")


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now (MHz); read right after a
    timing, beside it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, check=True, timeout=60)
    return float(r.stdout.strip().splitlines()[0])


def cuda_time(fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean ms per call of fn() on the card: CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls.

    ``queued`` (a wrapper's ``device_ms``): the calls are queued behind a
    spin on the card (torch.cuda._sleep) at least twice as long as the
    host took to issue them, so the events time the card's work and not
    the host's launch rate; it is checked that the host had issued every
    call before the first one started."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    spin = 0
    if queued:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        spin = int(2 * (time.perf_counter() - t0) * 2e9) + 10**6  # <= 2 GHz
    for _ in range(4):
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not spin or not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        spin *= 4
    raise AssertionError("cuda_time: the card started before the host had "
                         "queued the timed calls")


# ---------------------------------------------------------------------------
# shapes of the main path (per layer of qwen3-1.7b)
# ---------------------------------------------------------------------------

def projection_shapes(cfg):
    D, H, Kv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    # calibration runs the 7 unmerged projections, serving the 4 merged
    unmerged = [("wq", D, H * hd), ("wk", D, Kv * hd), ("wv", D, Kv * hd),
                ("wo", H * hd, D), ("w_gate", D, F), ("w_up", D, F),
                ("w_down", F, D)]
    merged = [("wqkv", D, (H + 2 * Kv) * hd), ("wo", H * hd, D),
              ("w_gateup", D, 2 * F), ("w_down", F, D)]
    return unmerged, merged


def lut_bound(M, K, N):
    nbytes = M * K * 4 + K * N + 65536 * 2 + M * N * 4
    return nbytes / HBM_BPS, 2 * M * K * N / INT8_OPS


def residual_bound(M, K, N, r):
    """A@B + F[a]G[b] summed over k is sum_k C[a, b] beside the exact
    product, over one (256, 256) float32 table C = F G: lut_matmul's
    structure, counted by its convention (F and G read once)."""
    nbytes = M * K * 4 + K * N + 2 * 256 * r * 4 + M * N * 4
    return nbytes / HBM_BPS, 2 * M * K * N / INT8_OPS


def delta_bound(M, K, N):
    nbytes = M * K * 4 + K * N + 65536 * 2 + M * N * 4
    return nbytes / HBM_BPS, 2 * M * K * N / INT8_OPS


def fused_bound(M, K, N):
    nbytes = M * K * 4 + K * N + 65536 * 2 + 4 * N * 4 + 8 * 4 + 256 * 4 \
        + M * N * 4
    return nbytes / HBM_BPS, 2 * M * K * N / INT8_OPS


def attention_bound(Bq, H, Kv, hd, pos):
    # cache rows t <= pos are read (the kernel skips the rest), once each
    nbytes = (Bq * H * hd * 4 + 2 * Bq * Kv * hd * 4 + 2 * hd * 4
              + 2 * Bq * (pos + 1) * Kv * hd * 2 + Bq * H * hd * 4
              + 2 * Bq * Kv * hd * 2 + Bq * 4)
    flops = 4 * Bq * H * (pos + 1) * hd
    return nbytes / HBM_BPS, flops / F32_FLOPS


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def check_kernels(cfg, dev):
    import torch
    from repro_torch.kernels import check, ops
    unmerged, merged = projection_shapes(cfg)
    errs = {"delta_matmul": 0.0, "fused_qdot": 0.0, "decode_attention": 0.0}
    for signed in (False, True):
        mode = "sym_i8" if signed else "asym_u8"
        for i, (name, K, N) in enumerate(unmerged + [("ragged", 77, 131)]):
            M = 5 if name == "ragged" else B
            case = check.delta_case(M, K, N, signed, i, dev)
            check.check_delta(case)
            assert torch.equal(ops.delta_matmul(**case),
                               ops.delta_matmul(**case)), "not repeatable"
            log(f"[kernels] delta_matmul {mode} {name} M={M} K={K} N={N}: "
                f"bit-exact, two launches bit-equal")
        # decode (M = B and below: the split-K schedule) and prefill
        # (M = B*P: the tile schedule), with and without compensation
        for i, (name, K, N) in enumerate(merged + [("ragged", 77, 131)]):
            for M in ((1, 2, 3, 70) if name == "ragged"
                      else (1, 2, 3, B, B * P)):
                for comp in (True, False):
                    case = check.fused_case(M, K, N, signed, 100 + i, dev,
                                            compensate=comp)
                    r = check.check_fused(case)
                    first = ops.fused_qdot_packed(**case, return_int=True)
                    again = ops.fused_qdot_packed(**case, return_int=True)
                    assert all(torch.equal(x, y) for x, y in
                               zip(first, again)), "fused_qdot not repeatable"
                    errs["fused_qdot"] = max(errs["fused_qdot"],
                                             r["max_abs_err"])
                    log(f"[kernels] fused_qdot {mode} {name} M={M} K={K} "
                        f"N={N} compensate={comp}: qx, acc bit-exact; max "
                        f"|err| {r['max_abs_err']:.3e} "
                        f"({r['max_rel_err']:.3e} of max |y|); two launches "
                        f"bit-equal")
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    cases = [("decode, per-slot pos", dict(B=B, S=P + G, pos=[64, 70, 75, 79])),
             ("decode, one pos", dict(B=B, S=P + G, per_slot=False)),
             ("calibration", dict(B=B, S=CALIB_TOKENS, pos=[0, 1, 33, 65])),
             ("ragged + window", dict(B=3, S=77, window=20))]
    for i, (name, kw) in enumerate(cases):
        Bq, S = kw.pop("B"), kw.pop("S")
        r = check.check_attention(check.attention_case(Bq, S, H, Kv, hd, i,
                                                       dev, **kw))
        errs["decode_attention"] = max(errs["decode_attention"],
                                       r["max_abs_err"])
        log(f"[kernels] decode_attention {name} B={Bq} S={S}: v rows "
            f"bit-exact, {r['row_flips']} of {r['row_entries']} k-row "
            f"entries one bf16 step apart, max |out err| "
            f"{r['max_abs_err']:.3e}")
    return errs


def train_kinds(cfg):
    """The distinct (K, N) of a training layer's projections, each with
    the projections that have it."""
    kinds = {}
    for name, K, N in projection_shapes(cfg)[0]:     # the 7 unmerged
        kinds.setdefault((K, N), []).append(name)
    return [("/".join(v), K, N) for (K, N), v in kinds.items()]


def check_train_kernels(cfg, dev, errs):
    """lut_matmul and residual_matmul against their plain versions at the
    training projections' shapes (M = TB*TS) and a ragged shape, both
    modes; lut_matmul also on the 65,536-pair sweep."""
    import torch
    from repro_torch.kernels import check, ops
    M = TB * TS
    errs["lut_matmul"] = errs["residual_matmul"] = 0.0
    shapes = train_kinds(cfg) + [("ragged", 131, 45)]
    for signed in (False, True):
        mode = "sym_i8" if signed else "asym_u8"
        for design in ("design2", "exact"):
            vals = torch.arange(256, dtype=torch.int32)
            case = dict(check.lut_case(1, 1, 1, signed, 0, dev,
                                       design=design),
                        a=vals[:, None].contiguous().to(dev),
                        b=vals[None, :].to(torch.uint8).contiguous().to(dev))
            check.check_lut(case)
            table = (ops.get_signed_lut if signed else ops.get_lut)(design)
            got = ops.lut_matmul(**case).cpu().numpy()
            assert (got == table).all(), "lut_matmul != gate-level table"
            for i, (name, K, N) in enumerate(shapes):
                m = 77 if name == "ragged" else M
                check.check_lut(check.lut_case(m, K, N, signed, 200 + i, dev,
                                               design=design))
                # as the 'xla' backend passes them: int8 b, offset 128
                check.check_lut(check.lut_case(m, K, N, signed, 250 + i, dev,
                                               design=design, shifted=False))
                log(f"[kernels] lut_matmul {mode} {design} {name} M={m} "
                    f"K={K} N={N}: bit-exact, pre-shifted and through the "
                    f"offset (and the 65,536-pair sweep equals the "
                    f"gate-level table)")
        for pattern in check.LUT_PATTERNS[1:]:   # uniform: above
            for i, (name, K, N) in enumerate(train_kinds(cfg)):
                check.check_lut(check.lut_case(M, K, N, signed, 260 + i, dev,
                                               pattern=pattern,
                                               shifted=False))
                log(f"[kernels] lut_matmul {mode} {pattern} operands {name} "
                    f"M={M} K={K} N={N}: bit-exact")
        for rank in (4, RANK, 256):
            for i, (name, K, N) in enumerate(shapes):
                if rank == 256 and name not in ("ragged", "wk/wv"):
                    continue       # r=256: one full-width shape suffices
                m = 77 if name == "ragged" else M
                r = check.check_residual(check.residual_case(
                    m, K, N, signed, rank, 300 + i, dev))
                errs["residual_matmul"] = max(errs["residual_matmul"],
                                              r["max_abs_err"])
                log(f"[kernels] residual_matmul {mode} r={rank} {name} "
                    f"M={m} K={K} N={N}: max |err| {r['max_abs_err']:.3e} "
                    f"({r['max_rel_err']:.3e} of max |out|; tolerance "
                    f"{check.RESID_TOL_REL})")


class PlainGuard:
    """Makes the plain versions raise if the main path hands them a CUDA
    tensor (the wrappers must launch the kernels instead)."""

    NAMES = ("delta_matmul_ref", "fused_qdot_ref", "decode_attention_step_ref",
             "lut_matmul_ref", "approx_matmul_ref",
             "residual_corrected_matmul_ref")

    def __enter__(self):
        import torch
        from repro_torch.kernels import ref
        self.saved = {n: getattr(ref, n) for n in self.NAMES}

        def guard(name, fn):
            def wrapped(*a, **k):
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in list(a) + list(k.values())):
                    raise AssertionError(f"plain {name} called on the card")
                return fn(*a, **k)
            return wrapped
        for n, fn in self.saved.items():
            setattr(ref, n, guard(n, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        for n, fn in self.saved.items():
            setattr(ref, n, fn)


def serve_full_width(cfg):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    L = cfg.n_layers
    want = {"delta_matmul": 7 * L * CALIB_TOKENS,
            # warm prefill + warm decode + timed prefill + G-1 decode steps
            "fused_qdot": 4 * L * (G + 2),
            "decode_attention": L * (CALIB_TOKENS + G),
            "lut_matmul": 0, "residual_matmul": 0}
    totals = dict.fromkeys(want, 0)
    rows = {}
    for mode in ("asym_u8", "sym_i8"):
        args = serve.build_parser().parse_args(ARGS + ["--quant-mode", mode])
        with PlainGuard():
            ops.reset_launches()
            r = serve.run(args)
            counts = dict(ops.LAUNCHES)
        log(f"[serve] {mode}: kernel build {r.t_build:.3f}s, prepare "
            f"(init + prequantize + calibrate) {r.t_prepare:.3f}s, warmup "
            f"{r.t_warmup:.3f}s")
        log(f"[serve] {mode}: prefill {B}x{P} tokens {r.t_prefill * 1e3:.3f} "
            f"ms ({B * P / r.t_prefill:.1f} tok/s); decode "
            f"{r.t_decode * 1e3 / (G - 1):.3f} ms/step over {G - 1} steps; "
            f"peak device memory {r.peak_bytes / 2**30:.3f} GiB")
        log(f"[serve] {mode}: launches {counts} (expected {want})")
        log(f"[serve] {mode}: sample output ids {r.out[0][:12].tolist()}")
        assert counts == want, f"{mode}: launch counts {counts} != {want}"
        assert r.out.shape == (B, G), r.out.shape
        assert ((r.out >= 0) & (r.out < cfg.vocab)).all()
        assert r.logits.shape == (B, 1, cfg.vocab), r.logits.shape
        assert np.isfinite(r.logits).all(), "non-finite logits"
        for k in totals:
            totals[k] += counts[k]
        rows[mode] = {"prefill_ms": r.t_prefill * 1e3,
                      "prefill_tok_s": B * P / r.t_prefill,
                      "decode_ms_per_step": r.t_decode * 1e3 / (G - 1),
                      "peak_gib": r.peak_bytes / 2**30}
        torch.cuda.empty_cache()
    log("[serve] " + json.dumps({"serve": rows}))
    return totals


def _serve_once(cfg, params, q, table, cal, prompts, gen, dev):
    """prequantize -> (calibrate) -> install -> prefill -> greedy decode."""
    import torch
    from repro_torch import calib
    from repro_torch.models import transformer as T
    from repro_torch.quant import fuse_projections, prequantize_weights
    from repro_torch.train import make_prefill_step, make_serve_step
    b, p = prompts.shape
    tree = prequantize_weights(params, q)
    if table is None:
        table = calib.calibrate_decode(tree, cfg, q, cal, gen_len=2,
                                       device=dev)
    tree = calib.apply_calibration(tree, table)
    tree = fuse_projections(calib.attach_comp_cols(tree, q))
    st = T.init_decode_state(cfg, b, p + gen, device=dev)
    tok, lg, st = make_prefill_step(cfg, q)(
        tree, st, torch.as_tensor(prompts, device=dev))
    toks, lgs = [tok], [lg]
    step = make_serve_step(cfg, q)
    for _ in range(gen - 1):
        tok, lg, st = step(tree, st, tok)
        toks.append(tok)
        lgs.append(lg)
    return (table, torch.cat(toks, 1).cpu(), [x.float().cpu() for x in lgs],
            {k: st["caches"][0][k].float().cpu() for k in ("k", "v")})


def parity_two_layers(cfg_full):
    """Full width, depth 2, the same weights, calibration table and
    prompts.  Asserted: every kernel launch of the card's run equals its
    plain version run on the CPU from the same inputs (CpuShadow).
    Reported: the free-running card run against the free-running CPU run
    of the plain versions.  Those two are not asserted equal: PyTorch's
    CPU and CUDA glue ops (reduction order in rmsnorm and softmax, libm
    ulps in rsqrt/exp/cos/sin, BLAS order in attention) differ by float32
    ulps, a few activations per forward then land on the other side of a
    static quantization step, and this random-weight model amplifies each
    flipped step from projection to projection (PERF.md)."""
    import numpy as np
    import torch
    from repro_torch.kernels import check
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    cfg = dataclasses.replace(cfg_full, n_layers=2)
    b, p, g = 2, 8, 4
    torch.set_num_threads(os.cpu_count() or 1)
    params_cpu = T.init_params(torch.Generator().manual_seed(1), cfg,
                               device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to("cuda")
    params_gpu = to_card(params_cpu)
    rng = np.random.default_rng(3)
    cal = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    for mode in ("asym_u8", "sym_i8"):
        q = QuantConfig(design="design2", backend="fused", mode=mode,
                        inference=True)
        t0 = time.perf_counter()
        with check.CpuShadow() as sh:
            table, ids_g, lg_g, c_g = _serve_once(cfg, params_gpu, q, None,
                                                  cal, prompts, g, "cuda")
        for n, st in sh.stats.items():
            assert st["calls"] > 0, f"{n} never launched"
            log(f"[parity] {mode} {n}: {st['calls']} launches held against "
                f"the CPU plain version; max |err| {st['max_abs_err']:.3e}"
                + (f"; {st['row_flips']} of {st['row_entries']} k-row "
                   f"entries one bf16 step apart" if st["row_entries"]
                   else ""))
        log(f"[parity] {mode} card run with CPU shadows: "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        _, ids_c, lg_c, c_c = _serve_once(cfg, params_cpu, q, table, cal,
                                          prompts, g, "cpu")
        gap = max(float((a - c).abs().max()) for a, c in zip(lg_g, lg_c))
        scale = max(float(c.abs().max()) for c in lg_c)
        flips = {k: int((c_g[k] != c_c[k]).sum()) for k in c_g}
        log(f"[parity] {mode} free-running card vs CPU "
            f"({time.perf_counter() - t0:.1f}s, not asserted): ids card "
            f"{ids_g.tolist()} cpu {ids_c.tolist()}; max |logit gap| "
            f"{gap:.3e} (max |logit| {scale:.3e}); cache entries that "
            f"differ: {flips} of {c_g['k'].numel()} each")


def train_full_width(cfg):
    """The training path at full width through the launcher, one run per
    (backend, mode); returns the launches of the two training kernels."""
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    L = cfg.n_layers
    totals = {"lut_matmul": 0, "residual_matmul": 0}
    rows = {}
    for backend, mode, extra in TRAIN_RUNS:
        ckpt_run = (backend, mode) == CKPT_RUN
        if ckpt_run:
            shutil.rmtree(CKPT_DIR, ignore_errors=True)
            extra = extra + ["--ckpt-dir", CKPT_DIR]
        argv = ["--arch", "qwen3-1.7b", "--batch", str(TB), "--seq", str(TS),
                "--steps", str(TSTEPS), "--backend", backend,
                "--quant-mode", mode, "--log-every", "1"] + extra
        mb = int(extra[1]) if "--microbatches" in extra else 1
        kernel = "lut_matmul" if backend == "xla" else "residual_matmul"
        # 7 projections x layers x (forward + remat recompute) per
        # microbatch, every step
        want = dict.fromkeys(ops.LAUNCHES, 0)
        want[kernel] = 7 * L * 2 * mb * TSTEPS
        with PlainGuard():
            ops.reset_launches()
            r = train.run(train.parse_args(argv))
            counts = dict(ops.LAUNCHES)
        tag = f"{backend} {mode} {' '.join(extra)}".strip()
        log(f"[train] {tag}: losses {r.losses}, grad norms {r.grad_norms}")
        log(f"[train] {tag}: ms per step {[t * 1e3 for t in r.step_s]}; "
            f"peak device memory {r.peak_bytes / 2**30:.3f} GiB")
        log(f"[train] {tag}: launches {counts} (expected {want})")
        assert counts == want, f"{tag}: launch counts {counts} != {want}"
        assert len(r.losses) == TSTEPS
        assert all(math.isfinite(x) for x in r.losses + r.grad_norms), tag
        totals[kernel] += counts[kernel]
        rows[tag] = {"ms_per_step": [t * 1e3 for t in r.step_s],
                     "losses": r.losses, "grad_norms": r.grad_norms,
                     "peak_gib": r.peak_bytes / 2**30}
        if ckpt_run:
            checkpoint_round_trip(r)
        del r
        torch.cuda.empty_cache()
    log("[train] " + json.dumps({"train": rows}))
    return totals


def checkpoint_round_trip(r):
    """The full-width state a --ckpt-dir run ended with (weights, both
    moments, step) restores from its checkpoint onto the card equal, leaf
    by leaf; then the checkpoint is deleted."""
    import torch
    from repro_torch.train import checkpoint as ckpt
    try:
        path = os.path.join(CKPT_DIR, f"step_{TSTEPS:08d}")
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        free = shutil.disk_usage(CKPT_DIR).free
        tmpl = {"params": r.params, "opt": r.opt_state}
        t0 = time.perf_counter()
        restored, step = ckpt.restore(CKPT_DIR, tmpl)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        assert step == TSTEPS, step
        want, got = ckpt._flatten(tmpl), ckpt._flatten(restored)
        assert list(want) == list(got)
        for k, a in want.items():
            assert a.device == got[k].device and a.dtype == got[k].dtype \
                and torch.equal(a, got[k]), k
        log(f"[train] checkpoint round trip at full width: step {step}, "
            f"{len(want)} tensors, {nbytes / 1e9:.3f} GB on disk "
            f"({free / 1e9:.1f} GB free beside it), restored (sha256 "
            f"checked) onto {a.device} in {dt:.1f}s, all equal")
        del restored, got
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def train_parity_two_layers(cfg_full):
    """One train step at 2 layers of full width, the same weights and
    batch, on the card and on the CPU.  Asserted: every lut_matmul /
    residual_matmul launch of the card's step equals its plain version on
    the CPU from the same inputs (CpuShadow), with the path's launch
    count.  Reported: the free-running loss and gradient gaps (a float32
    ulp of PyTorch's CPU and CUDA glue can flip a dynamic quantization
    step, and the random-weight model amplifies each flip)."""
    import numpy as np
    import torch
    from repro_torch.kernels import check
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    cfg = dataclasses.replace(cfg_full, n_layers=2)
    torch.set_num_threads(os.cpu_count() or 1)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (1, 17)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    ocfg = OptConfig(warmup_steps=5, total_steps=100)
    for backend, mode in (("xla", "asym_u8"), ("residual", "sym_i8")):
        name = "lut_matmul" if backend == "xla" else "residual_matmul"
        q = QuantConfig(design="design2", backend=backend, mode=mode)
        step = make_train_step(cfg, q, ocfg, remat=True)
        p_cpu = T.init_params(torch.Generator().manual_seed(1), cfg,
                              device="cpu")
        p0 = opt_mod.tree_map(torch.clone, p_cpu)
        p_gpu = opt_mod.tree_map(lambda t: t.to("cuda", copy=True), p_cpu)
        t0 = time.perf_counter()
        with check.CpuShadow(check.CpuShadow.TRAIN) as sh:
            p_gpu, _, m_gpu = step(p_gpu, opt_mod.init(p_gpu, ocfg),
                                   {k: v.to("cuda") for k, v in
                                    batch.items()})
        st = sh.stats[name]
        want = 7 * cfg.n_layers * 2
        assert st["calls"] == want, (name, st["calls"], want)
        log(f"[train parity] {backend} {mode}: {st['calls']} {name} "
            f"launches held against the CPU plain version; max |err| "
            f"{st['max_abs_err']:.3e} ({time.perf_counter() - t0:.1f}s)")
        t0 = time.perf_counter()
        p_cpu, _, m_cpu = step(p_cpu, opt_mod.init(p_cpu, ocfg), batch)
        upd_c = torch.cat([(a - b).reshape(-1) for a, b in zip(
            opt_mod.tree_leaves(p_cpu), opt_mod.tree_leaves(p0))])
        upd_g = torch.cat([(a.cpu() - b).reshape(-1) for a, b in zip(
            opt_mod.tree_leaves(p_gpu), opt_mod.tree_leaves(p0))])
        gap = float((upd_g - upd_c).norm() / upd_c.norm())
        log(f"[train parity] {backend} {mode} free-running card vs CPU "
            f"({time.perf_counter() - t0:.1f}s, not asserted): loss "
            f"{float(m_gpu['loss'])!r} vs {float(m_cpu['loss'])!r}; "
            f"grad_norm {float(m_gpu['grad_norm'])!r} vs "
            f"{float(m_cpu['grad_norm'])!r}; parameter update gap "
            f"{gap:.3e} of its norm")
        del p_gpu, p_cpu, p0
        torch.cuda.empty_cache()


def time_kernels(cfg, dev, launches, errs):
    import torch
    from repro_torch.kernels import check, ops, ref
    unmerged, merged = projection_shapes(cfg)
    rows, summary = [], {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def row(kernel, shape, fn, iters, plain_ms, bounds, gathers=None,
            b=None, offset=0):
        """One timing row.  ``gathers`` (the gather kernels: M*K*N table
        reads a call) adds the gather rate over device_ms and its share of
        the load/store units' lane rate, SMs x 32 lanes x the SM clock
        read right after the timing, and the mean wavefronts a warp's
        gather costs on the weights ``b`` (check.gather_wavefronts)."""
        b_bytes, b_ops = bounds
        r = {"kernel": kernel, "shape": shape, "ms": cuda_time(fn, iters),
             "device_ms": cuda_time(fn, iters, queued=True),
             "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops) * 1e3,
             "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
        if gathers is not None:
            clock = sm_clock_mhz()
            rate = gathers / (r["device_ms"] * 1e-3)
            r.update(sm_clock_mhz=clock, gathers_per_s=rate,
                     gather_share=rate / (sms * 32 * clock * 1e6),
                     wavefronts=check.gather_wavefronts(b, offset))
        rows.append(r)
        log("[timing] " + json.dumps(r))
        return r

    def mean(rs, weights):
        tot = sum(weights)
        keys = ["ms", "device_ms", "plain_ms", "bound_ms"]
        keys += ["gather_share"] if "gather_share" in rs[0] else []
        return {k: sum(r[k] * w for r, w in zip(rs, weights)) / tot
                for k in keys}

    # delta_matmul: the 7 calibration projections of a layer, M = B, asym
    rs = []
    for i, (name, K, N) in enumerate(unmerged):
        c = check.delta_case(B, K, N, False, i, dev)
        rs.append(row("delta_matmul", f"{name} M={B} K={K} N={N}",
                      lambda: ops.delta_matmul(**c), 50,
                      cuda_time(lambda: ref.delta_matmul_ref(**c), 5),
                      delta_bound(B, K, N)))
    summary["delta_matmul"] = (mean(rs, [1] * len(rs)), rs)

    # fused_qdot: the 4 merged projections at decode (M=B) and prefill
    # (M=B*P), weighted by the serve run's forwards (2 prefill, G decode)
    rs, w = [], []
    for i, (name, K, N) in enumerate(merged):
        for M, weight in ((B, G), (B * P, 2)):
            c = check.fused_case(M, K, N, False, 100 + i, dev)
            it = 50 if M == B else 10
            rs.append(row("fused_qdot", f"{name} M={M} K={K} N={N}",
                          lambda: ops.fused_qdot_packed(**c), it,
                          cuda_time(lambda: ref.fused_qdot_ref(
                              c["x"], c["qw"], c["dlut"], c["scal"],
                              c["ntab"], c["comp_r"], 0, True, True), 3),
                          fused_bound(M, K, N), gathers=M * K * N,
                          b=c["qw"]))
            w.append(weight)
    summary["fused_qdot"] = (mean(rs, w), rs)

    # decode_attention: mid-decode position (P + G/2) over an S=P+G cache
    pos = P + G // 2
    c = check.attention_case(B, P + G, cfg.n_heads, cfg.n_kv, cfg.hd, 7,
                             dev, pos=[pos] * B)
    r = row("decode_attention", f"B={B} H={cfg.n_heads} Kv={cfg.n_kv} "
            f"hd={cfg.hd} S={P + G} pos={pos}",
            lambda: ops.decode_attention_step(**c), 200,
            cuda_time(lambda: ref.decode_attention_step_ref(**c), 50),
            attention_bound(B, cfg.n_heads, cfg.n_kv, cfg.hd, pos))
    summary["decode_attention"] = (
        {k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
        [r])

    # lut_matmul and residual_matmul: the training projections at
    # M = TB*TS, weighted by how many projections of a layer have each shape
    M = TB * TS
    for kname, tag in (("lut_matmul", "lut"), ("residual_matmul", "resid")):
        rs, w = [], []
        for i, (name, K, N) in enumerate(train_kinds(cfg)):
            signed = False
            if tag == "lut":
                # the uniform operands of every earlier run (the JSON
                # line's row), then the bank-conflict-free and the
                # quantized-normal ones (check.lut_indices)
                for pattern in check.LUT_PATTERNS:
                    c = check.lut_case(M, K, N, signed, 400 + i, dev,
                                       pattern=pattern)
                    r = row(kname, f"{name} M={M} K={K} N={N} {pattern}",
                            lambda: ops.lut_matmul(**c), 10,
                            cuda_time(lambda: check.lut_plain(c), 2),
                            lut_bound(M, K, N), gathers=M * K * N,
                            b=c["b"], offset=c["offset"])
                    if pattern == "uniform":
                        rs.append(r)
            else:
                c = check.residual_case(M, K, N, signed, RANK, 500 + i, dev)
                rs.append(row(kname, f"{name} M={M} K={K} N={N} r={RANK}",
                              lambda: ops.residual_matmul(**c), 5,
                              cuda_time(lambda: ref.
                                        residual_corrected_matmul_ref(**c),
                                        2),
                              residual_bound(M, K, N, RANK)))
            w.append(name.count("/") + 1)
        summary[kname] = (mean(rs, w), rs)

    kernels = []
    for name, (m, rs) in summary.items():
        src, replaces = SOURCES[name]
        by = [x["bound_by"] for x in rs]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": m["ms"],
            "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": max(set(by), key=by.count), "library_ms": None,
            **({"gather_share": m["gather_share"]} if "gather_share" in m
               else {})})
    log("[timing] library_ms is null: no single PyTorch call computes the "
        "approximate (delta-table) product, the fused quantize-product-"
        "dequant, the qk-norm/rope/bf16-row decode attention step, the "
        "product-LUT gather sum or the exact product plus the "
        "correction-table gather sum")
    return kernels


def main() -> int:
    t_start = time.perf_counter()
    phase("1. device")
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false: this script needs a "
            "CUDA card")
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch import configs
        from repro_torch.kernels import _build
    except ImportError as e:
        log(f"FAIL: the port's package is missing next to this script "
            f"({e})")
        return 3
    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    log(f"[device] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} libraries compiled in "
        f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")
    for name, text in logs.items():
        log(f"[build] {name}: nvcc {' '.join(_build.NVCC_FLAGS)}")
        for line in text.splitlines():
            if "ptxas" in line and ("Used" in line or "Compiling" in line
                                    or "spill" in line):
                log(f"[build]   {line.strip()}")
    for name in _build.KERNELS:
        _build.kernel(name)

    cfg = configs.get("qwen3-1.7b")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        phase("3. kernels against their plain versions")
        errs = check_kernels(cfg, dev)
        check_train_kernels(cfg, dev, errs)
        phase("4. full-width serve (main path)")
        launches = serve_full_width(cfg)
        phase("5. slice parity: card vs CPU at 2 layers of full width")
        parity_two_layers(cfg)
    # training needs autograd: outside the no_grad block
    phase("6. full-width QAT training")
    launches.update(train_full_width(cfg))
    phase("7. train parity: card vs CPU at 2 layers of full width")
    train_parity_two_layers(cfg)
    with torch.no_grad():
        phase("8. timing")
        kernels = time_kernels(cfg, dev, launches, errs)
    log(f"\n[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
