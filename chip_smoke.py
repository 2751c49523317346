#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and design-plan paths,
the options of launch.serve, the MoE family, the other decoder-only
families, the encoder-decoder and the VLM, the paper's own
applications, tables and examples, the multi-device modules (the dry
run of the production meshes, the cache-free prefill) and the QAT
training of every family on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and no phase catches an
error and carries on:
  1. device    a CUDA card is required; prints nvidia-smi name,power.limit
  2. build     nvcc builds the five kernels from src/repro_torch/kernels/
               csrc (one process per source, all at once); prints ptxas -v
  3. kernels   each kernel against its plain PyTorch version on the card,
               at the serving and training paths' full-width shapes and a
               ragged shape: fused_qdot at M = 1..4, 5 and 7 (split-K,
               4 and 8 rows a thread), 70 and 256 (tile), and at
               minitron-8b's four merged projections at M = 8, with
               and without compensation, two launches bit-equal;
               lut_matmul pre-shifted, through the offset and on three
               operand patterns; decode_attention at the path's cases,
               at long context (S_max 4096), on both sides of every chunk
               edge, with a window across one, two launches bit-equal,
               and with the append (the caches' other rows unchanged);
               the unsigned 'initial' through its biased uint16 table
               (the 65,536-pair sweep through delta_matmul and fused_qdot
               on both schedules, and the path's shapes); a 3-table plan
               bank, each row bit-equal to the table alone; delta_matmul
               at the planned QAT step's M = 512; the MoE family's shapes
               (full width): fused_qdot at every serve projection of a
               layer at decode and prefill M (the routers' N = 8 and 16
               also at M = 1..4, 20 and 80, two launches bit-equal), the
               experts also at the degenerate activation scale 1e-8,
               delta_matmul at every calibration projection (M = 4), and
               decode_attention at query groups 32/8 and 40/8, qk-norm
               off, mixtral's window of 4096 at S_max 4608 past it; the
               other families' shapes (phase 14's configs, full width):
               delta_matmul at every calibration projection and
               fused_qdot at every serve projection (M = 4, both modes:
               the mLSTM gates' N = 4, nemotron's K and N = 73,728, the
               recurrent D x D and D x R), the int32 range at K = 73,728
               through both (sums past 2^31 wrap as the reference's; the
               card's plain version held to the CPU's too), and
               decode_attention at 96/8 hd 192, 10/1 hd 256 under the
               window of 2048 (positions past it, the chunk edges),
               16/16 hd 256 and a group of 16 at hd 256 (shared memory
               above 48 KiB); phase 15's shapes: fused_qdot at whisper's
               serve projections (K = 768 / 3,072, M = 4, 64, 256 and
               6,000) and delta_matmul at its calibration ones (M = 4
               and 64), both modes, decode_attention at 12/12 hd 64 (the
               serve and calibration positions, the chunk edges of 448),
               lut_matmul at internvl2's merged projections (M = 4 both
               modes, 256 asym_u8) and its prefix (M = 512, K = 3,200);
               phase 18's distinct training projections, once each:
               lut_matmul asym_u8 and residual_matmul sym_i8 (the MoE
               experts at M = 160 and 40, the routers' N = 8 and 16, the
               mLSTM gates' N = 4, whisper's encoder and cross k/v at
               M = 6,000, internvl2 at M = 1,536 with K up to 28,672 and
               its prefix at M = 1,024), two launches bit-equal
  4. serve     full-width qwen3-1.7b (28 layers, seeded random weights):
               --calibrate 1 with 4 requests, prompt 64, gen 16, in
               asym_u8 and sym_i8; launch counts must match the path, and
               no plain version may see a CUDA tensor (the asym_u8 run's
               calibration table is kept for phase 12)
  5. parity    the serving path at 1 layer of full width (PARITY_LAYERS):
               every kernel launch of the card's run held against its
               plain version from the same inputs, on the CPU or, for a
               product launch above PARITY_CARD_GATHERS gathers (for
               time), on the card (the attention's appended
               rows read from the card's caches, every other row held
               to a copy from before the call; the free-running CPU run
               beside it dropped to buy phase 17's time);
               and --design initial asym_u8 uncalibrated ('delta') and
               calibrated ('fused'), held launch by launch
  6. train     full-width qwen3-1.7b QAT through repro_torch.launch.train
               at 7 of its 28 layers (TRAIN_LAYERS), --batch 4 --seq 128
               (M=512 rows per projection), remat on, 2 steps each of
               --backend xla and residual in asym_u8 and
               sym_i8 (one run with --compress-grads --mesh host, one
               with --microbatches 2); launch counts must match the
               path; the
               residual sym_i8 run saves its state through
               --ckpt-dir, which restores to tensors equal to it
  7. train parity  one train step at 1 layer of full width on the card:
               every lut_matmul / residual_matmul launch held against
               its plain version (on the card above PARITY_CARD_GATHERS
               gathers, for time; the free-running CPU step
               beside it dropped to buy phase 17's time)
  8. timing    each kernel and its plain version with CUDA events at the
               paths' shapes: ``ms`` times back-to-back wrapper calls (what
               a host-driven path pays), ``device_ms`` the same calls
               queued behind a spin on the card (the kernels' device time);
               for the two gather kernels also gathers/s and their share
               of the load/store units' lane rate (SMs x 32 x the SM clock
               nvidia-smi reads beside the timing), lut_matmul on three
               operand patterns (uniform, bank-conflict-free, quantized
               normal); decode_attention with and without the append at
               the path's shape and at long context (S_max 4096);
               delta_matmul also at the planned QAT step's shapes
               (M = 512, sym_i8: ``plan_qat`` in the JSON) and at the
               quantized unembed's (K = 2048, N = 151,936, M = 4 and 256:
               ``unembed``); lut_matmul, residual_matmul and delta_matmul
               also at the merged projections' serve shapes (M = 4 and
               256: ``serve``); fused_qdot also at minitron-8b's four
               merged projections at M = 8 (``minitron_decode``, the
               benchmark's decode step); the three serving kernels at the MoE
               family's shapes (``moe``, per config) and the other
               families' (``families``, per config: every distinct serve
               projection at M = 4 and 256, every calibration
               projection, the attention at the serve path's position
               and at 4095 of 4096), and phase 15's (``encdec_vlm``:
               whisper's fused_qdot, delta_matmul and decode_attention
               cases, internvl2's lut_matmul at M = 4, 256 and the
               prefix's 512); every case of these phase-12 to -15 shapes
               is held against its plain version on the card before it is
               timed; phase 18's training shapes (``train_families``,
               per config), the plain version's ms from its phase-3 call
  9. trace     torch.profiler over full-width decode steps of the serve
               path: kernel launches per step by name, the device's busy
               share of the traced window, host-side op counts
 10. plans     the plan path at full width: (a) the plan CLI (python -m
               repro_torch.calib) on the card, sym_i8, 2 train-shaped
               calibration batches, written under build/plans; (b) its
               heterogeneous variant (odd layers design2); (c) serve
               --plan of (b), --calibrate 1, 4 x 64 prompt, gen 16, the
               fused calls reading at least two distinct tables; (e) 2
               QAT steps through (b), --batch 4 --seq 128; launch counts
               read after each run
 11. plan parity  (d) a heterogeneous plan at 2 layers of full width in
               both modes, served with every launch held against its
               plain version (on the card above PARITY_CARD_GATHERS
               gathers, since PR 17, for time), and one QAT step through
               it with every delta_matmul launch held likewise
 12. serve options  rmsnorm gives each row of a batch its value alone,
               and the main path's prefill and decode with each rmsnorm
               form (the path's fused one, float32 and float64 composites);
               at full width: (a) --continuous 10 over 4 slots (prompt
               64, gen 16) on phase 4's asym_u8 tree (prepared again from
               its calibration table), each request equal
               to itself served alone (a B = 1 prefill and decode steps);
               (b) --per-channel --calibrate 1, sym_i8; (c) --prequantize
               --backend xla, residual and delta, asym_u8 (112 lut_matmul
               / residual_matmul / delta_matmul launches a forward, kept
               apart as ``serve`` in the JSON); (d) the quantized
               unembed (one delta_matmul of N = 151,936 a forward) on
               (a)'s tree; launch counts read after each run; then (a)-(d)
               at 1 layer of full width with every launch held against
               its plain version (in (a)-(c) on the card above
               PARITY_CARD_GATHERS gathers, since PR 17, for time; in (d)
               on the CPU but the unembed's prefill launch)
 13. MoE       mixtral-8x7b and llama4-scout-17b-a16e at 2 of 32 and 2 of
               48 layers, every width as published (the float32 master
               weights of more than 4 and 2 layers do not fit beside
               their int8 copies; mixtral runs 2 for time): serve's
               prepare and run, --calibrate 1, 4 requests, prompt 64, gen
               16, asym_u8 and sym_i8; launch counts held to the path's
               (a decode step 54 fused_qdot + 2 decode_attention and 106
               + 2, a calibration token 58 and 112 delta_matmul, as many
               calibration sites); then one
               layer of each at full width served calibrated in both
               modes with every launch held against its plain version
               (CpuShadow: the routers, wk/wv and attention on the CPU,
               the larger products on the card)
 14. families  gemma-7b at 4 of 28 layers, minitron-8b at 4 of 32,
               nemotron-4-340b at 1 of 96 (the float32 master weights of
               more layers do not fit beside their int8 copies and the
               prequantizer's temporaries), recurrentgemma-2b at 9 of 27
               (3 pattern units; cut for the script's time) and
               xlstm-125m (12) whole, every width as published:
               serve's prepare and run, --calibrate 1, 4 requests, prompt
               64, gen 16, asym_u8 and sym_i8, launch counts held to the
               path's (family_per_model); then one pattern unit of each
               (1 layer dense, 3 recurrent) served calibrated in both
               modes with every launch held against its plain version
 15. encoder-decoder and VLM  (a) whisper-small whole (12 + 12 layers)
               through serve's prepare and run, --calibrate 1, 4
               requests, prompt 64, gen 16, both modes, launch counts
               held to the path's (encdec_per_model: 96 fused_qdot + 12
               decode_attention a decode step, 72 fused_qdot an encoder
               pass, 120 delta_matmul a calibration token and 72 a
               calibration batch's encoder); (b) the same over the
               config's 1,500 encoder frames, asym_u8, on (a)'s table
               (the encoder and each forward's cross k/v at M = 6,000);
               (c) internvl2-76b at 4 of 80 layers, every width as
               published, --prequantize (16 lut_matmul + 4
               decode_attention a step), both modes; (d) one encoder
               layer, one decoder layer and its cross block of whisper
               served calibrated in both modes, and a remat train step
               of one layer of internvl2 with its 256-patch prefix
               (asym_u8, phase 18's parity_train_step), every launch
               held against its plain version
 16. applications  the paper's evaluation (repro_torch.app), each card
               result held equal to the same call on the CPU: (a) blur and
               sharpen of the 6 synthetic images for the 7 designs of
               Table 5 and its companions; (b) Sobel gradients and edge
               maps through the 4 signed designs of table_edge_detection;
               (c) the rows of the tables that run on the card
               (app.tables.DEVICE_TABLES; the other nine are numpy on the
               host, held to the reference by the CPU tests); (d) one
               3840 x 2160 frame sharpened per design, the median of 5
               after a warm-up printed beside nvidia-smi's name and power
               limit; (e)
               examples/quickstart_torch.py (lut_matmul held against its
               plain version), image_sharpening_torch.py and
               train_approx_lm_torch.py --steps 5 on the card.  Its
               launches are logged apart and join no count of the JSON
 17. multi-device  (a) launch.dryrun --all in process on the 16x16 and
               2x16x16 meshes (CPU, meta tensors): 32 of 32 cells OK
               each, the largest per-device arguments and the cells
               whose arguments alone exceed this card's memory; (b)
               train.make_prefill_logits at full width under the dry
               run's QuantConfig (residual_xla, rank 16), B = 2 x 64
               tokens: qwen3-1.7b at 1 of 28 layers (its logits held to
               the CPU's plain run), whisper-small whole (16 encoder
               frames a request) and internvl2-76b at 1 of 80 layers
               (256 prefix rows through frontend_proj), launches held
               to the path's and the call timed, then every launch held
               against its plain version and each distinct launch shape
               timed as phase 8 times its rows; (c) is phase 6's first run, which
               passes --mesh host.  Its residual_matmul launches stand
               apart in the JSON (``prefill_logits``)
 18. train families  QAT of every family at full width, --batch 4 --seq
               128, remat on, 2 steps each of --backend xla asym_u8
               (lut_matmul) and residual sym_i8 (residual_matmul): (a)
               mixtral-8x7b at 2 of 32 layers, llama4-scout at 1 of 48,
               recurrentgemma-2b at 9 of 27, xlstm-125m whole, gemma-7b
               at 1 of 28 and minitron-8b at 1 of 32 through
               launch.train's run(args, cfg=...); whisper-small whole
               (1,500 encoder frames a request) and internvl2-76b at 1 of
               80 (its 256 prefix patches) through train.make_train_step,
               as both train CLIs raise KeyError: 'frontend' for them
               (TRAIN_FAMILY_RUNS: the depths that a float32 AdamW
               state fits; nemotron-4-340b does not fit one card); losses,
               grad norms, ms per step and peak GiB printed, launch
               counts held to the path's (family_train_per_model); (b)
               one pattern unit of each (whisper: one encoder and one
               decoder layer; internvl2's is phase 15 (d)), one xla
               asym_u8 train step with every lut_matmul launch, forward
               and remat recompute, held against its plain version (on
               the card above PARITY_CARD_GATHERS gathers) and each
               recompute's quantized activations equal to its forward's.
               Its launches stand apart in the JSON (``train_families``)
The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import functools
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
TRAIN_RUNS = [("xla", "asym_u8", ["--compress-grads", "--mesh", "host"]),
              ("xla", "sym_i8", ["--microbatches", "2"]),
              ("residual", "asym_u8", []),
              ("residual", "sym_i8", [])]
CKPT_RUN = ("residual", "sym_i8")          # saves its state: --ckpt-dir
# depth cuts that keep the script inside its time limit: phase 6 trains
# TRAIN_LAYERS of qwen3's 28 layers (every shape of the path; the
# checkpoint round trip of the full depth took 80 s of its 107; at 14
# layers phase 6 took 70.5 s, and the whole script 1,209.2 s, on a slow
# H100 host), phases 5, 7 and 12 hold PARITY_LAYERS layers launch by
# launch (phase 11 keeps 2: its plan differs between odd and even layers)
TRAIN_LAYERS = 7
PARITY_LAYERS = 1
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")
RANK = 32                        # QuantConfig.rank, the launcher's default
# the MoE family (phase 13): every width of the reference's CONFIG, the
# depth cut so that the float32 master weights fit the card beside their
# int8 copies (mixtral 5.8 GB a layer, scout 8.8 GB a layer and a 4.1 GB
# embedding; mixtral fits 4, and runs 2 for time); one layer is the
# pattern's whole period ("moe",)
MOE_RUNS = (("mixtral-8x7b", 2), ("llama4-scout-17b-a16e", 2))
# minitron-8b's merged projections as the benchmark serves it (48 query
# heads of 128, 8 kv groups, d_ff 16,384, relu2: no gate); its decode
# step runs fused_qdot at M = 8 on each
MINITRON_MERGED = (("wqkv", 4096, 8192), ("wo", 6144, 4096),
                   ("w_up", 4096, 16384), ("w_down", 16384, 4096))
# phase 13's parity: a launch of more gathers than this is held against
# its plain version on the card, not on the CPU (the experts, the merged
# attention and the shared expert at full width)
MOE_CARD_GATHERS = 1 << 24
# phases 5, 7, 11, 12 (a)-(c), 14 and 18's parity: a product launch of
# more gathers than this is held against its plain version on the card
# (every qwen3 and family projection at M >= 2), so only the attention
# and the smallest products run on the CPU: their CPU gathers took about
# 200 s of a slow host's 1,210 s, and phases 5 and 7's 86 s of a 1,010 s
# run (PERF.md)
PARITY_CARD_GATHERS = 1 << 22
# the remaining decoder families (phase 14): every width of the
# reference's CONFIG; the dense configs' depth cut so that their float32
# master weights fit beside their int8 copies and the prequantizer's
# temporaries (gemma-7b 1.1 GB a layer and a 3.1 GB embedding,
# minitron-8b 0.7 GB and 4.2 GB, nemotron-4-340b 13.8 GB and 18.9 GB);
# xlstm-125m whole; recurrentgemma-2b at 3 of its 9 pattern units, for
# the script's time (its whole depth took 39 s of calibration on a slow
# H100 host); one pattern unit holds every block kind and kernel shape
FAMILY_RUNS = (("gemma-7b", 4), ("minitron-8b", 4), ("nemotron-4-340b", 1),
               ("recurrentgemma-2b", 9), ("xlstm-125m", 12))
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


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"\n=== {name} === ({time.perf_counter() - T_START:.1f}s in)")


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


def moe_shapes(cfg):
    """The projections of one layer of an MoE config: (calibration,
    serve).  calibration: (name, K, N, M, per layer) of the unmerged
    projections of a calibration token (M = B rows, C = 4 rows an
    expert); serve: (name, K, N, M decode, M prefill, per layer) of the
    merged ones (an expert at its capacity C: 4 in decode, B*P*top_k*1.25/E
    in prefill)."""
    from repro_torch.models.moe import capacity
    D, H, Kv, hd, F, E = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                          cfg.d_ff, cfg.n_experts)
    Fs = cfg.shared_expert_ff
    c_dec = capacity(B, cfg.top_k, E)
    c_pre = capacity(B * P, cfg.top_k, E)
    calib = [("wq", D, H * hd, B, 1), ("wk", D, Kv * hd, B, 1),
             ("wv", D, Kv * hd, B, 1), ("wo", H * hd, D, B, 1),
             ("router", D, E, B, 1), ("expert w_gate/w_up", D, F, c_dec,
                                      2 * E),
             ("expert w_down", F, D, c_dec, E)]
    serve = [("wqkv", D, (H + 2 * Kv) * hd, B, B * P, 1),
             ("wo", H * hd, D, B, B * P, 1), ("router", D, E, B, B * P, 1),
             ("expert w_gate/w_up", D, F, c_dec, c_pre, 2 * E),
             ("expert w_down", F, D, c_dec, c_pre, E)]
    if Fs:
        calib += [("shared w_gate/w_up", D, Fs, B, 2),
                  ("shared w_down", Fs, D, B, 1)]
        serve += [("shared w_gateup", D, 2 * Fs, B, B * P, 1),
                  ("shared w_down", Fs, D, B, B * P, 1)]
    return calib, serve


def moe_per_layer(cfg):
    """(delta_matmul launches a calibration token, fused_qdot launches a
    forward) of one MoE layer."""
    calib, serve = moe_shapes(cfg)
    return sum(c[-1] for c in calib), sum(c[-1] for c in serve)


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


def attention_bound(Bq, H, Kv, hd, pos, window=None):
    # cache rows t <= pos (within the window) are read (the kernel skips
    # the rest), once each
    rows = min(pos + 1, window) if window else pos + 1
    nbytes = (Bq * H * hd * 4 + 2 * Bq * Kv * hd * 4 + 2 * hd * 4
              + 2 * Bq * rows * Kv * hd * 2 + Bq * H * hd * 4
              + 2 * Bq * Kv * hd * 2 + Bq * 4)
    flops = 4 * Bq * H * rows * hd
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
        # decode (M <= 8: the split-K schedule, 4 rows a thread up to M =
        # 4, 8 above; minitron-8b's M = 8 at its merged projections) and
        # prefill (M = B*P and 70: the tile schedule), with and without
        # compensation
        cases = [(name, M, K, N, 100 + i)
                 for i, (name, K, N) in enumerate(merged)
                 for M in (1, 2, 3, B, B * P)]
        cases += [("ragged", M, 77, 131, 100 + len(merged))
                  for M in (1, 2, 3, 5, 7, 70)]
        cases += [(f"minitron-8b {name}", 8, K, N, 150 + i)
                  for i, (name, K, N) in enumerate(MINITRON_MERGED)]
        for name, M, K, N, seed in cases:
            for comp in (True, False):
                case = check.fused_case(M, K, N, signed, seed, dev,
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
            del case, first, again
    errs["decode_attention"] = check_attention_cases(cfg, dev)
    check_biased_and_banks(cfg, dev)
    return errs


def check_biased_and_banks(cfg, dev):
    """The unsigned 'initial' through its biased uint16 table: the
    65,536-pair sweep through delta_matmul and fused_qdot on both
    schedules, and random operands at the path's shapes; a plan's bank
    rows at a merged projection's shape, each bit-equal to the table
    passed alone; and delta_matmul at the planned QAT step's M = TB*TS
    rows, the four training projection shapes, both modes."""
    from repro_torch.kernels import check
    unmerged, merged = projection_shapes(cfg)
    n = check.check_sweeps("initial", False, dev)
    log(f"[kernels] 'initial' asym_u8, biased uint16 table: the 65,536-pair "
        f"sweep through delta_matmul and fused_qdot, 256 rows (tile "
        f"schedule) and 4 rows at a time (split-K), {n} launches, each "
        f"bit-exact to its plain version and to the product table")
    for i, (name, K, N) in enumerate(unmerged):
        check.check_delta(check.delta_case(B, K, N, False, 600 + i, dev,
                                           design="initial"))
    for i, (name, K, N) in enumerate(merged):
        for M in (B, B * P):
            check.check_fused(check.fused_case(M, K, N, False, 610 + i, dev,
                                               design="initial"))
    log(f"[kernels] 'initial' asym_u8 at the path's shapes: delta_matmul "
        f"M={B} x 7 projections, fused_qdot M={B} and {B * P} x 4 merged "
        f"projections with compensation: bit-exact (fused output within "
        f"FUSED_RTOL)")
    D, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    for signed in (False, True):
        for M in (B, B * P):
            n = check.check_bank_rows(M, D, (H + 2 * Kv) * hd, signed, 620,
                                      dev)
            log(f"[kernels] bank of {check.BANK_DESIGNS} "
                f"({'sym_i8' if signed else 'asym_u8'}), wqkv M={M}: each "
                f"row through delta_matmul and fused_qdot bit-equal to the "
                f"table alone and to the plain version ({n} launches)")
        for i, (name, K, N) in enumerate(train_kinds(cfg)):
            check.check_delta(check.delta_case(TB * TS, K, N, signed,
                                               630 + i, dev))
            log(f"[kernels] delta_matmul {'sym_i8' if signed else 'asym_u8'}"
                f" {name} M={TB * TS} K={K} N={N} (planned QAT): bit-exact")


def check_moe_kernels(dev, errs):
    """Phase 3 at the MoE family's shapes (full width): fused_qdot at
    every serve projection of a layer at decode and prefill M (the
    routers' N = 8 and 16 also at M = 1..4 on the split-K schedule, with
    and without compensation, two launches bit-equal), at the expert
    shapes with a degenerate activation scale (1e-8, what calibration
    gives an expert that saw only padding rows) on both schedules;
    delta_matmul at every calibration projection (M = 4); decode_attention
    at the configs' query groups (32/8 and 40/8, head_dim 128, qk-norm
    off), mixtral's window of 4096 at S_max 4608 with positions past it.
    Folds the max errors into ``errs``."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check, ops
    n = 0
    for arch, _ in MOE_RUNS:
        cfg = configs.get(arch)
        calib, serve = moe_shapes(cfg)
        for signed in (False, True):
            mode = "sym_i8" if signed else "asym_u8"
            for i, (name, K, N, M, _) in enumerate(calib):
                check.check_delta(check.delta_case(M, K, N, signed, 900 + i,
                                                   dev, device_draw=True))
                n += 1
            log(f"[kernels] {arch} {mode}: delta_matmul at the "
                f"{len(calib)} calibration projections (M = {B}, experts "
                f"at C = {calib[-1][3]}): bit-exact")
            for i, (name, K, N, m_dec, m_pre, _) in enumerate(serve):
                ms = (1, 2, 3, m_dec, 20, 80, m_pre) if name == "router" \
                    else (m_dec, m_pre)
                for M in sorted(set(ms)):
                    for comp in ((True, False) if name == "router"
                                 else (True,)):
                        case = check.fused_case(M, K, N, signed, 920 + i,
                                                dev, compensate=comp,
                                                device_draw=True)
                        r = check.check_fused(case)
                        n += 1
                        errs["fused_qdot"] = max(errs["fused_qdot"],
                                                 r["max_abs_err"])
                        if name == "router":
                            again = [ops.fused_qdot_packed(
                                **case, return_int=True) for _ in range(2)]
                            assert all(torch.equal(x, y) for x, y in
                                       zip(*again)), "router not repeatable"
                        log(f"[kernels] {arch} fused_qdot {mode} {name} "
                            f"M={M} K={K} N={N} compensate={comp}: qx, acc "
                            f"bit-exact; max |err| {r['max_abs_err']:.3e} "
                            f"({r['max_rel_err']:.3e} of max |y|)"
                            + ("; two launches bit-equal"
                               if name == "router" else ""))
                if name.startswith("expert"):
                    for M in (m_dec, m_pre):
                        r = check.check_fused(check.fused_case(
                            M, K, N, signed, 940 + i, dev, sx=1e-8,
                            device_draw=True))
                        n += 1
                        log(f"[kernels] {arch} fused_qdot {mode} {name} "
                            f"M={M} K={K} N={N} at the degenerate scale "
                            f"1e-8: qx, acc bit-exact; max |err| "
                            f"{r['max_abs_err']:.3e}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for arch, _ in MOE_RUNS:
        cfg = configs.get(arch)
        H, Kv, hd, w = cfg.n_heads, cfg.n_kv, cfg.hd, cfg.window
        cases = [("decode", dict(B=B, S=P + G, pos=[64, 70, 75, 79])),
                 ("calibration", dict(B=B, S=CALIB_TOKENS,
                                      pos=[0, 1, 33, 65]))]
        if w:
            S = w + 512
            cases += [(f"window {w}, past it", dict(
                B=B, S=S, window=w, pos=[w - 1, w, w + 100, S - 1])),
                (f"window {w}, chunk edges", dict(
                    B=B, S=S, window=w, pos=(check.attention_edge_positions(
                        S, B, Kv, hd, sms)[-B:])))]
        for j, (tag, kw) in enumerate(cases):
            Bq, S = kw.pop("B"), kw.pop("S")
            case = check.attention_case(Bq, S, H, Kv, hd, 960 + j, dev,
                                        qk_norm=False, **kw)
            r = check.check_attention(case)
            a = check.check_attention_append(case)
            n += 2
            errs["decode_attention"] = max(errs["decode_attention"],
                                           r["max_abs_err"])
            log(f"[kernels] {arch} decode_attention {tag} H/Kv={H}/{Kv} "
                f"hd={hd} qk-norm off S={S} pos={case['pos'].tolist()} "
                f"window={case['window']}: v rows bit-exact, "
                f"{r['row_flips']} of {r['row_entries']} k-row entries a "
                f"bf16 step apart, max |out err| {r['max_abs_err']:.3e}; "
                f"two launches bit-equal; the append in place "
                f"({a['row_flips']} k-row entries apart)")
            del case
    log(f"[kernels] MoE shapes: {n} cases held against their plain "
        f"versions")


def check_attention_cases(cfg, dev) -> float:
    """decode_attention against its plain version at the path's cases,
    at long context and at the chunk edges (check.check_attention: two
    launches bit-equal too); the append (check.check_attention_append)
    at the path's cases and at long context.  Returns the max |out err|."""
    import torch
    from repro_torch.kernels import check, ops
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    long_pos = [0, 1023, 2500, 4095]
    cases = [("decode, per-slot pos", dict(B=B, S=P + G, pos=[64, 70, 75, 79]),
              True),
             ("decode, one pos", dict(B=B, S=P + G, per_slot=False), True),
             ("calibration", dict(B=B, S=CALIB_TOKENS, pos=[0, 1, 33, 65]),
              True),
             ("ragged + window", dict(B=3, S=77, window=20), False),
             ("long context", dict(B=B, S=4096, pos=long_pos), True),
             ("window across chunk edges", dict(B=B, S=P + G, window=20,
                                                pos=[40, 47, 63, 79]), False)]
    for S in (P + G, CALIB_TOKENS, 4096):
        edges = check.attention_edge_positions(S, B, Kv, hd, sms)
        if S == 4096:       # the first and last chunk and tile edges
            edges = edges[:B] + edges[-B:]
        for i in range(0, len(edges), B):
            pos = (edges[i:i + B] + [S - 1] * B)[:B]
            cases.append(("chunk edges", dict(B=B, S=S, pos=pos), False))
    # every chunk and tile edge at long context under a window of 20, the
    # inputs of tests/test_torch_gpu.py::test_attention_kernel_at_chunk_edges
    # (seed S): a moved k row weighs most under a short window
    edges = check.attention_edge_positions(4096, B, Kv, hd, sms)
    for i in range(0, len(edges), B):
        pos = (edges[i:i + B] + [4095] * B)[:B]
        cases.append(("window 20 at long-context edges",
                      dict(B=B, S=4096, window=20, pos=pos, seed=4096),
                      False))
    err, flipped, flipped_err = 0.0, 0, 0.0
    for i, (name, kw, append) in enumerate(cases):
        Bq, S, seed = kw.pop("B"), kw.pop("S"), kw.pop("seed", i)
        case = check.attention_case(Bq, S, H, Kv, hd, seed, dev, **kw)
        chunks, rows = ops.attention_chunks(S, Bq, Kv, sms)
        tile = ops.attention_tile_rows(rows, hd)
        r = check.check_attention(case)
        err = max(err, r["max_abs_err"])
        log(f"[kernels] decode_attention {name} B={Bq} S={S} pos="
            f"{case['pos'].tolist()} ({chunks} chunks of {rows}, tiles of "
            f"{tile}): v rows "
            f"bit-exact, {r['row_flips']} of {r['row_entries']} k-row "
            f"entries one bf16 step apart, max |out err| "
            f"{r['max_abs_err']:.3e}; two launches bit-equal")
        if r["flipped"]:
            log(f"[kernels]   (slot, kv head) with a k row one bf16 step "
                f"apart: {r['flipped']}; max |out err| over their heads "
                f"{r['flipped_err']:.3e}")
        flipped += len(r["flipped"])
        flipped_err = max(flipped_err, r["flipped_err"])
        if append:
            a = check.check_attention_append(case)
            log(f"[kernels] decode_attention {name} with the append: out "
                f"bit-equal to the step's, rows at pos as the plain "
                f"version's ({a['row_flips']} of {a['row_entries']} k-row "
                f"entries one bf16 step apart), every other cache row "
                f"unchanged")
        del case
    log(f"[kernels] decode_attention: {len(cases)} cases, every head "
        f"within ATTN_TOL of the plain output; {flipped} (slot, kv head) "
        f"pairs with a k row a bf16 step apart, max |out err| over their "
        f"heads {flipped_err:.3e}")
    return err


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
    """The main path in both modes; returns the launches and the asym_u8
    run's calibration table, which phase 12 (a) installs again rather
    than calibrating twice."""
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
            prepared = serve.prepare(args)
            r = serve.run(args, prepared)
            counts = dict(ops.LAUNCHES)
        if mode == "asym_u8":
            table = prepared.table
        del prepared
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
    return totals, table


def _serve_once(cfg, params, q, table, cal, prompts, gen, dev, plan=None,
                cal_frames=None, frames=None):
    """prequantize -> (calibrate, on the fused backend) -> (plan) ->
    install -> (encdec: the encoder over ``frames``) -> prefill -> greedy
    decode.  ``cal_frames``: an encdec model's calibration frames."""
    import torch
    from repro_torch import calib
    from repro_torch.models import transformer as T
    from repro_torch.quant import fuse_projections, prequantize_weights
    from repro_torch.train import make_prefill_step, make_serve_step
    b, p = prompts.shape
    tree = prequantize_weights(params, q)
    if q.backend == "fused":
        if table is None:
            table = calib.calibrate_decode(tree, cfg, q, cal, gen_len=2,
                                           device=dev,
                                           enc_frontend=cal_frames)
        tree = calib.apply_calibration(tree, table)
    if plan is not None:
        tree = calib.apply_plan(tree, plan, q)
    tree = fuse_projections(calib.attach_comp_cols(tree, q))
    enc_out = None
    if frames is not None:
        enc_out = T._run_encoder(tree, torch.as_tensor(frames, device=dev),
                                 cfg, q)
    st = T.init_decode_state(cfg, b, p + gen, device=dev, enc_out=enc_out)
    tok, lg, st = make_prefill_step(cfg, q)(
        tree, st, torch.as_tensor(prompts, device=dev))
    toks, lgs = [tok], [lg]
    step = make_serve_step(cfg, q)
    for _ in range(gen - 1):
        tok, lg, st = step(tree, st, tok)
        toks.append(tok)
        lgs.append(lg)
    # the first slot's KV cache (none where it is a recurrent state)
    return (table, torch.cat(toks, 1).cpu(), [x.float().cpu() for x in lgs],
            {k: v.float().cpu() for k, v in st["caches"][0].items()
             if k in ("k", "v")})


def _card_params(cfg, seed):
    """Seeded params made on the CPU, and a copy on the card."""
    import torch
    from repro_torch.models import transformer as T
    params_cpu = T.init_params(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_card(v) for v in tree]
        return tree.to("cuda")
    return params_cpu, to_card(params_cpu)


def _shadow_log(tag, sh, t0):
    for n, st in sh.stats.items():
        assert st["calls"] > 0, f"{tag}: {n} never launched"
        where = (f" ({st['on_card']} of them against the plain version on "
                 f"the card)" if st["on_card"] else "")
        log(f"[parity] {tag} {n}: {st['calls']} launches held against "
            f"the CPU plain version{where}; max |err| "
            f"{st['max_abs_err']:.3e}"
            + (f"; {st['row_flips']} of {st['row_entries']} k-row "
               f"entries one bf16 step apart" if st["row_entries"]
               else ""))
    log(f"[parity] {tag} card run with CPU shadows: "
        f"{time.perf_counter() - t0:.1f}s")


def parity_initial(cfg_full):
    """serve --design initial --quant-mode asym_u8 at PARITY_LAYERS of
    full width, uncalibrated ('delta': every projection a delta_matmul launch
    on the biased table) and calibrated ('fused'), every launch held
    against its plain version: on the CPU, or on the card for a product
    launch of more than PARITY_CARD_GATHERS gathers."""
    import numpy as np
    from repro_torch.kernels import check
    from repro_torch.quant import QuantConfig
    cfg = dataclasses.replace(cfg_full, n_layers=PARITY_LAYERS)
    _, params_gpu = _card_params(cfg, 1)
    rng = np.random.default_rng(4)
    cal = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    for backend in ("delta", "fused"):
        q = QuantConfig(design="initial", backend=backend, mode="asym_u8",
                        inference=True)
        names = (check.CpuShadow.SERVE if backend == "fused"
                 else ("delta_matmul", "decode_attention"))
        t0 = time.perf_counter()
        with check.CpuShadow(names, card_gathers=PARITY_CARD_GATHERS) as sh:
            _, ids, _, _ = _serve_once(cfg, params_gpu, q, None, cal,
                                       prompts, 3, "cuda")
        _shadow_log(f"initial asym_u8 {backend}", sh, t0)
        log(f"[parity] initial asym_u8 {backend}: card ids {ids.tolist()}")


def slice_parity(cfg_full):
    """Full width, depth PARITY_LAYERS, seeded weights and prompts, the
    card's own calibration table.  Asserted: every kernel launch of the
    card's run equals its plain version run from the same inputs
    (CpuShadow: on the CPU, or on the card for a product launch of more
    than PARITY_CARD_GATHERS gathers).  The free-running CPU run beside
    it (reported, never asserted: PyTorch's CPU and CUDA glue ops differ
    by float32 ulps, a few activations per forward then land on the
    other side of a static quantization step, and this random-weight
    model amplifies each flipped step) was dropped to buy phase 17's
    time: 14 s of host CPU a run (PERF.md)."""
    import numpy as np
    import torch
    from repro_torch.kernels import check
    from repro_torch.quant import QuantConfig
    cfg = dataclasses.replace(cfg_full, n_layers=PARITY_LAYERS)
    b, p, g = 2, 8, 4
    torch.set_num_threads(os.cpu_count() or 1)
    _, params_gpu = _card_params(cfg, 1)
    rng = np.random.default_rng(3)
    cal = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    for mode in ("asym_u8", "sym_i8"):
        q = QuantConfig(design="design2", backend="fused", mode=mode,
                        inference=True)
        t0 = time.perf_counter()
        with check.CpuShadow(card_gathers=PARITY_CARD_GATHERS) as sh:
            _, ids_g, lg_g, _ = _serve_once(cfg, params_gpu, q, None, cal,
                                            prompts, g, "cuda")
        _shadow_log(mode, sh, t0)
        assert all(bool(torch.isfinite(x).all()) for x in lg_g), mode
        log(f"[parity] {mode}: card ids {ids_g.tolist()}")


def train_full_width(cfg):
    """The training path at full width and TRAIN_LAYERS of depth through
    the launcher, one run per (backend, mode); returns the launches of the
    two training kernels."""
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
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
            r = train.run(train.parse_args(argv), cfg=cfg)
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


def train_parity(cfg_full):
    """One train step at PARITY_LAYERS of full width on the card.
    Asserted: every lut_matmul / residual_matmul launch of the card's
    step equals its plain version from the same inputs (CpuShadow: on
    the card above PARITY_CARD_GATHERS gathers, else on the CPU), with
    the path's launch count.  The free-running CPU
    step beside it (reported, never asserted: a float32 ulp of PyTorch's
    CPU and CUDA glue can flip a dynamic quantization step, and the
    random-weight model amplifies each flip) was dropped to buy phase
    17's time: 35 s of host CPU a run (PERF.md)."""
    import math

    import numpy as np
    import torch
    from repro_torch.kernels import check
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    cfg = dataclasses.replace(cfg_full, n_layers=PARITY_LAYERS)
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
        p_gpu = opt_mod.tree_map(lambda t: t.to("cuda", copy=True), p_cpu)
        t0 = time.perf_counter()
        with check.CpuShadow(check.CpuShadow.TRAIN,
                             card_gathers=PARITY_CARD_GATHERS) as sh:
            p_gpu, _, m_gpu = step(p_gpu, opt_mod.init(p_gpu, ocfg),
                                   {k: v.to("cuda") for k, v in
                                    batch.items()})
        st = sh.stats[name]
        want = 7 * cfg.n_layers * 2
        assert st["calls"] == want, (name, st["calls"], want)
        log(f"[train parity] {backend} {mode}: {st['calls']} {name} "
            f"launches held against the plain version ({st['on_card']} "
            f"on the card, the rest on the CPU); max |err| "
            f"{st['max_abs_err']:.3e} ({time.perf_counter() - t0:.1f}s); "
            f"loss {float(m_gpu['loss'])!r}")
        assert math.isfinite(float(m_gpu["loss"]))
        del p_gpu, p_cpu
        torch.cuda.empty_cache()


def _launched(who, tag, want):
    """The launch counts since the last reset, asserted to be ``want``."""
    from repro_torch.kernels import ops
    counts = dict(ops.LAUNCHES)
    log(f"[{who}] {tag}: launches {counts} (expected {want})")
    assert counts == want, f"{tag}: launch counts {counts} != {want}"
    return counts


PLAN_DIR = os.path.join(HERE, "build", "plans")


def plans_full_width(cfg):
    """This slice's path at full width: (a) the plan CLI calibrates
    (train-shaped, 2 batches, lut_matmul) and searches, sym_i8; (b) its
    heterogeneous variant; (c) serve --plan of (b), --calibrate 1, 4 x 64
    prompt, gen 16; (e) 2 QAT steps of --batch 4 --seq 128 through (b).
    Each run's launch counts are read just after it.  Returns the
    launches of the three runs, the QAT run's delta_matmul launches
    (M = TB*TS) apart from the rest, and that count."""
    import numpy as np
    import torch
    from repro_torch.calib import DesignPlan, odd_layers
    from repro_torch.calib import plan as plan_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    L = cfg.n_layers
    totals = dict.fromkeys(ops.LAUNCHES, 0)
    rows = {}
    os.makedirs(PLAN_DIR, exist_ok=True)
    path = os.path.join(PLAN_DIR, "chip_smoke_qwen3-1.7b_sym_i8.json")
    het_path = os.path.join(PLAN_DIR, "chip_smoke_qwen3-1.7b_sym_i8_het.json")

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    # (a) the CLI, on the card
    with PlainGuard():
        ops.reset_launches()
        t0 = time.perf_counter()
        made = plan_mod.main(["--arch", "qwen3-1.7b", "--batches", "2",
                              "--quant-mode", "sym_i8", "--out", path])
        dt = time.perf_counter() - t0
        # 7 projections x layers x 2 batches, forward only
        add(_launched("plans", "plan CLI", dict(
            dict.fromkeys(ops.LAUNCHES, 0), lut_matmul=7 * L * 2)))
    assert len(made.layers) == 7 * L, len(made.layers)
    assert DesignPlan.load(path).to_json() == made.to_json()
    log(f"[plans] (a) plan CLI at full width, sym_i8, 2 train-shaped "
        f"calibration batches: {len(made.layers)} sites, histogram "
        f"{made.histogram()}, {len(made.recompose16)} recompose16 rows, "
        f"{dt:.1f}s (init, prequantize, calibrate, search)")
    rows["plan_cli_s"] = dt
    # (b) heterogeneous: odd layers on design2
    het = odd_layers(made, "design2")
    het.save(het_path)
    log(f"[plans] (b) heterogeneous variant (odd layers design2): "
        f"histogram {het.histogram()}")
    # (c) serve it
    seen = {}
    real = ops.fused_qdot_packed

    def spy(x, qw, dlut, *a, **k):      # the tables the fused calls read
        seen.setdefault(dlut.data_ptr(), dlut)
        return real(x, qw, dlut, *a, **k)
    args = serve.build_parser().parse_args(
        ARGS + ["--quant-mode", "sym_i8", "--plan", het_path])
    with PlainGuard():
        ops.reset_launches()
        ops.fused_qdot_packed = spy
        try:
            r = serve.run(args)
        finally:
            ops.fused_qdot_packed = real
        fused = ops.LAUNCHES["fused_qdot"]
        tables = {t.cpu().numpy().tobytes() for t in seen.values()}
        per_step = fused / (G + 2)
        # warm prefill + warm decode + timed prefill + G-1 decode steps
        add(_launched("plans", "plan serve", dict(
            dict.fromkeys(ops.LAUNCHES, 0),
            delta_matmul=7 * L * CALIB_TOKENS, fused_qdot=fused,
            decode_attention=L * (CALIB_TOKENS + G))))
    assert fused % (G + 2) == 0 and 4 * L <= per_step <= 7 * L, fused
    assert len(tables) >= 2, f"the fused calls read {len(tables)} table(s)"
    assert r.out.shape == (B, G) and np.isfinite(r.logits).all()
    assert ((r.out >= 0) & (r.out < cfg.vocab)).all()
    rows["serve"] = {"prefill_ms": r.t_prefill * 1e3,
                     "prefill_tok_s": B * P / r.t_prefill,
                     "decode_ms_per_step": r.t_decode * 1e3 / (G - 1),
                     "prepare_s": r.t_prepare,
                     "peak_gib": r.peak_bytes / 2**30,
                     "fused_qdot_per_step": per_step,
                     "distinct_tables": len(tables),
                     "table_addresses": len(seen)}
    log(f"[plans] (c) serve --plan (heterogeneous) sym_i8 at full width: "
        f"prepare (init + prequantize + calibrate + plan) "
        f"{r.t_prepare:.3f}s; prefill {B}x{P} tokens "
        f"{r.t_prefill * 1e3:.3f} ms ({B * P / r.t_prefill:.1f} tok/s); "
        f"decode {r.t_decode * 1e3 / (G - 1):.3f} ms/step; peak device "
        f"memory {r.peak_bytes / 2**30:.3f} GiB; fused_qdot {per_step:g} "
        f"launches per forward (112 if every group merges), reading "
        f"{len(tables)} distinct tables at {len(seen)} addresses (a row "
        f"of a site's bank each); sample ids {r.out[0][:12].tolist()}")
    torch.cuda.empty_cache()
    # (e) QAT through the plan
    argv = ["--arch", "qwen3-1.7b", "--batch", str(TB), "--seq", str(TS),
            "--steps", str(TSTEPS), "--quant-mode", "sym_i8", "--plan",
            het_path, "--log-every", "1"]
    with torch.enable_grad(), PlainGuard():
        ops.reset_launches()
        t = train.run(train.parse_args(argv))
        # 7 projections x layers x (forward + remat recompute) x steps
        counts = _launched("plans", "plan QAT", dict(
            dict.fromkeys(ops.LAUNCHES, 0), delta_matmul=7 * L * 2 * TSTEPS))
        qat = counts.pop("delta_matmul")
        add(dict(counts, delta_matmul=0))
    assert len(t.losses) == TSTEPS
    assert all(np.isfinite(x) for x in t.losses + t.grad_norms)
    rows["qat"] = {"ms_per_step": [x * 1e3 for x in t.step_s],
                   "losses": t.losses, "grad_norms": t.grad_norms,
                   "peak_gib": t.peak_bytes / 2**30}
    log(f"[plans] (e) QAT through the plan at full width, --batch {TB} "
        f"--seq {TS}, sym_i8: losses {t.losses}, grad norms "
        f"{t.grad_norms}, ms per step {[x * 1e3 for x in t.step_s]}, peak "
        f"device memory {t.peak_bytes / 2**30:.3f} GiB")
    del t
    torch.cuda.empty_cache()
    log("[plans] " + json.dumps({"plans": rows}))
    return totals, qat


def plan_parity_two_layers(cfg_full):
    """(d) The plan path at 2 layers of full width, both modes: a plan
    searched on the card from a train-shaped calibration of this model,
    made heterogeneous, served calibrated with every launch held against
    its plain version (CpuShadow: on the card above PARITY_CARD_GATHERS
    gathers); then one QAT step through the sym_i8 plan, every
    delta_matmul launch held likewise."""
    import numpy as np
    import torch
    from repro_torch import calib, configs
    from repro_torch.kernels import check
    from repro_torch.quant import QuantConfig, prequantize_weights
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    cfg = dataclasses.replace(cfg_full, n_layers=2)
    _, params_gpu = _card_params(cfg, 2)
    rng = np.random.default_rng(6)
    cal = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (2, 4)).astype(np.int32)
    batches = [configs.make_smoke_batch(cfg, 2, 16, seed=i) for i in (0, 1)]
    plans = {}
    for mode in ("asym_u8", "sym_i8"):
        qx = QuantConfig(design="design2", backend="xla", mode=mode)
        table = calib.calibrate(prequantize_weights(params_gpu, qx), cfg, qx,
                                batches, device="cuda")
        plans[mode] = plan = calib.odd_layers(calib.plan_designs(
            table, qx, arch="qwen3-1.7b@2"), "design2")
        q = QuantConfig(design="design2", backend="fused", mode=mode,
                        inference=True)
        t0 = time.perf_counter()
        with check.CpuShadow(card_gathers=PARITY_CARD_GATHERS) as sh:
            _, ids, _, _ = _serve_once(cfg, params_gpu, q, None, cal,
                                       prompts, 4, "cuda", plan=plan)
        _shadow_log(f"plan {mode} {plan.histogram()}", sh, t0)
        log(f"[parity] plan {mode}: card ids {ids.tolist()}")
    q = QuantConfig(design="design2", backend="xla", mode="sym_i8")
    ocfg = OptConfig(warmup_steps=5, total_steps=100)
    step = make_train_step(cfg, q, ocfg, remat=True,
                           params_transform=calib.make_plan_injector(
                               params_gpu, plans["sym_i8"], q))
    toks = rng.integers(0, cfg.vocab, (1, 17)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to("cuda"),
             "labels": torch.from_numpy(toks[:, 1:]).to("cuda")}
    t0 = time.perf_counter()
    with torch.enable_grad(), check.CpuShadow(
            ("delta_matmul",), card_gathers=PARITY_CARD_GATHERS) as sh:
        _, _, m = step(params_gpu, opt_mod.init(params_gpu, ocfg), batch)
    assert sh.stats["delta_matmul"]["calls"] == 7 * cfg.n_layers * 2
    assert np.isfinite(float(m["loss"]))
    _shadow_log("plan QAT sym_i8", sh, t0)


CONT_N = 10                      # phase 12 (a): requests through B slots
UNEMBED_STEPS = 3                # phase 12 (d): decode steps after prefill


def _alone(params, cfg, q, prompt, gen, s_max, dev):
    """One request served alone: a B = 1 prefill and gen - 1 greedy steps
    on ``params``, in a per-slot state of s_max positions (the
    state serve --continuous makes).  Returns the ids."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.train import make_prefill_step, make_serve_step
    st = T.init_decode_state(cfg, 1, s_max, device=dev, per_slot=True)
    tok, _, st = make_prefill_step(cfg, q)(
        params, st, torch.as_tensor(prompt[None], device=dev))
    ids = [int(tok[0, 0])]
    step = make_serve_step(cfg, q)
    for _ in range(gen - 1):
        tok, _, st = step(params, st, tok)
        ids.append(int(tok[0, 0]))
    return ids


def _rmsnorm_f64(x, gamma, eps: float = 1e-6):
    """rmsnorm with its mean of squares summed in float64 and rounded once
    to float32 (batch-invariant too, in four launches)."""
    import torch
    var = torch.mean(torch.square(x.double()), -1, keepdim=True).float()
    return (x * torch.rsqrt(var + eps)) * gamma


def _rmsnorm_f32(x, gamma, eps: float = 1e-6):
    from repro_torch.kernels import ref
    return ref._rmsnorm(x, gamma, eps)


# rmsnorm forms phase 12 compares: the path's (None: layers.rmsnorm), the
# float32 composite (the CPU form) and the float64 composite
NORM_FORMS = {"layers.rmsnorm": None, "float32 mean": _rmsnorm_f32,
              "float64 mean": _rmsnorm_f64}


def norm_forms_cost(cfg, prepared, prompts):
    """The main path's prefill and decode step on ``prepared`` (phase 4's
    calibrated asym_u8 tree) with layers.rmsnorm swapped for each of
    NORM_FORMS, in the order path, f32, f64, f64, f32, path: the prefill
    and decode ms per run (host clock around a device sync, G - 1 steps)
    and the device kernels of one profiled decode step.  Returns
    {form: {...}}."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.train import make_prefill_step, make_serve_step
    dev = torch.device("cuda")
    path = layers.rmsnorm
    prefill = make_prefill_step(cfg, prepared.qcfg)
    step = make_serve_step(cfg, prepared.qcfg)
    p_dev = torch.as_tensor(prompts, device=dev)
    out = {name: {"prefill_ms": [], "decode_ms_per_step": []}
           for name in NORM_FORMS}
    order = list(NORM_FORMS)
    order = order + order[::-1]
    try:
        for name in order:
            layers.rmsnorm = NORM_FORMS[name] or path
            st = T.init_decode_state(cfg, B, P + G + 1, device=dev)
            tok, _, st = prefill(prepared.params, st, p_dev)     # warm
            step(prepared.params, st, tok)
            st = T.init_decode_state(cfg, B, P + G + 1, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, _, st = prefill(prepared.params, st, p_dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(G - 1):
                tok, _, st = step(prepared.params, st, tok)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out[name]["prefill_ms"].append((t1 - t0) * 1e3)
            out[name]["decode_ms_per_step"].append((t2 - t1) * 1e3 / (G - 1))
            if "kernels_per_step" not in out[name]:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    step(prepared.params, st, tok)
                    torch.cuda.synchronize()
                out[name]["kernels_per_step"] = sum(
                    e.device_type == torch.autograd.DeviceType.CUDA
                    for e in prof.events())
            del st
    finally:
        layers.rmsnorm = path
    for name, r in out.items():
        log(f"[options] rmsnorm form {name!r} on the main path (asym_u8, "
            f"calibrated, {B}x{P}, {G - 1} steps): prefill ms "
            f"{r['prefill_ms']}, decode ms/step {r['decode_ms_per_step']}, "
            f"{r['kernels_per_step']} device kernels a decode step")
    return out


def serve_options_on_tree(cfg, table, rows):
    """Phase 12 at full width on phase 4's asym_u8 tree, prepared again
    with its calibration table (serve.prepare(args, table)), each run's
    launch counts read just after it: (a) --continuous 10 over 4 slots,
    every request equal to itself served alone; the main path's cost
    with each rmsnorm form (norm_forms_cost); (d) the quantized unembed
    (QuantConfig quant_unembed) on the same tree, a prefill and
    UNEMBED_STEPS decode steps.  First, rmsnorm on the card gives each
    row of a batch its value alone.  Returns the launches to add to the
    paths' counts and the unembed's delta_matmul launches (kept
    apart)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import layers
    from repro_torch.models import transformer as T
    from repro_torch.train import make_prefill_step, make_serve_step
    L = cfg.n_layers
    dev = torch.device("cuda")
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    totals = dict(zero)

    # rmsnorm: every row of a batch as it is alone (the float32 and
    # float64 composites counted beside the path's form)
    g = torch.Generator(device=dev).manual_seed(12)
    gamma = torch.ones((cfg.d_model,), device=dev)
    moved = dict.fromkeys(NORM_FORMS, 0)
    for t in range(300):
        x = torch.randn((B, 1, cfg.d_model), generator=g, device=dev) * (
            1 + t % 7)
        for name, fn in NORM_FORMS.items():
            fn = fn or layers.rmsnorm
            y = fn(x, gamma)
            moved[name] += sum(not torch.equal(y[i:i + 1],
                                               fn(x[i:i + 1], gamma))
                               for i in range(B))
    log(f"[options] rmsnorm rows of a batch of {B} that differ from the "
        f"row alone, of {300 * B} random {cfg.d_model}-wide rows: {moved}")
    assert moved["layers.rmsnorm"] == 0, moved

    # (a) continuous batching on phase 4's tree
    args = serve.build_parser().parse_args(
        ARGS + ["--quant-mode", "asym_u8", "--continuous", str(CONT_N)])
    with PlainGuard():
        ops.reset_launches()
        prepared = serve.prepare(args, table)
        r = serve.run(args, prepared)
        # warm: a batched prefill, a step and a B = 1 prefill; then the
        # batched prefill, one B = 1 prefill a refill, and the steps
        fwd = 3 + 1 + (CONT_N - B) + r.steps
        c = _launched("options", "(a) --continuous", dict(
            zero, fused_qdot=4 * L * fwd, decode_attention=L * (1 + r.steps)))
    for k in totals:
        totals[k] += c[k]
    s_max = P + 2 * G + 2
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (CONT_N, P)).astype(np.int32)
    t0 = time.perf_counter()
    alone = [_alone(prepared.params, cfg, prepared.qcfg, prompts[i], G,
                    s_max, dev) for i in range(CONT_N)]
    same = [alone[i] == r.out[i].tolist() for i in range(CONT_N)]
    rows["continuous"] = {"requests": CONT_N, "slots": r.slots,
                          "batched_steps": r.steps, "serve_s": r.t_serve,
                          "tok_s": CONT_N * (P + G) / r.t_serve,
                          "peak_gib": r.peak_bytes / 2**30}
    log(f"[options] (a) --continuous {CONT_N} over {r.slots} slots, asym_u8"
        f" calibrated (prepared with phase 4's table in "
        f"{prepared.t_prepare:.3f}s): {r.steps} batched decode steps in "
        f"{r.t_serve:.3f}s "
        f"({CONT_N * (P + G) / r.t_serve:.1f} tok/s, prompt and generated "
        f"tokens), warmup {r.t_warmup:.3f}s, peak device memory "
        f"{r.peak_bytes / 2**30:.3f} GiB; requests equal to themselves "
        f"served alone: {sum(same)} of {CONT_N} "
        f"({time.perf_counter() - t0:.1f}s to replay)")
    assert all(same), [(i, alone[i], r.out[i].tolist())
                       for i in range(CONT_N) if not same[i]]
    assert ((r.out >= 0) & (r.out < cfg.vocab)).all()

    rows["rmsnorm_forms"] = norm_forms_cost(cfg, prepared, prompts[:B])

    # (d) the quantized unembed on the same tree
    q = dataclasses.replace(prepared.qcfg, quant_unembed=True)
    prefill, step = make_prefill_step(cfg, q), make_serve_step(cfg, q)
    p_dev = torch.as_tensor(prompts[:B], device=dev)

    def state():
        return T.init_decode_state(cfg, B, P + UNEMBED_STEPS + 1,
                                   device=dev)
    tok, _, st = prefill(prepared.params, state(), p_dev)   # warm
    step(prepared.params, st, tok)
    del st
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with PlainGuard():
        ops.reset_launches()
        st = state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, lg, st = prefill(prepared.params, st, p_dev)
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(UNEMBED_STEPS):
            tok, lg, st = step(prepared.params, st, tok)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / UNEMBED_STEPS
        fwd = 1 + UNEMBED_STEPS
        c = _launched("options", "(d) quant_unembed", dict(
            zero, delta_matmul=fwd, fused_qdot=4 * L * fwd,
            decode_attention=L * UNEMBED_STEPS))
    totals["fused_qdot"] += c["fused_qdot"]
    totals["decode_attention"] += c["decode_attention"]
    assert lg.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(lg).all())
    rows["quant_unembed"] = {"prefill_ms": t_pf * 1e3,
                             "decode_ms_per_step": t_dec * 1e3,
                             "peak_gib": torch.cuda.max_memory_allocated(
                                 dev) / 2**30}
    log(f"[options] (d) quant_unembed (asym_u8, calibrated tree): prefill "
        f"{B}x{P} {t_pf * 1e3:.3f} ms, decode {t_dec * 1e3:.3f} ms/step "
        f"over {UNEMBED_STEPS} steps, one delta_matmul of K={cfg.d_model} "
        f"N={cfg.vocab} a forward; peak device memory "
        f"{rows['quant_unembed']['peak_gib']:.3f} GiB")
    del prepared, st, lg, tok
    torch.cuda.empty_cache()
    return totals, c["delta_matmul"]


def serve_options_runs(cfg, rows):
    """Phase 12's serve runs at full width, each prepared afresh and its
    launch counts read just after it: (b) --per-channel --calibrate 1,
    sym_i8; (c) --prequantize --backend xla, residual and delta, asym_u8,
    uncalibrated.  Returns the launches to add to the paths' counts and
    those of (c)'s product kernels at the merged projections (kept
    apart)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    L = cfg.n_layers
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    totals = dict(zero)
    apart = {"lut_matmul": 0, "residual_matmul": 0, "delta_matmul": 0}

    def parse(argv):
        return serve.build_parser().parse_args(argv)

    def served(tag, r):
        rows[tag] = {"prefill_ms": r.t_prefill * 1e3,
                     "prefill_tok_s": B * P / r.t_prefill,
                     "decode_ms_per_step": r.t_decode * 1e3 / (G - 1),
                     "prepare_s": r.t_prepare,
                     "peak_gib": r.peak_bytes / 2**30}
        log(f"[options] {tag}: prepare {r.t_prepare:.3f}s; prefill {B}x{P} "
            f"{r.t_prefill * 1e3:.3f} ms ({B * P / r.t_prefill:.1f} tok/s);"
            f" decode {r.t_decode * 1e3 / (G - 1):.3f} ms/step; peak device "
            f"memory {r.peak_bytes / 2**30:.3f} GiB; sample ids "
            f"{r.out[0][:12].tolist()}")
        assert r.out.shape == (B, G) and np.isfinite(r.logits).all()
        assert ((r.out >= 0) & (r.out < cfg.vocab)).all()

    # (b) per-channel weight scales, calibrated, sym_i8
    args = parse(ARGS + ["--quant-mode", "sym_i8", "--per-channel"])
    with PlainGuard():
        ops.reset_launches()
        r = serve.run(args)
        c = _launched("options", "(b) --per-channel", dict(
            zero, delta_matmul=7 * L * CALIB_TOKENS,
            fused_qdot=4 * L * (G + 2),
            decode_attention=L * (CALIB_TOKENS + G)))
    for k in totals:
        totals[k] += c[k]
    served("(b) --per-channel --calibrate 1 sym_i8", r)
    del r
    torch.cuda.empty_cache()

    # (c) the uncalibrated backends: the product-LUT gather (serve's
    # default), the rank-32 emulation and the delta product, 112 launches
    # a forward each
    for be, kernel in (("xla", "lut_matmul"), ("residual", "residual_matmul"),
                       ("delta", "delta_matmul")):
        args = parse(["--arch", "qwen3-1.7b", "--requests", str(B),
                      "--prompt-len", str(P), "--gen-len", str(G),
                      "--prequantize", "--backend", be, "--quant-mode",
                      "asym_u8"])
        with PlainGuard():
            ops.reset_launches()
            r = serve.run(args)
            # warm prefill + warm decode + timed prefill + G-1 steps
            c = _launched("options", f"(c) --backend {be}", dict(
                zero, **{kernel: 4 * L * (G + 2)}, decode_attention=L * G))
        for k in totals:
            totals[k] += 0 if k == kernel else c[k]
        apart[kernel] += c[kernel]
        served(f"(c) --prequantize --backend {be} asym_u8", r)
        del r
        torch.cuda.empty_cache()
    return totals, apart


def serve_options_parity(cfg_full):
    """Phase 12 at PARITY_LAYERS of full width, every launch of the card's
    run
    held against its plain version on the CPU (CpuShadow): (a)
    --continuous 3 over 2 slots, calibrated, asym_u8; (d) the quantized
    unembed on (a)'s tree, its prefill launch (M*K*N above 2^30 gathers)
    held against the plain version on the card; (b) per-channel scales,
    calibrated, sym_i8; (c) the xla and residual backends, uncalibrated."""
    import numpy as np
    import torch
    from repro_torch.kernels import check
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = dataclasses.replace(cfg_full, n_layers=PARITY_LAYERS)
    torch.set_num_threads(os.cpu_count() or 1)
    _, params_gpu = _card_params(cfg, 7)
    b, p, g = 2, 4, 3
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    args = serve.build_parser().parse_args(
        ["--requests", str(b), "--prompt-len", str(p), "--gen-len", str(g),
         "--calibrate", "1", "--continuous", "3"])
    q = serve.quant_config(args)
    t0 = time.perf_counter()
    with check.CpuShadow(check.CpuShadow.serving(q.backend),
                         card_gathers=PARITY_CARD_GATHERS) as sh:
        tree, _, _ = serve.prepare_params(params_gpu, cfg, q, args,
                                          device="cuda")
        out = serve.serve_continuous(tree, cfg, q, args,
                                     np.random.default_rng(0), "cuda")[0]
    _shadow_log("(a) --continuous 3 over 2 slots", sh, t0)
    log(f"[parity] (a) card ids {out.tolist()}")
    qu = dataclasses.replace(q, quant_unembed=True)
    t0 = time.perf_counter()
    with check.CpuShadow(check.CpuShadow.serving(q.backend),
                         card_gathers=1 << 30) as sh:
        st = T.init_decode_state(cfg, b, p + 3, device="cuda")
        tok, _, st = make_prefill_step(cfg, qu)(
            tree, st, torch.as_tensor(prompts, device="cuda"))
        for _ in range(2):
            tok, lg, st = make_serve_step(cfg, qu)(tree, st, tok)
    _shadow_log("(d) quant_unembed", sh, t0)
    held = sh.stats["delta_matmul"]
    assert held["calls"] == 3 and held["on_card"] == 1, held
    assert bool(torch.isfinite(lg).all())
    del tree, st
    cal = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    for tag, q in (("(b) --per-channel sym_i8",
                    QuantConfig(backend="fused", mode="sym_i8",
                                w_per_channel=True, inference=True)),
                   ("(c) --backend xla", QuantConfig(
                       backend="xla", mode="asym_u8", inference=True)),
                   ("(c) --backend residual", QuantConfig(
                       backend="residual", mode="asym_u8", inference=True))):
        t0 = time.perf_counter()
        with check.CpuShadow(check.CpuShadow.serving(q.backend),
                             card_gathers=PARITY_CARD_GATHERS) as sh:
            _, ids, _, _ = _serve_once(cfg, params_gpu, q, None, cal,
                                       prompts, g, "cuda")
        _shadow_log(tag, sh, t0)
        log(f"[parity] {tag}: card ids {ids.tolist()}")
    torch.cuda.empty_cache()


def moe_full_width():
    """Phase 13: serve each MoE config of MOE_RUNS at full width and cut
    depth through launch.serve's prepare and run (--calibrate 1, 4
    requests, prompt 64, gen 16), asym_u8 and sym_i8, each run's launch
    counts read just after it and held to the path's: a calibration token
    launches one delta_matmul a projection (attention, router, every
    expert and the shared expert unmerged), a forward one fused_qdot a
    merged projection and every expert's three.  Returns {arch: launches
    of its runs} and the rows."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    launches, rows = {}, {}
    for arch, layers in MOE_RUNS:
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        L = cfg.n_layers
        calib_pl, serve_pl = moe_per_layer(cfg)
        want = dict.fromkeys(ops.LAUNCHES, 0)
        # calibration tokens; warm prefill + warm decode + timed prefill +
        # G-1 decode steps
        want.update(delta_matmul=calib_pl * L * CALIB_TOKENS,
                    fused_qdot=serve_pl * L * (G + 2),
                    decode_attention=L * (CALIB_TOKENS + G))
        launches[arch] = dict.fromkeys(ops.LAUNCHES, 0)
        for mode in ("asym_u8", "sym_i8"):
            args = serve.build_parser().parse_args(
                ["--arch", arch, "--requests", str(B), "--prompt-len",
                 str(P), "--gen-len", str(G), "--calibrate", "1",
                 "--quant-mode", mode])
            tag = f"{arch} ({L} of {configs.get(arch).n_layers} layers) " \
                  f"{mode}"
            with PlainGuard():
                ops.reset_launches()
                prepared = serve.prepare(args, cfg=cfg)
                r = serve.run(args, prepared)
                counts = _launched("moe", tag, want)
            sites = len(prepared.table.sites)
            del prepared
            for k in counts:
                launches[arch][k] += counts[k]
            assert sites == calib_pl * L, (sites, calib_pl * L)
            assert r.out.shape == (B, G), r.out.shape
            assert ((r.out >= 0) & (r.out < cfg.vocab)).all()
            assert r.logits.shape == (B, 1, cfg.vocab), r.logits.shape
            assert np.isfinite(r.logits).all(), "non-finite logits"
            rows[f"{arch} {mode}"] = {
                "layers": L, "prepare_s": r.t_prepare,
                "prefill_ms": r.t_prefill * 1e3,
                "prefill_tok_s": B * P / r.t_prefill,
                "decode_ms_per_step": r.t_decode * 1e3 / (G - 1),
                "peak_gib": r.peak_bytes / 2**30,
                "fused_qdot_per_step": serve_pl * L,
                "decode_attention_per_step": L,
                "delta_matmul_per_calibration_token": calib_pl * L,
                "calibration_sites": sites}
            log(f"[moe] {tag}: prepare (init + prequantize + calibrate) "
                f"{r.t_prepare:.3f}s, warmup {r.t_warmup:.3f}s; prefill "
                f"{B}x{P} {r.t_prefill * 1e3:.3f} ms "
                f"({B * P / r.t_prefill:.1f} tok/s); decode {r.t_decode * 1e3 / (G - 1):.3f} ms/step; "
                f"peak device memory {r.peak_bytes / 2**30:.3f} GiB; a decode "
                f"step launches {serve_pl * L} fused_qdot + {L} "
                f"decode_attention, a calibration token {calib_pl * L} "
                f"delta_matmul + {L} decode_attention; {sites} calibration "
                f"sites; sample ids {r.out[0][:12].tolist()}")
            del r
            torch.cuda.empty_cache()
    log("[moe] " + json.dumps({"moe": rows}))
    return launches


def moe_parity_one_layer():
    """Phase 13's parity: one layer of each MoE config at full width,
    served calibrated in both modes on the card with every kernel launch
    held against its plain version (CpuShadow): on the CPU, or on the
    card for a launch of more than MOE_CARD_GATHERS gathers."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    torch.set_num_threads(os.cpu_count() or 1)
    b, p, g = 2, 4, 3
    for arch, _ in MOE_RUNS:
        cfg = dataclasses.replace(configs.get(arch), n_layers=1)
        calib_pl, serve_pl = moe_per_layer(cfg)
        params = T.init_params(torch.Generator(device="cuda").manual_seed(11),
                               cfg, device="cuda")
        rng = np.random.default_rng(12)
        cal = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
        prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
        for mode in ("asym_u8", "sym_i8"):
            q = QuantConfig(design="design2", backend="fused", mode=mode,
                            inference=True)
            t0 = time.perf_counter()
            with check.CpuShadow(card_gathers=MOE_CARD_GATHERS) as sh:
                _, ids, lgs, _ = _serve_once(cfg, params, q, None, cal,
                                             prompts, g, "cuda")
            tag = f"{arch} (1 layer) {mode}"
            _shadow_log(tag, sh, t0)
            st = sh.stats
            # calibration: p + 2 tokens; serving: the prefill and g - 1
            # decode steps
            want = {"delta_matmul": calib_pl * (p + 2),
                    "fused_qdot_packed": serve_pl * g,
                    "decode_attention": (p + 2) + (g - 1)}
            got = {k: st[k]["calls"] for k in want}
            assert got == want, (tag, got, want)
            assert st["fused_qdot_packed"]["on_card"] > 0
            assert st["fused_qdot_packed"]["on_card"] < want[
                "fused_qdot_packed"]
            assert all(bool(torch.isfinite(x).all()) for x in lgs)
            log(f"[parity] {tag}: card ids {ids.tolist()}")
        del params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 14: the remaining decoder families (dense gemma-7b, minitron-8b,
# nemotron-4-340b; hybrid recurrentgemma-2b; ssm xlstm-125m)
# ---------------------------------------------------------------------------

def family_shapes(cfg):
    """The projections of one pattern unit of a config: (calibration,
    serve), each a list of (name, K, N), one entry a projection call:
    calibration runs every projection unmerged, serving the merged ones
    (attention's wqkv, a GLU MLP's w_gateup; the mLSTM keeps wq/wk/wv)."""
    D, H, Kv, hd, F, R = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                          cfg.d_ff, cfg.d_rnn)
    glu = cfg.mlp_kind in ("geglu", "swiglu")
    calib, serve = [], []
    for kind in cfg.pattern:
        if kind == "attn":
            calib += [("wq", D, H * hd), ("wk", D, Kv * hd),
                      ("wv", D, Kv * hd), ("wo", H * hd, D)]
            serve += [("wqkv", D, (H + 2 * Kv) * hd), ("wo", H * hd, D)]
        elif kind == "rec":
            both = [("rec w_in/w_gate_x/w_gate_a", D, R)] * 3 + [
                ("rec w_out", R, D)]
            calib += both
            serve += both
        elif kind == "mlstm":
            both = [("mlstm wq/wk/wv/wo", D, D)] * 4 + [
                ("mlstm wi/wf", D, H)] * 2
            calib += both
            serve += both
        elif kind == "slstm":
            both = [("slstm wz/wi/wf/wo_gate/wo", D, D)] * 5
            calib += both
            serve += both
        if kind in ("attn", "rec") and F:
            if glu:
                calib += [("w_gate/w_up", D, F)] * 2
                serve += [("w_gateup", D, 2 * F)]
            else:
                calib += [("w_up", D, F)]
                serve += [("w_up", D, F)]
            calib += [("w_down", F, D)]
            serve += [("w_down", F, D)]
    return calib, serve


def distinct(shapes):
    """(name, K, N, calls) per distinct (K, N) of a family_shapes list."""
    out = {}
    for name, K, N in shapes:
        if (K, N) in out:
            n0, _, _, c = out[(K, N)]
            out[(K, N)] = (n0, K, N, c + 1)
        else:
            out[(K, N)] = (name, K, N, 1)
    return list(out.values())


def family_per_model(cfg):
    """(delta_matmul launches a calibration token, fused_qdot launches a
    forward, decode_attention launches a decode step) of the whole model:
    one projection a launch, one attention layer an attention launch."""
    calib, serve = family_shapes(cfg)
    n = cfg.n_units
    return (len(calib) * n, len(serve) * n,
            sum(k == "attn" for k in cfg.pattern) * n)


def family_attention_cases(sms):
    """decode_attention cases of phase 3 at the new configs' heads:
    (tag, H, Kv, hd, window, B, S, pos).  The paths' positions (decode at
    S = P + G, calibration at P + 2), long context, the chunk edges of a
    4096-position cache, and recurrentgemma's window of 2048 with
    positions past it; gemma's 16/16 and a group of 16 (the opt-in shared
    memory) beside them."""
    from repro_torch import configs
    from repro_torch.kernels import check
    cases = []
    for arch in ("nemotron-4-340b", "recurrentgemma-2b", "gemma-7b"):
        cfg = configs.get(arch)
        H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        w = cfg.window if cfg.family == "hybrid" else None
        cases += [(f"{arch} decode", H, Kv, hd, w, B, P + G,
                   [64, 70, 75, 79]),
                  (f"{arch} calibration", H, Kv, hd, w, B, CALIB_TOKENS,
                   [0, 1, 33, 65]),
                  (f"{arch} long context", H, Kv, hd, w, B, 4096,
                   [0, 1023, 2500, 4095])]
        edges = check.attention_edge_positions(4096, B, Kv, hd, sms)
        edges = edges[:B] + edges[-B:]
        for i in range(0, len(edges), B):
            cases.append((f"{arch} chunk edges", H, Kv, hd, w, B, 4096,
                          (edges[i:i + B] + [4095] * B)[:B]))
        if w:
            S = w + 552
            cases += [(f"{arch} window {w}, past it", H, Kv, hd, w, B, S,
                       [w - 1, w, w + 100, S - 1])]
            edges = check.attention_edge_positions(S, B, Kv, hd, sms)
            for i in range(0, len(edges), B):
                cases.append((f"{arch} window {w}, chunk edges", H, Kv, hd,
                              w, B, S, (edges[i:i + B] + [S - 1] * B)[:B]))
    cases.append(("group 16, hd 256 (shared memory above 48 KiB)", 16, 1,
                  256, None, B, 4096, [0, 2047, 2048, 4095]))
    return cases


def check_family_kernels(dev, errs):
    """Phase 3 at the new configs' full-width shapes: delta_matmul at
    every calibration projection and fused_qdot at every serve projection
    (M = B, both modes; the mLSTM gates' N = 4, nemotron's K = 73,728,
    the recurrent D x D and D x R), the int32 range at K = 73,728 through
    both kernels on every schedule (fused_qdot at M = 4, 5 and 9; held
    also against the CPU's plain version), and decode_attention at query
    groups 12 (hd 192), 10 (hd 256, Kv = 1, window 2048) and 16/16
    (family_attention_cases).  Folds the max errors into ``errs``."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check
    n = 0
    for arch, _ in FAMILY_RUNS:
        cfg = configs.get(arch)
        calib, serve = (distinct(x) for x in family_shapes(cfg))
        for signed in (False, True):
            mode = "sym_i8" if signed else "asym_u8"
            for i, (name, K, N, _) in enumerate(calib):
                check.check_delta(check.delta_case(B, K, N, signed, 1400 + i,
                                                   dev, device_draw=True))
                n += 1
            for i, (name, K, N, _) in enumerate(serve):
                r = check.check_fused(check.fused_case(
                    B, K, N, signed, 1450 + i, dev, device_draw=True))
                errs["fused_qdot"] = max(errs["fused_qdot"],
                                         r["max_abs_err"])
                n += 1
            log(f"[kernels] {arch} {mode}: delta_matmul at its "
                f"{len(calib)} calibration shapes and fused_qdot at its "
                f"{len(serve)} serve shapes (M = {B}): "
                f"{[(k, nn) for _, k, nn, _ in serve]} held")
        torch.cuda.empty_cache()
    for design in ("design2", "initial"):
        for M in (4, 5):
            r = check.check_range(check.range_delta_case(M, 40, M, dev,
                                                         design),
                                  "delta_matmul")
            n += 1
            log(f"[kernels] delta_matmul int32 range {design} M={M} "
                f"K={check.RANGE_K} N=40: {r['past_2_31']} outputs past "
                f"2^31, bit-exact (card plain == CPU plain)")
    for M in (4, 5, 9):
        for comp in (False, True):
            r = check.check_range(check.range_fused_case(M, 40, M, dev,
                                                         compensate=comp),
                                  "fused_qdot")
            n += 1
            log(f"[kernels] fused_qdot int32 range M={M} K={check.RANGE_K} "
                f"compensate={comp}: {r['past_2_31']} outputs past 2^31, "
                f"max |err| {r['max_abs_err']:.3e}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0
    for j, (tag, H, Kv, hd, w, Bq, S, pos) in enumerate(
            family_attention_cases(sms)):
        case = check.attention_case(Bq, S, H, Kv, hd, 1500 + j, dev,
                                    qk_norm=False, window=w, pos=pos)
        r = check.check_attention(case)
        a = check.check_attention_append(case)
        n += 2
        worst = max(worst, r["row_flips"])
        errs["decode_attention"] = max(errs["decode_attention"],
                                       r["max_abs_err"])
        log(f"[kernels] decode_attention {tag} H/Kv={H}/{Kv} hd={hd} S={S} "
            f"pos={pos} window={w}: v rows bit-exact, {r['row_flips']} of "
            f"{r['row_entries']} k-row entries a bf16 step apart, max |out "
            f"err| {r['max_abs_err']:.3e}; two launches bit-equal; the "
            f"append in place ({a['row_flips']} k-row entries apart)")
        del case
    log(f"[kernels] new families' shapes: {n} cases held against their "
        f"plain versions")


def families_full_width():
    """Phase 14: serve each config of FAMILY_RUNS at full width and its
    depth through launch.serve's prepare and run (--calibrate 1, 4
    requests, prompt 64, gen 16), asym_u8 and sym_i8, each run's launch
    counts read just after it and held to the path's (family_per_model).
    Returns {arch: launches of its runs}."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    launches, rows = {}, {}
    for arch, layers in FAMILY_RUNS:
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        calib_pt, serve_pf, attn_ps = family_per_model(cfg)
        want = dict.fromkeys(ops.LAUNCHES, 0)
        want.update(delta_matmul=calib_pt * CALIB_TOKENS,
                    fused_qdot=serve_pf * (G + 2),
                    decode_attention=attn_ps * (CALIB_TOKENS + G))
        launches[arch] = dict.fromkeys(ops.LAUNCHES, 0)
        for mode in ("asym_u8", "sym_i8"):
            args = serve.build_parser().parse_args(
                ["--arch", arch, "--requests", str(B), "--prompt-len",
                 str(P), "--gen-len", str(G), "--calibrate", "1",
                 "--quant-mode", mode])
            tag = f"{arch} ({layers} of {configs.get(arch).n_layers} " \
                  f"layers) {mode}"
            with PlainGuard():
                ops.reset_launches()
                prepared = serve.prepare(args, cfg=cfg)
                r = serve.run(args, prepared)
                counts = _launched("family", tag, want)
            sites = len(prepared.table.sites)
            del prepared
            for k in counts:
                launches[arch][k] += counts[k]
            assert sites == calib_pt, (sites, calib_pt)
            assert r.out.shape == (B, G), r.out.shape
            assert ((r.out >= 0) & (r.out < cfg.vocab)).all()
            assert r.logits.shape == (B, 1, cfg.vocab), r.logits.shape
            assert np.isfinite(r.logits).all(), "non-finite logits"
            rows[f"{arch} {mode}"] = {
                "layers": layers, "prepare_s": r.t_prepare,
                "prefill_ms": r.t_prefill * 1e3,
                "prefill_tok_s": B * P / r.t_prefill,
                "decode_ms_per_step": r.t_decode * 1e3 / (G - 1),
                "peak_gib": r.peak_bytes / 2**30,
                "fused_qdot_per_step": serve_pf,
                "decode_attention_per_step": attn_ps,
                "delta_matmul_per_calibration_token": calib_pt,
                "calibration_sites": sites}
            log(f"[family] {tag}: prepare (init + prequantize + calibrate) "
                f"{r.t_prepare:.3f}s, warmup {r.t_warmup:.3f}s; prefill "
                f"{B}x{P} {r.t_prefill * 1e3:.3f} ms "
                f"({B * P / r.t_prefill:.1f} tok/s); decode "
                f"{r.t_decode * 1e3 / (G - 1):.3f} ms/step; peak device "
                f"memory {r.peak_bytes / 2**30:.3f} GiB; a decode step "
                f"launches {serve_pf} fused_qdot + {attn_ps} "
                f"decode_attention, a calibration token {calib_pt} "
                f"delta_matmul + {attn_ps} decode_attention; {sites} "
                f"calibration sites; sample ids {r.out[0][:12].tolist()}")
            del r
            torch.cuda.empty_cache()
    log("[family] " + json.dumps({"families": rows}))
    return launches


def families_parity_one_unit():
    """Phase 14's parity: one pattern unit of each config at full width
    (1 layer of the dense configs, 3 of the recurrent ones), served
    calibrated in both modes on the card with every kernel launch held
    against its plain version (CpuShadow): on the CPU, or on the card for
    a launch of more than PARITY_CARD_GATHERS gathers."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    torch.set_num_threads(os.cpu_count() or 1)
    b, p, g = 2, 3, 2
    for arch, _ in FAMILY_RUNS:
        base = configs.get(arch)
        cfg = dataclasses.replace(base, n_layers=len(base.pattern))
        calib_pt, serve_pf, attn_ps = family_per_model(cfg)
        params = T.init_params(torch.Generator(device="cuda").manual_seed(13),
                               cfg, device="cuda")
        rng = np.random.default_rng(14)
        cal = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
        prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
        names = ("delta_matmul", "fused_qdot_packed") + (
            ("decode_attention",) if attn_ps else ())
        for mode in ("asym_u8", "sym_i8"):
            q = QuantConfig(design="design2", backend="fused", mode=mode,
                            inference=True)
            t0 = time.perf_counter()
            with check.CpuShadow(names,
                                 card_gathers=PARITY_CARD_GATHERS) as sh:
                _, ids, lgs, _ = _serve_once(cfg, params, q, None, cal,
                                             prompts, g, "cuda")
            tag = f"{arch} (one unit, {cfg.n_layers} layers) {mode}"
            _shadow_log(tag, sh, t0)
            want = {"delta_matmul": calib_pt * (p + 2),
                    "fused_qdot_packed": serve_pf * g}
            if attn_ps:
                want["decode_attention"] = attn_ps * ((p + 2) + (g - 1))
            got = {k: sh.stats[k]["calls"] for k in want}
            assert got == want, (tag, got, want)
            assert all(bool(torch.isfinite(x).all()) for x in lgs)
            log(f"[parity] {tag}: card ids {ids.tolist()}")
        del params
        torch.cuda.empty_cache()


def time_family_kernels(dev):
    """Phase 8 at the new configs' shapes (phase 14's), asym_u8, each case
    held against its plain version on the card before it is timed:
    fused_qdot at every distinct serve projection at decode and prefill
    M, delta_matmul at every distinct calibration projection (M = B),
    decode_attention at the serve path's position and at 4095 of 4096
    (qk-norm off, the config's window).  Returns {kernel: {arch: {shape:
    row}}}."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check, ops, ref
    from repro_torch.kernels.check import cuda_time
    rows = {"fused_qdot": {}, "delta_matmul": {}, "decode_attention": {}}
    for arch, _ in FAMILY_RUNS:
        cfg = configs.get(arch)
        calib, serve = (distinct(x) for x in family_shapes(cfg))
        for k in rows:
            rows[k][arch] = {}
        for i, (name, K, N, calls) in enumerate(serve):
            for M in (B, B * P):
                c = check.fused_case(M, K, N, False, 1600 + i, dev,
                                     device_draw=True)
                err = check.check_fused(c)["max_abs_err"]
                big = M * K * N > (1 << 33)
                plain = cuda_time(lambda: check.fused_plain(c), 1,
                                  warmup=0 if big else 1)
                r = row("fused_qdot", f"{arch} {name} M={M} K={K} N={N}",
                        lambda: ops.fused_qdot_packed(**c),
                        50 if M <= B else 10, plain, fused_bound(M, K, N),
                        gathers=M * K * N, b=c["qw"])
                rows["fused_qdot"][arch][f"{name} M={M}"] = dict(
                    r, max_abs_err=err, calls_per_unit=calls)
                del c
        for i, (name, K, N, calls) in enumerate(calib):
            c = check.delta_case(B, K, N, False, 1650 + i, dev,
                                 device_draw=True)
            err = check.check_delta(c)["max_abs_err"]
            r = row("delta_matmul", f"{arch} {name} M={B} K={K} N={N} "
                    f"(calibration)", lambda: ops.delta_matmul(**c), 50,
                    cuda_time(lambda: check.delta_plain(c), 2),
                    delta_bound(B, K, N))
            rows["delta_matmul"][arch][f"{name} M={B}"] = dict(
                r, max_abs_err=err, calls_per_unit=calls)
        if "attn" in cfg.pattern:
            H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
            w = cfg.window
            for S, pos, it in ((P + G, P + G // 2, 200), (4096, 4095, 50)):
                c = check.attention_case(B, S, H, Kv, hd, 1700 + S, dev,
                                         qk_norm=False, window=w,
                                         pos=[pos] * B)
                err = check.check_attention(c)["max_abs_err"]
                r = row("decode_attention", f"{arch} B={B} H={H} Kv={Kv} "
                        f"hd={hd} S={S} pos={pos} window={w} step",
                        lambda: ops.decode_attention_step(**c), it,
                        cuda_time(lambda: ref.decode_attention_step_ref(**c),
                                  20 if S < 1024 else 3),
                        attention_bound(B, H, Kv, hd, pos, w))
                rows["decode_attention"][arch][f"B={B} S={S}"] = dict(
                    r, max_abs_err=err)
                del c
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 15: the encoder-decoder whisper-small and the VLM internvl2-76b
# ---------------------------------------------------------------------------

def encdec_shapes(cfg):
    """A whisper layer's projections, each a list of (name, K, N), one
    entry a projection call: (calibration a decoder layer, serve a
    decoder layer, the encoder a layer).  Calibration runs the decoder's
    projections unmerged and the cross block's four; serving merges the
    decoder's wq|wk|wv (fuse_projections leaves the encoder and the cross
    blocks apart); the cross block's wk and wv run over the encoder
    output's rows (M = B x frames), its wq and wo over the tokens'."""
    D, H, Kv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    attn = [("wq", D, H * hd), ("wk", D, Kv * hd), ("wv", D, Kv * hd),
            ("wo", H * hd, D)]
    mlp = [("w_up", D, F), ("w_down", F, D)]
    cross = [("cross " + n, K, N) for n, K, N in attn]
    calib = attn + mlp + cross
    serve = [("wqkv", D, (H + 2 * Kv) * hd), ("wo", H * hd, D)] + mlp \
        + cross
    return calib, serve, attn + mlp


def encdec_per_model(cfg):
    """(delta_matmul launches a calibration token, fused_qdot launches a
    forward, decode_attention launches a decode step, launches of an
    encoder pass) of the whole model: one projection a launch; the cross
    attention is torch ops, never the decode kernel."""
    calib, serve, enc = encdec_shapes(cfg)
    return (len(calib) * cfg.n_layers, len(serve) * cfg.n_layers,
            cfg.n_layers, len(enc) * cfg.enc_layers)


def encdec_kernel_cases(cfg):
    """The distinct kernel shapes of phase 15's whisper runs:
    (fused_qdot cases, delta_matmul cases), each (name, M, K, N): decode
    (M = B) and prefill (M = B*P) at every serve projection, the encoder
    and the cross block's k/v at M = B x 16 frames (serve) and B x 1,500
    (the config's encoder length, the last tile ragged); calibration's
    unfused products at M = B (tokens) and B x 16 (the encoder, the cross
    k/v)."""
    from repro_torch.launch.serve import ENC_FRAMES
    calib, serve, enc = encdec_shapes(cfg)
    fused, delta = {}, {}
    for M in (B, B * P):
        for name, K, N in serve:
            fused.setdefault((M, K, N), name)
    for M in (B * ENC_FRAMES, B * cfg.enc_seq):
        for name, K, N in enc + [("cross wk/wv", cfg.d_model,
                                  cfg.n_kv * cfg.hd)]:
            fused.setdefault((M, K, N), name)
    for name, K, N in calib:
        delta.setdefault((B, K, N), name)
    for name, K, N in enc:
        delta.setdefault((B * ENC_FRAMES, K, N), name)
    return ([(n, *k) for k, n in fused.items()],
            [(n, *k) for k, n in delta.items()])


def vlm_shapes(cfg):
    """internvl2's lut_matmul shapes, (name, K, N): the merged serve
    projections of a layer (--prequantize: 'xla'), the unmerged ones of
    forward_train, and the prefix projection."""
    D, H, Kv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    serve = [("wqkv", D, (H + 2 * Kv) * hd), ("wo", H * hd, D),
             ("w_gateup", D, 2 * F), ("w_down", F, D)]
    train = [("wq", D, H * hd), ("wk", D, Kv * hd), ("wv", D, Kv * hd),
             ("wo", H * hd, D), ("w_gate", D, F), ("w_up", D, F),
             ("w_down", F, D)]
    return serve, train, ("frontend_proj", cfg.frontend_dim, D)


def check_encdec_vlm_kernels(dev, errs):
    """Phase 3 at phase 15's shapes (full width): fused_qdot at every
    whisper serve shape (encdec_kernel_cases: M = 4, 64, 256 and 6,000)
    and delta_matmul at its calibration shapes, both modes;
    decode_attention at 12/12 heads of hd 64 (rope, no qk-norm) at the
    serve and calibration positions and the chunk edges of its 448
    positions, and at internvl2's 64/8 of hd 128; lut_matmul at
    internvl2's merged serve projections (M = 4 both modes, M = 256
    asym_u8) and its prefix projection (M = 512, both modes).  Folds the
    max errors into ``errs``."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check
    cfg = configs.get("whisper-small")
    fused, delta = encdec_kernel_cases(cfg)
    n = 0
    for signed in (False, True):
        mode = "sym_i8" if signed else "asym_u8"
        for i, (name, M, K, N) in enumerate(fused):
            r = check.check_fused(check.fused_case(M, K, N, signed, 1800 + i,
                                                   dev))
            errs["fused_qdot"] = max(errs["fused_qdot"], r["max_abs_err"])
            n += 1
        for i, (name, M, K, N) in enumerate(delta):
            check.check_delta(check.delta_case(M, K, N, signed, 1850 + i,
                                               dev))
            n += 1
        log(f"[kernels] whisper-small {mode}: fused_qdot at "
            f"{[(m, k, nn) for _, m, k, nn in fused]} and delta_matmul at "
            f"{[(m, k, nn) for _, m, k, nn in delta]} held")
    vcfg = configs.get("internvl2-76b")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("whisper-small decode", cfg, P + G, [64, 70, 75, 79]),
             ("whisper-small calibration", cfg, CALIB_TOKENS,
              [0, 1, 33, 65]),
             ("internvl2-76b decode", vcfg, P + G, [64, 70, 75, 79])]
    edges = check.attention_edge_positions(cfg.max_seq, B, cfg.n_kv,
                                           cfg.hd, sms)
    for i in range(0, len(edges), B):
        cases.append(("whisper-small chunk edges", cfg, cfg.max_seq,
                      (edges[i:i + B] + [cfg.max_seq - 1] * B)[:B]))
    for j, (tag, c, S, pos) in enumerate(cases):
        H, Kv, hd = c.n_heads, c.n_kv, c.hd
        case = check.attention_case(B, S, H, Kv, hd, 1900 + j, dev,
                                    qk_norm=False, pos=pos)
        r = check.check_attention(case)
        a = check.check_attention_append(case)
        n += 2
        errs["decode_attention"] = max(errs["decode_attention"],
                                       r["max_abs_err"])
        log(f"[kernels] decode_attention {tag} H/Kv={H}/{Kv} "
            f"hd={hd} S={S} pos={pos}: {r['row_flips']} of "
            f"{r['row_entries']} k-row entries a bf16 step apart, max |out "
            f"err| {r['max_abs_err']:.3e}; the append in place "
            f"({a['row_flips']} apart)")
        del case
    serve, _, (pname, pK, pN) = vlm_shapes(vcfg)
    for signed in (False, True):
        mode = "sym_i8" if signed else "asym_u8"
        todo = [(name, B, K, N) for name, K, N in serve]
        if not signed:
            todo += [(name, B * P, K, N) for name, K, N in serve]
        todo.append((pname, 2 * vcfg.n_prefix, pK, pN))
        for i, (name, M, K, N) in enumerate(todo):
            check.check_lut(check.lut_case(M, K, N, signed, 1950 + i, dev,
                                           shifted=False, device_draw=True))
            n += 1
            log(f"[kernels] lut_matmul internvl2-76b {mode} {name} M={M} "
                f"K={K} N={N}: bit-exact")
            torch.cuda.empty_cache()
    log(f"[kernels] phase 15's shapes: {n} cases held against their plain "
        f"versions")


def time_encdec_vlm_kernels(dev):
    """Phase 8 at phase 15's shapes, asym_u8, each case held against its
    plain version on the card before it is timed: whisper's fused_qdot
    and delta_matmul cases (encdec_kernel_cases), its and internvl2's
    decode_attention at the serve path's position; internvl2's lut_matmul
    at the merged serve projections (M = 4 and 256) and the prefix
    projection (M = 512).
    Returns {kernel: {arch: {shape: row}}}."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check, ops, ref
    from repro_torch.kernels.check import cuda_time
    cfg = configs.get("whisper-small")
    fused, delta = encdec_kernel_cases(cfg)
    rows = {"fused_qdot": {"whisper-small": {}},
            "delta_matmul": {"whisper-small": {}},
            "decode_attention": {"whisper-small": {}},
            "lut_matmul": {"internvl2-76b": {}}}
    for i, (name, M, K, N) in enumerate(fused):
        c = check.fused_case(M, K, N, False, 2000 + i, dev)
        err = check.check_fused(c)["max_abs_err"]
        big = M * K * N > (1 << 33)
        r = row("fused_qdot", f"whisper-small {name} M={M} K={K} N={N}",
                lambda: ops.fused_qdot_packed(**c), 50 if M <= B else 10,
                cuda_time(lambda: check.fused_plain(c), 1 if big else 2,
                          warmup=0 if big else 2),
                fused_bound(M, K, N), gathers=M * K * N, b=c["qw"])
        rows["fused_qdot"]["whisper-small"][f"{name} M={M}"] = dict(
            r, max_abs_err=err)
    for i, (name, M, K, N) in enumerate(delta):
        c = check.delta_case(M, K, N, False, 2050 + i, dev)
        err = check.check_delta(c)["max_abs_err"]
        r = row("delta_matmul", f"whisper-small {name} M={M} K={K} N={N} "
                f"(calibration)", lambda: ops.delta_matmul(**c), 50,
                cuda_time(lambda: check.delta_plain(c), 2),
                delta_bound(M, K, N))
        rows["delta_matmul"]["whisper-small"][f"{name} M={M}"] = dict(
            r, max_abs_err=err)
    vcfg = configs.get("internvl2-76b")
    rows["decode_attention"]["internvl2-76b"] = {}
    pos = P + G // 2
    for arch, c_ in (("whisper-small", cfg), ("internvl2-76b", vcfg)):
        H, Kv, hd = c_.n_heads, c_.n_kv, c_.hd
        c = check.attention_case(B, P + G, H, Kv, hd, 2090, dev,
                                 qk_norm=False, pos=[pos] * B)
        err = check.check_attention(c)["max_abs_err"]
        r = row("decode_attention", f"{arch} B={B} H={H} Kv={Kv} hd={hd} "
                f"S={P + G} pos={pos} qk-norm off step",
                lambda: ops.decode_attention_step(**c), 200,
                cuda_time(lambda: ref.decode_attention_step_ref(**c), 20),
                attention_bound(B, H, Kv, hd, pos))
        rows["decode_attention"][arch][f"B={B} S={P + G}"] = dict(
            r, max_abs_err=err)
    serve, _, (pname, pK, pN) = vlm_shapes(vcfg)
    todo = [(name, M, K, N) for M in (B, B * P) for name, K, N in serve]
    todo.append((pname, 2 * vcfg.n_prefix, pK, pN))
    for i, (name, M, K, N) in enumerate(todo):
        c = check.lut_case(M, K, N, False, 2100 + i, dev, shifted=False,
                           device_draw=True)
        check.check_lut(c)
        big = M * K * N > (1 << 33)
        r = row("lut_matmul", f"internvl2-76b {name} M={M} K={K} N={N}",
                lambda: ops.lut_matmul(**c), 50 if M <= B else 5,
                cuda_time(lambda: check.lut_plain(c), 1,
                          warmup=0 if big else 1),
                lut_bound(M, K, N), gathers=M * K * N, b=c["b"],
                offset=c["offset"])
        rows["lut_matmul"]["internvl2-76b"][f"{name} M={M}"] = dict(
            r, max_abs_err=0.0)
        del c
        torch.cuda.empty_cache()
    return rows


def _serve_rows(tag, r, extra):
    """A phase-15 run's JSON row and log line."""
    row_ = {"prepare_s": r.t_prepare, "prefill_ms": r.t_prefill * 1e3,
            "prefill_tok_s": B * P / r.t_prefill,
            "decode_ms_per_step": r.t_decode * 1e3 / (G - 1),
            "peak_gib": r.peak_bytes / 2**30, **extra}
    log(f"[encdec/vlm] {tag}: prepare {r.t_prepare:.3f}s, warmup "
        f"{r.t_warmup:.3f}s; prefill {B}x{P} {r.t_prefill * 1e3:.3f} ms "
        f"({B * P / r.t_prefill:.1f} tok/s); decode "
        f"{r.t_decode * 1e3 / (G - 1):.3f} ms/step; peak device memory "
        f"{r.peak_bytes / 2**30:.3f} GiB; {json.dumps(extra)}; sample ids "
        f"{r.out[0][:12].tolist()}")
    return row_


def _check_served(r, cfg):
    import numpy as np
    assert r.out.shape == (B, G), r.out.shape
    assert ((r.out >= 0) & (r.out < cfg.vocab)).all()
    assert r.logits.shape == (B, 1, cfg.vocab), r.logits.shape
    assert np.isfinite(r.logits).all(), "non-finite logits"


def whisper_full_width(rows):
    """Phase 15 (a): whisper-small whole (12 + 12 layers, every width)
    through serve's prepare and run, --calibrate 1, 4 requests, prompt
    64, gen 16, asym_u8 and sym_i8, each run's launch counts read just
    after it and held to the path's (encdec_per_model): a calibration
    batch runs the encoder once (its 72 projections) and 10 projections
    a decoder layer a token; serve encodes the requests once, then 8
    projections a decoder layer a forward.  Returns (launches, the
    asym_u8 calibration table)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = configs.get("whisper-small")
    calib_pt, serve_pf, attn_ps, enc_pp = encdec_per_model(cfg)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(delta_matmul=enc_pp + calib_pt * CALIB_TOKENS,
                fused_qdot=enc_pp + serve_pf * (G + 2),
                decode_attention=attn_ps * (CALIB_TOKENS + G))
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    table = None
    for mode in ("asym_u8", "sym_i8"):
        args = serve.build_parser().parse_args(
            ["--arch", "whisper-small", "--requests", str(B), "--prompt-len",
             str(P), "--gen-len", str(G), "--calibrate", "1",
             "--quant-mode", mode])
        tag = f"whisper-small (12 + 12 layers) {mode}"
        with PlainGuard():
            ops.reset_launches()
            prepared = serve.prepare(args)
            r = serve.run(args, prepared)
            counts = _launched("encdec", tag, want)
        sites = len(prepared.table.sites)
        if mode == "asym_u8":
            table = prepared.table
        del prepared
        for k in counts:
            launches[k] += counts[k]
        assert sites == calib_pt + enc_pp, (sites, calib_pt + enc_pp)
        _check_served(r, cfg)
        rows[f"whisper-small {mode}"] = _serve_rows(tag, r, {
            "encoder_frames": serve.ENC_FRAMES,
            "encoder_ms": r.t_encode * 1e3, "fused_qdot_per_step": serve_pf,
            "fused_qdot_per_encoder": enc_pp,
            "decode_attention_per_step": attn_ps,
            "delta_matmul_per_calibration_token": calib_pt,
            "calibration_sites": sites})
        del r
        torch.cuda.empty_cache()
    return launches, table


def whisper_long_encoder(table, rows):
    """Phase 15 (b): whisper-small over the config's own encoder length
    (enc_seq = 1,500 frames; serve's requests carry 16), asym_u8, on (a)'s
    calibration table: serve's prepare and run (``enc_frames``), the
    encoder once (72 fused_qdot at M = 6,000, the last tile ragged), then
    every forward's 24 cross k/v projections at M = 6,000; launch counts
    held to the path's."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = configs.get("whisper-small")
    _, serve_pf, attn_ps, enc_pp = encdec_per_model(cfg)
    args = serve.build_parser().parse_args(
        ["--arch", "whisper-small", "--requests", str(B), "--prompt-len",
         str(P), "--gen-len", str(G), "--calibrate", "1"])
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(fused_qdot=enc_pp + serve_pf * (G + 2),
                decode_attention=attn_ps * G)
    tag = f"whisper-small, {cfg.enc_seq} encoder frames, asym_u8"
    with PlainGuard():
        prepared = serve.prepare(args, table=table)
        ops.reset_launches()
        r = serve.run(args, prepared, enc_frames=cfg.enc_seq)
        counts = _launched("encdec", tag, want)
    del prepared
    _check_served(r, cfg)
    rows[f"whisper-small {cfg.enc_seq} frames asym_u8"] = _serve_rows(
        tag, r, {"encoder_frames": cfg.enc_seq,
                 "encoder_ms": r.t_encode * 1e3,
                 "fused_qdot_per_step": serve_pf,
                 "fused_qdot_per_encoder": enc_pp,
                 "cross_kv_rows": B * cfg.enc_seq})
    torch.cuda.empty_cache()
    return counts


VLM_LAYERS = 4                  # internvl2-76b's depth on the card, of 80


def vlm_full_width(rows):
    """Phase 15 (c): internvl2-76b at VLM_LAYERS of 80 layers, every
    width as published, --prequantize ('xla': every projection a
    lut_matmul), 4 requests, prompt 64, gen 16, asym_u8 and sym_i8; serve
    prepends no prefix.  Launch counts held to the path's: 4 lut_matmul a
    layer a forward, one decode_attention a layer a decode step."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    base = configs.get("internvl2-76b")
    cfg = dataclasses.replace(base, n_layers=VLM_LAYERS)
    serve_shapes, _, _ = vlm_shapes(cfg)
    L = cfg.n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(lut_matmul=len(serve_shapes) * L * (G + 2),
                decode_attention=L * G)
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    for mode in ("asym_u8", "sym_i8"):
        args = serve.build_parser().parse_args(
            ["--arch", "internvl2-76b", "--requests", str(B), "--prompt-len",
             str(P), "--gen-len", str(G), "--prequantize", "--quant-mode",
             mode])
        tag = f"internvl2-76b ({L} of {base.n_layers} layers) {mode}"
        with PlainGuard():
            ops.reset_launches()
            prepared = serve.prepare(args, cfg=cfg)
            r = serve.run(args, prepared)
            counts = _launched("vlm", tag, want)
        del prepared
        for k in counts:
            launches[k] += counts[k]
        _check_served(r, cfg)
        rows[f"internvl2-76b {mode}"] = _serve_rows(tag, r, {
            "layers": L, "lut_matmul_per_step": len(serve_shapes) * L,
            "decode_attention_per_step": L})
        del r
        torch.cuda.empty_cache()
    return launches


def encdec_vlm_parity_one_unit():
    """Phase 15 (d): one pattern unit of each at full width, every kernel
    launch held against its plain version (CpuShadow).  whisper-small at
    one encoder layer, one decoder layer and its cross block, served
    calibrated in both modes (on the CPU: every launch is small);
    internvl2-76b's remat train step at one layer (parity_train_step,
    'xla', asym_u8; sym_i8's lut_matmul shapes are phase 3's), B = 2
    with the 256-patch prefix and 64 tokens: the prefix projection (M =
    512) and the layer's 7 projections (M = 640) and their 7 recomputes,
    each held against its plain version on the card, each recompute
    equal to its forward."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    torch.set_num_threads(os.cpu_count() or 1)
    from repro_torch.launch.serve import ENC_FRAMES
    cfg = dataclasses.replace(configs.get("whisper-small"), n_layers=1,
                              enc_layers=1)
    calib_pt, serve_pf, attn_ps, enc_pp = encdec_per_model(cfg)
    b, p, g = 2, 3, 3
    params = T.init_params(torch.Generator(device="cuda").manual_seed(15),
                           cfg, device="cuda")
    rng = np.random.default_rng(16)
    cal_frames = rng.normal(size=(b, ENC_FRAMES, cfg.d_model)).astype(
        np.float32)
    cal = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    frames = rng.normal(size=(b, ENC_FRAMES, cfg.d_model)).astype(
        np.float32)
    for mode in ("asym_u8", "sym_i8"):
        q = QuantConfig(design="design2", backend="fused", mode=mode,
                        inference=True)
        t0 = time.perf_counter()
        with check.CpuShadow() as sh:
            _, ids, lgs, _ = _serve_once(cfg, params, q, None, cal, prompts,
                                         g, "cuda", cal_frames=cal_frames,
                                         frames=frames)
        tag = f"whisper-small (1 + 1 layers) {mode}"
        _shadow_log(tag, sh, t0)
        want = {"delta_matmul": enc_pp + calib_pt * (p + 2),
                "fused_qdot_packed": enc_pp + serve_pf * g,
                "decode_attention": attn_ps * ((p + 2) + (g - 1))}
        got = {k: sh.stats[k]["calls"] for k in want}
        assert got == want, (tag, got, want)
        assert all(bool(torch.isfinite(x).all()) for x in lgs)
        log(f"[parity] {tag}: card ids {ids.tolist()}")
    del params
    vcfg = dataclasses.replace(configs.get("internvl2-76b"), n_layers=1)
    _, train_shapes, _ = vlm_shapes(vcfg)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             configs.make_smoke_batch(vcfg, 2, P, seed=18).items()}
    assert tuple(batch["frontend"].shape) == (2, vcfg.n_prefix,
                                              vcfg.frontend_dim)
    _, st = parity_train_step(vcfg, "internvl2-76b train step (1 layer, "
                              "prefix 256) asym_u8", batch, MOE_CARD_GATHERS)
    assert st["calls"] == 1 + 2 * len(train_shapes), st
    assert st["on_card"] == st["calls"], st
    del batch
    torch.cuda.empty_cache()


def row(kernel, shape, fn, iters, plain_ms, bounds, gathers=None, b=None,
        offset=0):
    """One timing row of phase 8.  ``gathers`` (the gather kernels: M*K*N
    table reads a call) adds the gather rate over device_ms and its share
    of the load/store units' lane rate, SMs x 32 lanes x the SM clock
    read right after the timing, and the mean wavefronts a warp's gather
    costs on the weights ``b`` (check.gather_wavefronts)."""
    import torch
    from repro_torch.kernels import check
    from repro_torch.kernels.check import cuda_time
    b_bytes, b_ops = bounds
    r = {"kernel": kernel, "shape": shape, "ms": cuda_time(fn, iters),
         "device_ms": cuda_time(fn, iters, queued=True),
         "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops) * 1e3,
         "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
    if gathers is not None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = sm_clock_mhz()
        rate = gathers / (r["device_ms"] * 1e-3)
        r.update(sm_clock_mhz=clock, gathers_per_s=rate,
                 gather_share=rate / (sms * 32 * clock * 1e6),
                 wavefronts=check.gather_wavefronts(b, offset))
    log("[timing] " + json.dumps(r))
    return r


def time_moe_kernels(dev):
    """Phase 8 at the MoE family's shapes (phase 13's), asym_u8, each case
    held against its plain version on the card before it is timed:
    fused_qdot at every serve projection of a layer at decode and prefill
    M, delta_matmul at every calibration projection, decode_attention at
    the serve path's position (qk-norm off, the config's window).
    Returns {kernel: {arch: {shape: row}}}."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import check, ops, ref
    from repro_torch.kernels.check import cuda_time
    moe_rows = {"fused_qdot": {}, "delta_matmul": {}, "decode_attention": {}}
    for arch, _ in MOE_RUNS:
        mcfg = configs.get(arch)
        calib, serve = moe_shapes(mcfg)
        for k in moe_rows:
            moe_rows[k][arch] = {}
        for i, (name, K, N, m_dec, m_pre, _) in enumerate(serve):
            for M in (m_dec, m_pre):
                c = check.fused_case(M, K, N, False, 980 + i, dev)
                err = check.check_fused(c)["max_abs_err"]
                r = row("fused_qdot", f"{arch} {name} M={M} K={K} N={N}",
                        lambda: ops.fused_qdot_packed(**c),
                        50 if M <= B else 10,
                        cuda_time(lambda: check.fused_plain(c), 2),
                        fused_bound(M, K, N), gathers=M * K * N, b=c["qw"])
                moe_rows["fused_qdot"][arch][f"{name} M={M}"] = dict(
                    r, max_abs_err=err)
                del c
        for i, (name, K, N, M, _) in enumerate(calib):
            c = check.delta_case(M, K, N, False, 990 + i, dev)
            err = check.check_delta(c)["max_abs_err"]
            r = row("delta_matmul", f"{arch} {name} M={M} K={K} N={N} "
                    f"(calibration)", lambda: ops.delta_matmul(**c), 50,
                    cuda_time(lambda: check.delta_plain(c), 2),
                    delta_bound(M, K, N))
            moe_rows["delta_matmul"][arch][f"{name} M={M}"] = dict(
                r, max_abs_err=err)
        H, Kv, hd = mcfg.n_heads, mcfg.n_kv, mcfg.hd
        pos = P + G // 2
        c = check.attention_case(B, P + G, H, Kv, hd, 995, dev,
                                 qk_norm=False, window=mcfg.window,
                                 pos=[pos] * B)
        err = check.check_attention(c)["max_abs_err"]
        r = row("decode_attention", f"{arch} B={B} H={H} Kv={Kv} hd={hd} "
                f"S={P + G} pos={pos} qk-norm off step",
                lambda: ops.decode_attention_step(**c), 200,
                cuda_time(lambda: ref.decode_attention_step_ref(**c), 20),
                attention_bound(B, H, Kv, hd, pos))
        moe_rows["decode_attention"][arch][f"B={B} S={P + G}"] = dict(
            r, max_abs_err=err)
        torch.cuda.empty_cache()
    return moe_rows


def time_kernels(cfg, dev):
    import torch
    from repro_torch.kernels import check, ops, ref
    from repro_torch.kernels.check import cuda_time
    unmerged, merged = projection_shapes(cfg)
    summary = {}

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
                      cuda_time(lambda: check.delta_plain(c), 5),
                      delta_bound(B, K, N)))
    summary["delta_matmul"] = (mean(rs, [1] * len(rs)), rs)
    # 'initial' asym_u8 through its biased table beside design2's rows
    # (logged only: the JSON keeps design2's)
    for i, (name, K, N) in enumerate(unmerged):
        if name in ("wq", "w_down"):
            c = check.delta_case(B, K, N, False, i, dev, design="initial")
            row("delta_matmul", f"{name} M={B} K={K} N={N} initial",
                lambda: ops.delta_matmul(**c), 50,
                cuda_time(lambda: check.delta_plain(c), 5),
                delta_bound(B, K, N))
    for i, (name, K, N) in enumerate(merged):
        for M in (B, B * P):
            if name in ("wqkv", "w_down"):
                c = check.fused_case(M, K, N, False, 100 + i, dev,
                                     design="initial")
                row("fused_qdot", f"{name} M={M} K={K} N={N} initial",
                    lambda: ops.fused_qdot_packed(**c), 50 if M == B else 10,
                    cuda_time(lambda: check.fused_plain(c), 3),
                    fused_bound(M, K, N))
    # delta_matmul at the planned QAT step (sym_i8, M = TB*TS): the four
    # training projection shapes, weighted by the projections of a layer
    # that have each
    M = TB * TS
    rs, w = [], []
    for i, (name, K, N) in enumerate(train_kinds(cfg)):
        c = check.delta_case(M, K, N, True, 700 + i, dev)
        rs.append(row("delta_matmul", f"{name} M={M} K={K} N={N} sym_i8 "
                      f"(plan QAT)", lambda: ops.delta_matmul(**c), 10,
                      cuda_time(lambda: check.delta_plain(c), 2),
                      delta_bound(M, K, N)))
        w.append(name.count("/") + 1)
    plan_qat = (mean(rs, w), rs)

    # fused_qdot: the 4 merged projections at decode (M=B) and prefill
    # (M=B*P), weighted by the serve run's forwards (2 prefill, G decode)
    rs, w = [], []
    for i, (name, K, N) in enumerate(merged):
        for M, weight in ((B, G), (B * P, 2)):
            c = check.fused_case(M, K, N, False, 100 + i, dev)
            it = 50 if M == B else 10
            rs.append(row("fused_qdot", f"{name} M={M} K={K} N={N}",
                          lambda: ops.fused_qdot_packed(**c), it,
                          cuda_time(lambda: check.fused_plain(c), 3),
                          fused_bound(M, K, N), gathers=M * K * N,
                          b=c["qw"]))
            w.append(weight)
    summary["fused_qdot"] = (mean(rs, w), rs)

    # decode_attention: every slot at mid-decode position P + G/2 of an
    # S=P+G cache (the step, as earlier trees timed it, is the JSON
    # line's row; the path's call, with the append, beside it), then at
    # 4095 of 4096 (long context)
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    for S, pos, it in ((P + G, P + G // 2, 200), (4096, 4095, 50)):
        c = check.attention_case(B, S, H, Kv, hd, 7, dev, pos=[pos] * B)
        kc, vc = c["k_cache"].clone(), c["v_cache"].clone()
        plain = cuda_time(lambda: ref.decode_attention_step_ref(**c),
                          50 if S < 1024 else 5)
        shape = f"B={B} H={H} Kv={Kv} hd={hd} S={S} pos={pos}"
        r = row("decode_attention", f"{shape} step",
                lambda: ops.decode_attention_step(**c), it, plain,
                attention_bound(B, H, Kv, hd, pos))
        row("decode_attention", f"{shape} append",
            lambda: ops.decode_attention(
                c["q"][:, None], c["k_new"][:, None], c["v_new"][:, None],
                kc, vc, c["pos"], n_heads=H, n_kv=Kv, head_dim=hd,
                rope_theta=c["theta"], q_gain=c["q_gain"],
                k_gain=c["k_gain"]), it, plain,
            attention_bound(B, H, Kv, hd, pos))
        if S == P + G:
            summary["decode_attention"] = (
                {k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                   "bound_ms")}, [r])
        del c, kc, vc
        torch.cuda.empty_cache()

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

    # phase 12's shapes, each case held against its plain version before it
    # is timed: the product kernels of serve --backend xla, residual and
    # delta at the merged projections, decode (M = B) and prefill
    # (M = B*P), each projection once a layer; delta_matmul at the
    # quantized unembed's vocabulary width
    def serve_case(kname, M, K, N, seed):
        """(case, kernel call, plain call, check, bound) of one launch."""
        if kname == "lut_matmul":
            c = check.lut_case(M, K, N, False, seed, dev, shifted=False)
            return (c, lambda: ops.lut_matmul(**c),
                    lambda: check.lut_plain(c), check.check_lut,
                    lut_bound(M, K, N))
        if kname == "residual_matmul":
            c = check.residual_case(M, K, N, False, RANK, seed, dev)
            return (c, lambda: ops.residual_matmul(**c),
                    lambda: ref.residual_corrected_matmul_ref(**c),
                    check.check_residual, residual_bound(M, K, N, RANK))
        c = check.delta_case(M, K, N, False, seed, dev)
        return (c, lambda: ops.delta_matmul(**c),
                lambda: check.delta_plain(c), check.check_delta,
                delta_bound(M, K, N))

    def held_row(kname, shape, M, K, N, seed, iters, plain_iters):
        c, fn, plain, chk, bound = serve_case(kname, M, K, N, seed)
        err = chk(c)["max_abs_err"]
        r = row(kname, shape, fn, iters, cuda_time(plain, plain_iters),
                bound)
        r["max_abs_err"] = err
        log(f"[timing] {kname} {shape}: held against its plain version, "
            f"max |err| {err:.3e}")
        return r

    serve_rows = {}
    for j, kname in enumerate(("lut_matmul", "residual_matmul",
                               "delta_matmul")):
        by_m = {}
        for i, (name, K, N) in enumerate(merged):
            for M in (B, B * P):
                by_m.setdefault(M, []).append(held_row(
                    kname, f"{name} M={M} K={K} N={N} (serve)", M, K, N,
                    800 + 10 * j + i, 20 if M == B else 5, 2))
        serve_rows[kname] = {"serve": {
            f"M={M}": dict(mean(rs, [1] * len(rs)),
                           bound_by=rs[0]["bound_by"],
                           max_abs_err=max(r["max_abs_err"] for r in rs))
            for M, rs in by_m.items()}}
    # fused_qdot at minitron-8b's decode step (M = 8, asym_u8 with
    # compensation: the split-K schedule at 8 rows a thread)
    m8 = {}
    for i, (name, K, N) in enumerate(MINITRON_MERGED):
        c = check.fused_case(8, K, N, False, 860 + i, dev)
        err = check.check_fused(c)["max_abs_err"]
        r = row("fused_qdot", f"minitron-8b {name} M=8 K={K} N={N}",
                lambda: ops.fused_qdot_packed(**c), 50,
                cuda_time(lambda: check.fused_plain(c), 3),
                fused_bound(8, K, N), gathers=8 * K * N, b=c["qw"])
        m8[f"{name} M=8"] = dict(r, max_abs_err=err)
    serve_rows["fused_qdot"] = {"minitron_decode": m8}
    K, N = cfg.d_model, cfg.vocab
    serve_rows["delta_matmul"]["unembed"] = {
        f"M={M}": held_row("delta_matmul", f"unembed M={M} K={K} N={N}", M,
                           K, N, 820 + M, it, 1)
        for M, it in ((B, 20), (B * P, 2))}
    torch.cuda.empty_cache()

    log("[timing] library_ms is null: no single PyTorch call computes the "
        "approximate (delta-table) product, the fused quantize-product-"
        "dequant, the qk-norm/rope/bf16-row decode attention step, the "
        "product-LUT gather sum or the exact product plus the "
        "correction-table gather sum")
    return summary, plan_qat, serve_rows


def kernels_json(summary, plan_qat, serve_rows, moe_rows, launches,
                 moe_launches, errs, fam_rows, fam_launches, ev_rows,
                 ev_launches, prefill_rows, tf_rows, tf_launches):
    """The kernels' JSON record: per kernel the launches of the paths'
    runs, the max error of phase 3 and the timings of phase 8 (for
    delta_matmul also its planned-QAT shape, ``plan_qat``, and the
    quantized unembed's, ``unembed``; for the three product kernels the
    merged projections of phase 12 (c), ``serve``; for fused_qdot
    minitron-8b's merged projections at M = 8, ``minitron_decode``, with
    no launches of a path of their own; for the three serving
    kernels the MoE family's shapes, ``moe``, and phase 14's,
    ``families``, per config; phase 15's, ``encdec_vlm``, per config:
    whisper-small's three serving kernels and internvl2-76b's
    lut_matmul); for residual_matmul phase 17's cache-free prefill,
    ``prefill_logits`` (per config its ms, peak GiB and launches); for
    the two training kernels phase 18's shapes, ``train_families`` (per
    config, the launches of its two runs), each with the launches of its
    own runs."""
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")
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
        if name == "residual_matmul":
            kernels[-1]["prefill_logits"] = {
                **prefill_rows,
                "launches": launches["residual_matmul_prefill_logits"]}
        if name == "delta_matmul":
            qm, qrs = plan_qat
            kernels[-1]["plan_qat"] = {
                "launches": launches["delta_matmul_plan_qat"],
                **{k: qm[k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms")},
                "bound_by": qrs[0]["bound_by"]}
        for sub, by_m in serve_rows.get(name, {}).items():
            kernels[-1][sub] = {
                "launches": launches.get(f"{name}_{sub}"),
                **{m: {k: r[k] for k in keys if k in r}
                   for m, r in by_m.items()}}
        for sub, sub_rows, sub_launches in (
                ("moe", moe_rows, moe_launches),
                ("families", fam_rows, fam_launches),
                ("encdec_vlm", ev_rows, ev_launches),
                ("train_families", tf_rows, tf_launches)):
            if name in sub_rows:
                kernels[-1][sub] = {
                    arch: {"launches": sub_launches[arch][name],
                           **{tag: {k: r[k] for k in keys if k in r}
                              for tag, r in by_shape.items()}}
                    for arch, by_shape in sub_rows[name].items()}
    return kernels


def _kernel_name(name: str) -> str:
    """A device kernel's name without its return type, namespaces,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    for cut in "<(":
        name = name.split(cut)[0]
    return name.split("::")[-1].strip()[:60] or "?"


def trace_decode(cfg, steps: int = 4):
    """torch.profiler over ``steps`` full-width decode steps of the serve
    path (asym_u8, calibrated, merged projections, as phase 4 runs it),
    after a prefill and two warm steps.  Prints the step's wall time
    with and without the profiler, the device kernels launched per step
    by name with their device time, the device's busy share of the
    traced window (the union of device activity over the wall time) and
    the host-side op counts per step (aten ops and the port's kernel
    wrappers, ops.LAUNCHES)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import make_prefill_step, make_serve_step
    args = serve.build_parser().parse_args(ARGS + ["--quant-mode",
                                                   "asym_u8"])
    dev = torch.device("cuda")
    q = QuantConfig(design=args.design, backend="fused", mode="asym_u8",
                    inference=True)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    params, _, _ = serve.prepare_params(params, cfg, q, args, device=dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, P))
    state = T.init_decode_state(cfg, B, P + G, device=dev)
    tok, _, state = make_prefill_step(cfg, q)(
        params, state, torch.as_tensor(prompts.astype(np.int32), device=dev))
    step = make_serve_step(cfg, q)
    for _ in range(2):
        tok, _, state = step(params, state, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, _, state = step(params, state, tok)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, _, state = step(params, state, tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    wrappers = {k: v / steps for k, v in ops.LAUNCHES.items() if v}
    events = list(prof.events())
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = {}        # aten ops the Python code calls (not those inside)
    for e in events:
        parent = e.cpu_parent
        if e.device_type == DeviceType.CPU and e.name.startswith("aten::") \
                and not (parent and parent.name.startswith("aten::")):
            host[e.name] = host.get(e.name, 0) + 1
    log(f"[trace] {steps} full-width decode steps (asym_u8, B={B}): "
        f"{plain_ms:.3f} ms/step untraced, {wall_us / 1e3 / steps:.3f} "
        f"ms/step under the profiler")
    log(f"[trace] host, per step: {sum(host.values()) / steps:.1f} aten "
        f"ops called from Python; kernel wrapper launches {wrappers}")
    log("[trace] host, top aten ops per step: " + json.dumps(
        {k: v / steps for k, v in sorted(host.items(),
                                         key=lambda kv: -kv[1])[:12]}))
    if not dev_ev:
        log("[trace] the profiler recorded no device time on this machine: "
            "the device side is not traced; the host-side counts above "
            "stand alone")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_ev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_name = {}
    for e in dev_ev:
        n = _kernel_name(e.name)
        c, t = by_name.get(n, (0, 0.0))
        by_name[n] = (c + 1, t + e.time_range.elapsed_us())
    log(f"[trace] device, per step: {len(dev_ev) / steps:.1f} launches "
        f"(kernels, copies, sets), busy {busy / 1e3 / steps:.3f} ms of "
        f"{wall_us / 1e3 / steps:.3f} ms wall: busy share "
        f"{busy / wall_us:.4f}")
    log("[trace] device launches per step by name (count, device us): "
        + json.dumps({n: [c / steps, t / steps] for n, (c, t) in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])}))


# ---------------------------------------------------------------------------
# phase 16: the paper's applications, its tables and the examples
# ---------------------------------------------------------------------------

# Table 5's designs (sharpening, unsigned) and table_edge_detection's
# (Sobel, signed)
APP_SHARPEN = ("exact", "design1", "design2", "initial", "momeni15",
               "sabetzadeh14", "venkatachalam16")
APP_EDGES = ("design1", "design2", "design1_trunc4", "bw_design1")
# one 3840 x 2160 frame: the size of frame a user of a sharpening filter
# runs
APP_FRAME = (2160, 3840)
APP_REPS = 5
EXAMPLES = (("quickstart_torch.py", []),
            ("image_sharpening_torch.py", []),
            ("train_approx_lm_torch.py", ["--steps", "5"]))


def _example(fname: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        fname[:-3], os.path.join(HERE, "examples", fname))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applications(smi: str) -> None:
    """(a) blur and sharpen of the synthetic set per Table 5 design, (b)
    Sobel gradients and edge maps per signed design, (c) the rows of the
    tables that run on the card, each on the card and held equal to the same call on the CPU; (d) one
    3840 x 2160 frame sharpened per design, timed, held to the CPU once;
    (e) the three torch examples on the card."""
    import numpy as np
    import torch
    from repro_torch.app import edge_detection as ed
    from repro_torch.app import sharpening as sh
    from repro_torch.app import tables
    from repro_torch.kernels import check, ops
    dev = torch.device("cuda")
    secs = {}
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    imgs = sh.make_test_images()
    for d in APP_SHARPEN:
        for img in imgs:
            for fn in (sh.blur, sh.sharpen):
                got = fn(img, d, dev)
                assert got.is_cuda and torch.equal(got.cpu(),
                                                   fn(img, d, "cpu")), \
                    f"{fn.__name__} {d}: card != CPU"
    secs["a"] = time.perf_counter() - t0
    log(f"[apps] (a) blur and sharpen of {len(imgs)} images x "
        f"{len(APP_SHARPEN)} designs: card == CPU")

    t0 = time.perf_counter()
    for d in APP_EDGES:
        for img in imgs:
            for got, want in zip(ed.gradients(img, d, dev),
                                 ed.gradients(img, d, "cpu")):
                assert got.is_cuda and torch.equal(got.cpu(), want), d
            got = ed.edge_map(img, d, device=dev)
            assert torch.equal(got.cpu(), ed.edge_map(img, d, device="cpu")), d
    secs["b"] = time.perf_counter() - t0
    log(f"[apps] (b) Sobel gradients and edge maps of {len(imgs)} images x "
        f"{len(APP_EDGES)} signed designs: card == CPU")

    t0 = time.perf_counter()
    for name in tables.DEVICE_TABLES:
        got = tables.rows(name, dev)
        assert got == tables.rows(name, "cpu"), f"{name}: card != CPU"
        log(f"[apps] (c) {name} on the card: " + json.dumps(got))
    secs["c"] = time.perf_counter() - t0
    log(f"[apps] (c) the rows of {len(tables.DEVICE_TABLES)} tables: card "
        f"== CPU")

    t0 = time.perf_counter()
    frame = sh.make_test_images(1, size=APP_FRAME)[0]
    x = torch.from_numpy(frame).to(dev)
    frame_ms, device_ms, cpu_ms = {}, {}, {}
    for d in APP_SHARPEN:
        sh.sharpen(x, d, dev)                        # warm-up
        ts = []
        for _ in range(APP_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = sh.sharpen(x, d, dev)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        frame_ms[d] = float(np.median(ts))
        device_ms[d] = check.cuda_time(
            functools.partial(sh.sharpen, x, d, dev), APP_REPS, warmup=0,
            queued=True)
        t = time.perf_counter()
        want = sh.sharpen(frame, d, "cpu")
        cpu_ms[d] = (time.perf_counter() - t) * 1e3
        assert torch.equal(got.cpu(), want), f"{d}: 3840 x 2160 card != CPU"
    secs["d"] = time.perf_counter() - t0
    # the least a frame could take: its bytes (uint8 in, uint8 out) at the
    # card's memory rate
    bound_ms = 2 * frame.size / HBM_BPS * 1e3
    log(f"[apps] (d) sharpen of one {APP_FRAME[1]} x {APP_FRAME[0]} frame "
        f"on the card, ms (median of {APP_REPS} after a warm-up, host clock "
        f"to a synchronize): {json.dumps(frame_ms)}; device ms (CUDA "
        f"events, {APP_REPS} calls queued behind a spin): "
        f"{json.dumps(device_ms)}; bound {bound_ms!r} ms (bytes); the same "
        f"on the CPU once, ms: {json.dumps(cpu_ms)}; card == CPU; {smi}")

    t0 = time.perf_counter()
    counts = {}
    for fname, extra in EXAMPLES:
        ops.reset_launches()
        log(f"[apps] (e) examples/{fname} {' '.join(extra)}")
        out = _example(fname).main(["--device", "cuda"] + extra)
        counts[fname] = {k: v for k, v in ops.LAUNCHES.items() if v}
        if fname == "quickstart_torch.py":
            assert out == 0, f"lut_matmul != its plain version: {out}"
            assert counts[fname].get("lut_matmul") == 1, counts[fname]
        elif fname == "image_sharpening_torch.py":
            want = sh.sharpen(imgs[0], "design2", "cpu").numpy()
            assert np.array_equal(np.load(out), want), out
        else:
            assert all(np.isfinite(v) for v in out), out
            assert counts[fname].get("lut_matmul", 0) > 0, counts[fname]
    secs["e"] = time.perf_counter() - t0
    log(f"[apps] (e) kernel launches per example: {json.dumps(counts)}")
    secs["all"] = time.perf_counter() - t_phase
    log("[apps] phase 16 seconds: " + json.dumps(
        {k: round(v, 1) for k, v in secs.items()}))


# ---------------------------------------------------------------------------
# phase 17: multi-device on one card
# ---------------------------------------------------------------------------

DRYRUN_DIR = os.path.join(HERE, "build", "dryrun_torch")
# make_prefill_logits on the card: (arch, layers of its depth, None for
# whole), B = 2 requests of 64 tokens, whisper's 16 encoder frames a
# request, internvl2's 256 prefix rows (M = 512 through frontend_proj)
PREFILL_RUNS = (("qwen3-1.7b", 1), ("whisper-small", None),
                ("internvl2-76b", 1))
PREFILL_B, PREFILL_S, PREFILL_FRAMES = 2, 64, 16
# qwen3's card logits against the CPU's plain run fed the card's products:
# the largest gap allowed, relative to max |logit| (phase 17 (b); the
# card's and the CPU's glue ops, rmsnorm, attention and the unembed, sum
# in other orders: 2.05e-6 measured on the same chain through the
# bit-exact delta_matmul, which needs no feed)
PREFILL_CPU_REL = 1e-5


def dryrun_meshes(smi: str) -> dict:
    """Phase 17 (a): launch.dryrun --all in process on the 16x16 and the
    2x16x16 mesh (32 cells each, every one OK), the largest per-device
    arguments of each mesh and the cells whose arguments alone exceed
    this card's memory.  CPU only: meta tensors, no device."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import dryrun
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for multi in (False, True):
        mesh = "2x16x16" if multi else "16x16"
        path = os.path.join(DRYRUN_DIR, mesh)
        shutil.rmtree(path, ignore_errors=True)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = dryrun.main(["--all", "--out", path]
                             + (["--multi-pod"] if multi else []))
        dt = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        assert rc == 0, "\n".join(lines)
        assert lines[-1] == "dry-run complete: 32/32 cells OK", lines[-1]
        assert sum(x.startswith("OK   ") for x in lines) == 32
        recs = []
        for f in sorted(os.listdir(path)):
            with open(os.path.join(path, f)) as fh:
                recs.append(json.load(fh))
        assert len(recs) == 32, len(recs)
        big = max(recs, key=lambda r: r["argument_bytes_per_device"])
        over = [f"{r['arch']} {r['shape']}" for r in recs
                if r["argument_bytes_per_device"] > total]
        gib = big["argument_bytes_per_device"] / 2**30
        log(f"[dryrun] {mesh}: 32/32 cells OK in {dt:.2f}s; largest "
            f"arguments a device {gib:.3f} GiB ({big['arch']} "
            f"{big['shape']}); {len(over)} of 32 cells' arguments alone "
            f"exceed this card's {total / 2**30:.2f} GiB ({smi}): "
            f"{over}")
        out[mesh] = {"seconds": dt, "largest_gib": gib,
                     "largest_cell": f"{big['arch']} {big['shape']}",
                     "cells_over_card": len(over)}
    return out


def depth_cut(arch, layers):
    """(``arch``'s full-width config cut to ``layers`` of its depth, or
    whole for None; its tag for the log)."""
    from repro_torch import configs
    base = configs.get(arch)
    if layers is None:
        return base, f"{arch} ({base.n_layers} layers)"
    cfg = dataclasses.replace(base, n_layers=layers)
    return cfg, f"{arch} ({layers} of {base.n_layers} layers)"


def prefill_logits_launches(cfg) -> int:
    """residual_matmul launches of one make_prefill_logits call: one a
    projection; whisper's encoder layers (attention and MLP) and each
    decoder layer's cross block besides its own; the VLM's
    frontend_proj."""
    glu = cfg.mlp_kind in ("geglu", "swiglu")
    layer = 4 + (3 if glu else 2)
    n = layer * cfg.n_layers
    if cfg.family == "encdec":
        n += layer * cfg.enc_layers + 4 * cfg.n_layers
    if cfg.family == "vlm" and cfg.frontend_dim != cfg.d_model:
        n += 1
    return n


def _prefill_batch(cfg, seed, device):
    import numpy as np
    import torch
    from repro_torch import configs
    b = configs.make_smoke_batch(cfg, PREFILL_B, PREFILL_S, seed=seed)
    batch = {"tokens": b["tokens"]}
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed + 1)
        batch["frontend"] = rng.normal(size=(
            PREFILL_B, PREFILL_FRAMES, cfg.frontend_dim or cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "vlm":
        batch["frontend"] = b["frontend"]
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class FedCardProducts:
    """While active on a CPU run, ops.residual_matmul takes the card
    run's launches in order (``calls``: the card's (a, b, out) of each,
    on the host): each launch's operands must equal the card's, its
    plain version on them is held to the card's product
    (check.RESID_TOL_REL of max |out|), and the card's product is
    returned, so the CPU's glue ops run on the card's products."""

    def __init__(self, calls):
        self.calls, self.n, self.max_rel = calls, 0, 0.0

    def __enter__(self):
        from repro_torch.kernels import check, ops, ref
        self.ops, self.saved = ops, ops.residual_matmul

        def fed(a, b, F, G, offset=0):
            ca, cb, cout = self.calls[self.n]
            self.n += 1
            assert torch_equal(a, ca) and torch_equal(b, cb), \
                f"launch {self.n}: the CPU's operands left the card's"
            want = ref.residual_corrected_matmul_ref(a, b, F, G, offset)
            err = check._resid_err(cout, want)
            self.max_rel = max(self.max_rel, err["max_rel_err"])
            return cout
        ops.residual_matmul = fed
        return self

    def __exit__(self, *exc):
        self.ops.residual_matmul = self.saved


def torch_equal(x, y) -> bool:
    import torch
    return x.shape == y.shape and bool(torch.equal(x.to(y.dtype), y))


class RecordCardProducts:
    """While active, every residual_matmul launch's operands and product
    are copied to the host, in order."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved, self.calls = ops, ops.residual_matmul, []

        def rec(a, b, F, G, offset=0):
            out = self.saved(a, b, F, G, offset)
            self.calls.append((a.cpu(), b.cpu(), out.cpu()))
            return out
        ops.residual_matmul = rec
        return self

    def __exit__(self, *exc):
        self.ops.residual_matmul = self.saved


class LaunchShapes:
    """While active, residual_matmul launches pass through and the first
    launch of each distinct shape keeps its operands (on the card) with
    the count of launches of that shape, for timing it after the run."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved, self.shapes = ops, ops.residual_matmul, {}

        def seen(a, b, F, G, offset=0):
            key = (*a.shape, b.shape[1], F.shape[1], offset)
            if key in self.shapes:
                self.shapes[key][1] += 1
            else:
                self.shapes[key] = [(a, b, F, G, offset), 1]
            return self.saved(a, b, F, G, offset)
        ops.residual_matmul = seen
        return self

    def __exit__(self, *exc):
        self.ops.residual_matmul = self.saved


def time_prefill_shapes(tag, shapes) -> dict:
    """Phase 8's timing row (CUDA events, ``device_ms`` queued behind a
    spin) of residual_matmul at each distinct shape of one
    make_prefill_logits call, its plain version's ms on the card and its
    bound; and the launches' device time in the call, the sum over the
    shapes of launches x device_ms."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.check import cuda_time
    rows, kernel_ms = {}, 0.0
    for (M, K, N, r, offset), (args, n) in shapes.items():
        big = M * K * N > (1 << 33)
        r_ = row("residual_matmul", f"{tag} prefill M={M} K={K} N={N} r={r}",
                 lambda: ops.residual_matmul(*args), 2 if big else 20,
                 cuda_time(lambda: ref.residual_corrected_matmul_ref(*args),
                           1, warmup=0 if big else 1),
                 residual_bound(M, K, N, r))
        rows[f"M={M} K={K} N={N}"] = dict(r_, launches=n)
        kernel_ms += n * r_["device_ms"]
    return {"shapes": rows, "kernel_device_ms": kernel_ms}


def prefill_logits_on_card() -> dict:
    """Phase 17 (b): train.make_prefill_logits at full width under the dry
    run's QuantConfig (design2, residual_xla, rank 16) on qwen3-1.7b at
    1 of 28 layers, whisper-small whole (16 encoder frames a request) and
    internvl2-76b at 1 of 80 layers (its 256-row prefix through
    frontend_proj), B = 2 x 64 tokens: each run timed with its launches
    counted (held to the path's) and its peak memory read, the logits'
    shape (B, min(128, prefix + S), V) and finite; a second run equal to
    it.  qwen3's logits are held to the same call on the CPU, its plain
    versions fed the card's products (FedCardProducts: every launch's
    operands equal to the card's and its plain version on the CPU held
    to the card's product), within PREFILL_CPU_REL of max |logit|: run
    free, the CPU's residual sums an ulp off the card's move a dynamic
    quantization scale, and this random-weight model amplifies the
    flipped steps (PERF.md).  Every launch of the other two is held
    against its plain version (CpuShadow; those of more than
    MOE_CARD_GATHERS gathers on the card)."""
    import torch
    from repro_torch.kernels import check, ops
    from repro_torch.quant import QuantConfig
    from repro_torch.train import make_prefill_logits
    q = QuantConfig(design="design2", backend="residual_xla", rank=16)
    rows, total = {}, 0
    for i, (arch, layers) in enumerate(PREFILL_RUNS):
        cfg, tag = depth_cut(arch, layers)
        params_cpu = None
        if arch == "qwen3-1.7b":
            params_cpu, params = _card_params(cfg, 170 + i)
        else:
            from repro_torch.models import transformer as T
            params = T.init_params(
                torch.Generator(device="cuda").manual_seed(170 + i), cfg,
                device="cuda")
        batch = _prefill_batch(cfg, 171 + i, "cuda")
        fn = make_prefill_logits(cfg, q)
        fn(params, batch)                         # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want = dict.fromkeys(ops.LAUNCHES, 0)
        want["residual_matmul"] = prefill_logits_launches(cfg)
        with PlainGuard():
            ops.reset_launches()
            t0 = time.perf_counter()
            logits = fn(params, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = _launched("prefill_logits", tag, want)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prefix = cfg.n_prefix if cfg.family == "vlm" else 0
        shape = (PREFILL_B, min(128, prefix + PREFILL_S), cfg.vocab)
        assert tuple(logits.shape) == shape, (tag, tuple(logits.shape))
        assert bool(torch.isfinite(logits).all()), tag
        total += counts["residual_matmul"]
        row_ = {"launches": counts["residual_matmul"], "ms": ms,
                "peak_gib": peak, "logits": list(shape)}
        t0 = time.perf_counter()
        if params_cpu is None:
            with check.CpuShadow(("residual_matmul",),
                                 card_gathers=MOE_CARD_GATHERS) as sh, \
                    LaunchShapes() as seen:
                again = fn(params, batch)
            _shadow_log(f"prefill_logits {tag}", sh, t0)
            st = sh.stats["residual_matmul"]
            assert st["calls"] == want["residual_matmul"], (tag, st)
        else:
            with RecordCardProducts() as rec, LaunchShapes() as seen:
                again = fn(params, batch)
            with FedCardProducts(rec.calls) as fed:
                cpu = fn(params_cpu, _prefill_batch(cfg, 171 + i, "cpu"))
            assert fed.n == len(rec.calls) == want["residual_matmul"]
            gap = float((again.cpu() - cpu).abs().max())
            scale = float(cpu.abs().max())
            log(f"[prefill_logits] {tag}: {fed.n} launches' operands equal "
                f"to the CPU's, each held against its plain version on "
                f"the CPU (max {fed.max_rel:.3e} of max |out|); the CPU "
                f"run on the card's products {time.perf_counter() - t0:.1f}"
                f"s: max |logit gap| {gap:.3e} of max |logit| {scale:.3e} "
                f"(held to {PREFILL_CPU_REL} of it)")
            assert gap <= PREFILL_CPU_REL * scale, (tag, gap, scale)
            row_["cpu_gap_rel"] = gap / scale
        assert torch.equal(again, logits), f"{tag}: two runs differ"
        assert sum(n for _, n in seen.shapes.values()) \
            == counts["residual_matmul"], tag
        timed = time_prefill_shapes(tag, seen.shapes)
        row_.update(timed)
        log(f"[prefill_logits] {tag}: the call {ms:.3f} ms by the host "
            f"clock, its {counts['residual_matmul']} residual_matmul "
            f"launches {timed['kernel_device_ms']:.3f} ms of device time "
            f"(launches x device_ms of their shapes), peak device memory "
            f"{peak:.3f} GiB, logits {list(shape)}")
        rows[arch] = row_
        del params, params_cpu, logits, again, seen
        torch.cuda.empty_cache()
    log("[prefill_logits] " + json.dumps({"prefill_logits": rows}))
    return {"launches": total, **rows}


def multi_device(smi: str) -> dict:
    """Phase 17: (a) the dry run of both production meshes, (b) the
    cache-free prefill on the card; (c) is phase 6's first run, which
    passes --mesh host.  Returns (b)'s rows and launches."""
    t0 = time.perf_counter()
    dry = dryrun_meshes(smi)
    t1 = time.perf_counter()
    rows = prefill_logits_on_card()
    t2 = time.perf_counter()
    log("[multi-device] phase 17 seconds: " + json.dumps(
        {"a": round(t1 - t0, 1), "b": round(t2 - t1, 1),
         "all": round(t2 - t0, 1)}) + " " + json.dumps({"dryrun": dry}))
    return rows


# ---------------------------------------------------------------------------
# phase 18: QAT training of the other families
# ---------------------------------------------------------------------------

# (arch, layers; None: the whole depth), every width as published, --batch
# 4 --seq 128 (TB x TS), remat on.  A float32 AdamW step holds four copies
# of the params (params, grads, two moments), so the depth is cut where
# they and the activations would not fit the card: mixtral about 23 GB a
# layer and 2.1 GB of embedding; scout about 35 GB a layer and 16.5 GB of
# embedding (2 layers would be about 87 GB); internvl2 about 31 GB at one
# layer; recurrentgemma at 3 of its 9 pattern units, as phase 14, and
# gemma and minitron at one layer, for the script's time.
# nemotron-4-340b does not train on one card: one layer with its state is
# about 55 GB and its embedding with its state about 76 GB (minitron-8b
# trains the same relu2 MLP).
TRAIN_FAMILY_RUNS = (("mixtral-8x7b", 2), ("llama4-scout-17b-a16e", 1),
                     ("recurrentgemma-2b", 9), ("xlstm-125m", None),
                     ("gemma-7b", 1), ("minitron-8b", 1),
                     ("whisper-small", None), ("internvl2-76b", 1))
TRAIN_FAMILY_BACKENDS = (("xla", "asym_u8"), ("residual", "sym_i8"))
TRAIN_KERNEL = {"xla": "lut_matmul", "residual": "residual_matmul"}
# phase 18's parity: one pattern unit of each family (whisper: one
# encoder and one decoder layer; internvl2's train step is phase 15 (d)'s)
TRAIN_PARITY_UNITS = ("mixtral-8x7b", "llama4-scout-17b-a16e",
                      "recurrentgemma-2b", "xlstm-125m", "whisper-small",
                      "gemma-7b", "minitron-8b")


def family_train_shapes(cfg, batch=TB, seq=TS):
    """The projection launches of one remat QAT step of ``cfg`` on
    ``batch`` x ``seq`` tokens, one (name, M, K, N) a launch: every
    decoder projection twice (the forward and its recompute in the
    backward pass), an MoE expert at M = its capacity; whisper's encoder
    (M = batch x enc_seq frames) and the VLM's prefix projection (M =
    batch x n_prefix) once, outside remat, as in the reference; the cross
    block's k/v over the encoder's rows, its q/o over the tokens', the
    VLM's decoder over prefix and tokens."""
    from repro_torch.models.moe import capacity
    D, H, Kv, hd, F, R, E = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                             cfg.d_ff, cfg.d_rnn, cfg.n_experts)
    T = batch * seq
    M = batch * (cfg.n_prefix + seq) if cfg.family == "vlm" else T
    glu = cfg.mlp_kind in ("geglu", "swiglu")
    attn = [("wq", D, H * hd), ("wk", D, Kv * hd), ("wv", D, Kv * hd),
            ("wo", H * hd, D)]
    mlp = ([("w_gate", D, F), ("w_up", D, F)] if glu
           else [("w_up", D, F)]) + [("w_down", F, D)]
    layer = []
    for kind in cfg.pattern:
        if kind == "attn":
            layer += [(n, M, K, N) for n, K, N in attn + (mlp if F else [])]
        elif kind == "rec":
            layer += [(n, M, K, N) for n, K, N in
                      [("rec w_in", D, R), ("rec w_gate_x", D, R),
                       ("rec w_gate_a", D, R), ("rec w_out", R, D)]
                      + (mlp if F else [])]
        elif kind == "mlstm":
            layer += [(f"mlstm {n}", M, D, D) for n in
                      ("wq", "wk", "wv", "wo")]
            layer += [(f"mlstm {n}", M, D, H) for n in ("wi", "wf")]
        elif kind == "slstm":
            layer += [(f"slstm {n}", M, D, D) for n in
                      ("wz", "wi", "wf", "wo_gate", "wo")]
        elif kind == "moe":
            C = capacity(T, cfg.top_k, E)
            layer += [(n, M, K, N) for n, K, N in attn]
            layer += [("router", M, D, E)]
            layer += [(f"expert {n}", C, K, N) for _ in range(E)
                      for n, K, N in mlp]
            if cfg.shared_expert_ff:
                Fs = cfg.shared_expert_ff
                layer += [("shared w_gate", M, D, Fs), ("shared w_up", M, D,
                                                         Fs),
                          ("shared w_down", M, Fs, D)]
    if cfg.family == "encdec":
        M_enc = batch * cfg.enc_seq
        layer += [("cross wq", M, D, H * hd), ("cross wk", M_enc, D,
                                                Kv * hd),
                  ("cross wv", M_enc, D, Kv * hd), ("cross wo", M, H * hd, D)]
    calls = layer * cfg.n_units * 2
    if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
        rows = batch * (cfg.n_prefix if cfg.family == "vlm"
                        else cfg.enc_seq)
        calls += [("frontend_proj", rows, cfg.frontend_dim, D)]
    if cfg.family == "encdec":
        M_enc = batch * cfg.enc_seq
        calls += [(f"enc {n}", M_enc, K, N) for n, K, N in attn + mlp] \
            * cfg.enc_layers
    return calls


def family_train_per_model(cfg, batch=TB, seq=TS) -> int:
    """lut_matmul (xla) or residual_matmul (residual) launches of one QAT
    step of the whole (depth-cut) model: one a projection call of
    family_train_shapes."""
    return len(family_train_shapes(cfg, batch, seq))


def train_family_shapes():
    """The distinct (M, K, N) of phase 18's runs, each with the configs
    and projections that launch it: [((M, K, N), [(arch, name), ...])]."""
    out = {}
    for arch, layers in TRAIN_FAMILY_RUNS:
        cfg, _ = depth_cut(arch, layers)
        for name, M, K, N in family_train_shapes(cfg):
            who = out.setdefault((M, K, N), [])
            if (arch, name) not in who:
                who.append((arch, name))
    return sorted(out.items())


def _family_batch(cfg, step, rng, batch=TB, seq=TS):
    """launch.train's batch at ``step`` (data.host_batch) on the card, and
    for the encdec and vlm families the stub frontend's float32 frames
    (whisper: enc_seq of them a request) or prefix patches (internvl2:
    n_prefix), drawn standard-normal from ``rng`` as make_smoke_batch
    draws them."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, host_batch
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    b = dict(host_batch(dcfg, step))
    rows = {"encdec": cfg.enc_seq, "vlm": cfg.n_prefix}.get(cfg.family)
    if rows:
        b["frontend"] = rng.normal(size=(
            batch, rows, cfg.frontend_dim or cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}


def _train_direct(cfg, backend, mode):
    """launch.train's loop for the families whose batch needs the frontend
    (both packages' train CLIs raise KeyError: 'frontend' for them):
    TF32 off, the launcher's params (generator seed 0 on the card),
    optimizer config and tokens, TSTEPS remat steps of
    train.make_train_step, the frontend drawn by _family_batch.  Returns
    a launch.train.TrainResult."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    q = QuantConfig(design="design2", backend=backend, mode=mode)
    ocfg = OptConfig(lr=3e-4, warmup_steps=max(TSTEPS // 20, 5),
                     total_steps=TSTEPS)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda")
    opt = opt_mod.init(params, ocfg)
    step_fn = make_train_step(cfg, q, ocfg, remat=True)
    rng = np.random.default_rng(18)
    res = train.TrainResult([], [], [], 0, 0, params, opt)
    for step in range(TSTEPS):
        batch = _family_batch(cfg, step, rng)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        res.losses.append(float(metrics["loss"]))     # waits for the card
        res.step_s.append(time.perf_counter() - t0)
        res.grad_norms.append(float(metrics["grad_norm"]))
    res.peak_bytes = torch.cuda.max_memory_allocated()
    res.params, res.opt_state = params, opt
    return res


def train_families(smi: str):
    """Phase 18 (a): each config of TRAIN_FAMILY_RUNS trains TSTEPS steps
    at full width and its depth cut, --batch 4 --seq 128, remat on, in
    each of TRAIN_FAMILY_BACKENDS: the MoE, recurrent and dense configs
    through launch.train's run(args, cfg=...), whisper and internvl2
    through train.make_train_step (_train_direct).  Each run's launch
    counts are read just after it and held to the path's
    (family_train_per_model), its losses and grad norms finite.  Returns
    {arch: {kernel: launches}}."""
    import math
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    log("[train families] nemotron-4-340b is not trained: one layer with "
        "its float32 AdamW state is about 55 GB and its embedding with its "
        "state about 76 GB of this card's 80 GB (minitron-8b trains the "
        "same relu2 MLP)")
    launches, rows = {}, {}
    for arch, layers in TRAIN_FAMILY_RUNS:
        cfg, name = depth_cut(arch, layers)
        per_step = family_train_per_model(cfg)
        launches[arch] = {"lut_matmul": 0, "residual_matmul": 0}
        for backend, mode in TRAIN_FAMILY_BACKENDS:
            kernel = TRAIN_KERNEL[backend]
            tag = f"{name} {backend} {mode}"
            want = dict.fromkeys(ops.LAUNCHES, 0)
            want[kernel] = per_step * TSTEPS
            t0 = time.perf_counter()
            with PlainGuard():
                ops.reset_launches()
                if cfg.family in ("encdec", "vlm"):
                    r = _train_direct(cfg, backend, mode)
                else:
                    r = train.run(train.parse_args(
                        ["--arch", arch, "--batch", str(TB), "--seq",
                         str(TS), "--steps", str(TSTEPS), "--backend",
                         backend, "--quant-mode", mode, "--log-every",
                         str(TSTEPS)]), cfg=cfg)
                counts = _launched("train families", tag, want)
            launches[arch][kernel] += counts[kernel]
            assert len(r.losses) == TSTEPS, tag
            assert all(math.isfinite(x) for x in r.losses + r.grad_norms), \
                tag
            ms = [t * 1e3 for t in r.step_s]
            rows[tag] = {"layers": cfg.n_layers, "losses": r.losses,
                         "grad_norms": r.grad_norms, "ms_per_step": ms,
                         "peak_gib": r.peak_bytes / 2**30,
                         f"{kernel}_per_step": per_step,
                         "seconds": time.perf_counter() - t0}
            log(f"[train families] {tag}: losses {r.losses}, grad norms "
                f"{r.grad_norms}; ms per step {ms}; peak device memory "
                f"{r.peak_bytes / 2**30:.3f} GiB ({smi}); {per_step} "
                f"{kernel} launches a step; "
                f"{time.perf_counter() - t0:.1f}s")
            del r
            torch.cuda.empty_cache()
    log("[train families] " + json.dumps({"train_families": rows}))
    return launches


class RematCheck:
    """While active, each launch of the training kernel ``name`` is paired
    with the earlier launch on an equal weight operand (the layer's
    forward launch that its remat recompute repeats), and the entries of
    the quantized activations that differ between the two are counted
    (``flips``).  Unpaired launches (those that run once, outside remat)
    stay in ``unpaired``."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved = ops, getattr(ops, self.name)
        self.unpaired, self.pairs, self.flips, self.entries = [], 0, 0, 0

        def call(a, b, *args, **kw):
            for i, (fa, fb) in enumerate(self.unpaired):
                if fa.shape == a.shape and fb.shape == b.shape \
                        and bool((fb == b).all()):
                    self.flips += int((fa != a).sum())
                    self.entries += a.numel()
                    self.pairs += 1
                    del self.unpaired[i]
                    break
            else:
                self.unpaired.append((a, b))
            return self.saved(a, b, *args, **kw)
        setattr(ops, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.saved)


def parity_train_step(cfg, tag, batch, card_gathers):
    """One 'xla' asym_u8 remat train step of ``cfg`` on the card (seeded
    params) with every lut_matmul launch held against its plain version
    (CpuShadow: on the card above ``card_gathers`` gathers, on the CPU
    below) and each weight's recompute launch held to its forward launch
    (RematCheck: 0 flipped entries); the launch count the path's.
    Returns (the step's metrics, CpuShadow's lut_matmul stats)."""
    import math
    import torch
    from repro_torch.kernels import check
    from repro_torch.models import transformer as T
    from repro_torch.quant import QuantConfig
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import optimizer as opt_mod
    B_, S_ = batch["tokens"].shape
    calls = family_train_shapes(cfg, B_, S_)
    once = sum(n == "frontend_proj" or n.startswith("enc ")
               for n, *_ in calls)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(19),
                           cfg, device="cuda")
    ocfg = OptConfig(warmup_steps=5, total_steps=100)
    step = make_train_step(cfg, QuantConfig(design="design2", backend="xla",
                                            mode="asym_u8"), ocfg,
                           remat=True)
    t0 = time.perf_counter()
    with check.CpuShadow(("lut_matmul",), card_gathers=card_gathers) as sh, \
            RematCheck("lut_matmul") as rc:
        _, _, m = step(params, opt_mod.init(params, ocfg), batch)
        torch.cuda.synchronize()
    _shadow_log(tag, sh, t0)
    st = sh.stats["lut_matmul"]
    assert st["calls"] == len(calls), (tag, st["calls"], len(calls))
    log(f"[parity] {tag}: {rc.pairs} forward launches recomputed under "
        f"remat, {rc.flips} of {rc.entries} quantized activation entries "
        f"of the recompute unequal to the forward's; {len(rc.unpaired)} "
        f"launches outside remat; loss {float(m['loss'])!r}, grad norm "
        f"{float(m['grad_norm'])!r}")
    assert rc.pairs == (len(calls) - once) // 2 and \
        len(rc.unpaired) == once, (tag, rc.pairs, len(rc.unpaired))
    assert rc.flips == 0, f"{tag}: the remat recompute flipped {rc.flips}"
    assert math.isfinite(float(m["loss"])) and math.isfinite(
        float(m["grad_norm"])), tag
    return m, st


def train_families_parity():
    """Phase 18 (b): one pattern unit of each family of TRAIN_PARITY_UNITS
    at full width, one remat train step ('xla', asym_u8) at --batch 4
    --seq 128 (whisper's enc_seq frames a request) through
    parity_train_step: every lut_matmul launch held against its plain
    version, every recompute equal to its forward."""
    import numpy as np
    import torch
    from repro_torch import configs
    torch.set_num_threads(os.cpu_count() or 1)
    for arch in TRAIN_PARITY_UNITS:
        base = configs.get(arch)
        cfg = dataclasses.replace(base, n_layers=len(base.pattern))
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, enc_layers=1)
        tag = (f"{arch} train step (one unit, {cfg.n_layers} layer(s)"
               + (", 1 encoder layer" if cfg.enc_layers else "") + ")")
        batch = _family_batch(cfg, 0, np.random.default_rng(20))
        parity_train_step(cfg, tag, batch, PARITY_CARD_GATHERS)
        del batch
        torch.cuda.empty_cache()


def check_train_family_kernels(dev, errs):
    """Phase 3 at phase 18's distinct projection shapes (full width):
    lut_matmul asym_u8 (as the 'xla' backend passes it: offset 0) and
    residual_matmul sym_i8 (rank RANK, offset 128), each once, against its
    plain version on the card, two launches bit-equal.  Folds the max
    errors into ``errs``; returns {(kernel, M, K, N): (plain ms, max
    |err|)}, the plain call's ms (CUDA events around the one call) for
    phase 8's rows."""
    import torch
    from repro_torch.kernels import check, ops, ref
    held = {}

    def timed(fn):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        return out, s.elapsed_time(e)

    for i, ((M, K, N), who) in enumerate(train_family_shapes()):
        c = check.lut_case(M, K, N, False, 2200 + i, dev, shifted=False,
                           device_draw=True)
        want, plain_ms = timed(lambda: check.lut_plain(c))
        got = check._launches("lut_matmul", lambda: ops.lut_matmul(**c))
        assert torch.equal(got, want), ("lut_matmul", M, K, N)
        assert torch.equal(ops.lut_matmul(**c), got), "not repeatable"
        held[("lut_matmul", M, K, N)] = (plain_ms, 0.0)
        del c, want, got
        c = check.residual_case(M, K, N, True, RANK, 2300 + i, dev,
                                device_draw=True)
        want, plain_ms = timed(
            lambda: ref.residual_corrected_matmul_ref(**c))
        got = check._launches("residual_matmul",
                              lambda: ops.residual_matmul(**c))
        err = check._resid_err(got, want)
        assert torch.equal(ops.residual_matmul(**c), got), "not repeatable"
        errs["residual_matmul"] = max(errs["residual_matmul"],
                                      err["max_abs_err"])
        held[("residual_matmul", M, K, N)] = (plain_ms, err["max_abs_err"])
        log(f"[kernels] training M={M} K={K} N={N} ({who}): lut_matmul "
            f"asym_u8 bit-exact, residual_matmul sym_i8 r={RANK} max |err| "
            f"{err['max_abs_err']:.3e} ({err['max_rel_err']:.3e} of max "
            f"|out|); two launches of each bit-equal")
        del c, want, got
        torch.cuda.empty_cache()
    log(f"[kernels] phase 18's shapes: {len(held)} cases held against "
        f"their plain versions")
    return held


def time_train_family_kernels(dev, held):
    """Phase 8 at phase 18's distinct projection shapes: lut_matmul
    asym_u8 and residual_matmul sym_i8, each shape timed once (its plain
    version's ms and max |err| from phase 3, ``held``), the row listed
    under every config that launches the shape.  Returns {kernel: {arch:
    {shape: row}}}."""
    import torch
    from repro_torch.kernels import check, ops
    rows = {"lut_matmul": {}, "residual_matmul": {}}
    for i, ((M, K, N), who) in enumerate(train_family_shapes()):
        big = M * K * N > (1 << 33)
        shape = f"M={M} K={K} N={N}"
        names = ", ".join(f"{a} {n}" for a, n in who)
        c = check.lut_case(M, K, N, False, 2200 + i, dev, shifted=False,
                           device_draw=True)
        plain, err = held[("lut_matmul", M, K, N)]
        lut = row("lut_matmul", f"{shape} asym_u8 (train: {names})",
                  lambda: ops.lut_matmul(**c), 3 if big else 20, plain,
                  lut_bound(M, K, N), gathers=M * K * N, b=c["b"],
                  offset=c["offset"])
        del c
        c = check.residual_case(M, K, N, True, RANK, 2300 + i, dev,
                                device_draw=True)
        plain, rerr = held[("residual_matmul", M, K, N)]
        res = row("residual_matmul", f"{shape} sym_i8 r={RANK} (train: "
                  f"{names})", lambda: ops.residual_matmul(**c),
                  3 if big else 20, plain, residual_bound(M, K, N, RANK))
        del c
        for arch, _ in who:
            rows["lut_matmul"].setdefault(arch, {})[shape] = dict(
                lut, max_abs_err=err)
            rows["residual_matmul"].setdefault(arch, {})[shape] = dict(
                res, max_abs_err=rerr)
        torch.cuda.empty_cache()
    return rows


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
        t0 = time.perf_counter()
        errs = check_kernels(cfg, dev)
        t1 = time.perf_counter()
        check_train_kernels(cfg, dev, errs)
        t2 = time.perf_counter()
        check_moe_kernels(dev, errs)
        t3 = time.perf_counter()
        check_family_kernels(dev, errs)
        t4 = time.perf_counter()
        check_encdec_vlm_kernels(dev, errs)
        t5 = time.perf_counter()
        held = check_train_family_kernels(dev, errs)
        log(f"[kernels] phase 3 seconds: serving path {t1 - t0:.1f}, "
            f"training {t2 - t1:.1f}, MoE {t3 - t2:.1f}, other families "
            f"{t4 - t3:.1f}, encoder-decoder and VLM {t5 - t4:.1f}, "
            f"phase 18's training shapes {time.perf_counter() - t5:.1f}")
        phase("4. full-width serve (main path)")
        launches, table = serve_full_width(cfg)
        phase(f"5. slice parity: card vs CPU at {PARITY_LAYERS} layer(s) of "
              f"full width")
        slice_parity(cfg)
        parity_initial(cfg)
    # training needs autograd: outside the no_grad block
    phase("6. full-width QAT training")
    launches.update(train_full_width(cfg))
    phase(f"7. train parity: card vs CPU at {PARITY_LAYERS} layer(s) of full "
          f"width")
    train_parity(cfg)
    with torch.no_grad():
        phase("8. timing")
        summary, plan_qat, serve_rows = time_kernels(cfg, dev)
        moe_rows = time_moe_kernels(dev)
        t0 = time.perf_counter()
        fam_rows = time_family_kernels(dev)
        t1 = time.perf_counter()
        ev_rows = time_encdec_vlm_kernels(dev)
        t2 = time.perf_counter()
        tf_rows = time_train_family_kernels(dev, held)
        log(f"[timing] the other families' rows: {t1 - t0:.1f}s; the "
            f"encoder-decoder and VLM rows: {t2 - t1:.1f}s; phase 18's "
            f"training rows: {time.perf_counter() - t2:.1f}s")
        phase("9. trace of the decode step")
        trace_decode(cfg)
        phase("10. per-layer design plans at full width")
        plan_launches, qat_launches = plans_full_width(cfg)
        phase("11. plan parity: card vs CPU at 2 layers of full width")
        plan_parity_two_layers(cfg)
        phase("12. serve options at full width")
        rows = {}
        opt_launches, unembed_launches = serve_options_on_tree(
            cfg, table, rows)
        more, apart = serve_options_runs(cfg, rows)
        log("[options] " + json.dumps({"options": rows}))
        serve_options_parity(cfg)
        phase("13. the MoE family at full width")
        moe_launches = moe_full_width()
        moe_parity_one_layer()
        phase("14. the remaining decoder families at full width")
        fam_launches = families_full_width()
        families_parity_one_unit()
        phase("15. encoder-decoder and VLM at full width")
        ev_launches, ev_serve = {}, {}
        ev_launches["whisper-small"], table = whisper_full_width(ev_serve)
        long_enc = whisper_long_encoder(table, ev_serve)
        for k in long_enc:
            ev_launches["whisper-small"][k] += long_enc[k]
        ev_launches["internvl2-76b"] = vlm_full_width(ev_serve)
        log("[encdec/vlm] " + json.dumps({"encdec_vlm": ev_serve}))
        encdec_vlm_parity_one_unit()
    # the training example needs autograd: outside the no_grad block
    phase("16. applications: sharpening, edge detection, the tables and "
          "the examples")
    applications(smi)
    phase("17. multi-device on one card: the dry run and the cache-free "
          "prefill")
    prefill_rows = multi_device(smi)
    launches["residual_matmul_prefill_logits"] = prefill_rows["launches"]
    phase("18. QAT training of the other families at full width")
    t0 = time.perf_counter()
    tf_launches = train_families(smi)
    t1 = time.perf_counter()
    train_families_parity()
    log(f"[train families] phase 18 seconds: runs {t1 - t0:.1f}, parity "
        f"{time.perf_counter() - t1:.1f}")
    # the plan runs' launches join the paths' counts, but for the planned
    # QAT steps' delta_matmul launches (M = TB*TS), which stand apart
    # beside their own timing row
    launches["delta_matmul_plan_qat"] = qat_launches
    for k, v in plan_launches.items():
        launches[k] += v
    # phase 12's runs join them too, but for the launches at shapes of
    # their own (the product kernels of --backend xla / residual / delta
    # at the merged projections and the unembed's delta_matmul), which
    # stand apart beside their rows
    for k in opt_launches:
        launches[k] += opt_launches[k] + more[k]
    for k, v in apart.items():
        launches[f"{k}_serve"] = v
    launches["delta_matmul_unembed"] = unembed_launches
    kernels = kernels_json(summary, plan_qat, serve_rows, moe_rows, launches,
                           moe_launches, errs, fam_rows, fam_launches,
                           ev_rows, ev_launches, prefill_rows, tf_rows,
                           tf_launches)
    log(f"\n[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
