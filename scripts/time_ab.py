"""Two A/B timings on one card, each variant in one process.

1. fused_qdot's compensation row sum, float64 against float32.  The
   kernel's pre-pass (``quantize_rows`` in csrc/fused_qdot.cu) sums
   rowsum(mu_r[qx + off]) in float64 and rounds once to float32, as the
   plain version (``ref.fused_qdot_ref``) does.  The script builds a
   second library from the same source with that sum in float32 (the
   pre-pass's earlier form, every other line the same) and times both
   through the same wrapper, ``ops.fused_qdot_packed``, at qwen3-1.7b's
   four merged serve projections, M = 4 (decode) and 256 (prefill),
   asym_u8 and sym_i8, compensation on.  The two launches differ only in
   the pre-pass, so their gap is the pre-pass's cost.
2. decode_attention's split for the G = 16 instantiation (query groups
   of 9-16), which fits 2 blocks an SM (__launch_bounds__(128, 2)): the
   wrapper's split, ops.attention_chunks, planned at
   ops.ATTN_BLOCKS_PER_SM = 3 blocks an SM (two waves at many pairs),
   against the same split planned at 2 (one wave), at nemotron-4-340b's
   96/8 hd 192, recurrentgemma-2b's 10/1 hd 256 under its window of
   2048 and a group of 16 at hd 256, B = 4, every slot at position 4095
   of 4096 and at the serve path's 72 of 80.

Each case runs A, B, B, A (device time: check.cuda_time queued behind a
spin), and each variant's output is held against the plain version
(max |err|).

    python3 scripts/time_ab.py

Needs a CUDA card and nvcc; writes build/prepass_f32/ beside the
kernels' build.  Prints one JSON line per case, a summary line, the
card's name and power limit, and {"ok": true}.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the float64 pre-pass's lines and their float32 forms
TO_F32 = [
    ("__shared__ double wrc[kQThreads / 32];",
     "__shared__ float wrc[kQThreads / 32];"),
    ("double rc = 0.0;", "float rc = 0.f;"),
    ("if (COMP) rc = __dadd_rn(rc, (double)MU[q + off]);",
     "if (COMP) rc = __fadd_rn(rc, MU[q + off]);"),
    ("if (COMP) rc = __dadd_rn(rc, __shfl_xor_sync(0xffffffffu, rc, o));",
     "if (COMP) rc = __fadd_rn(rc, __shfl_xor_sync(0xffffffffu, rc, o));"),
    ("double c = 0.0;", "float c = 0.f;"),
    ("if (COMP) c = __dadd_rn(c, wrc[w]);",
     "if (COMP) c = __fadd_rn(c, wrc[w]);"),
    ("rcomp[m] = __double2float_rn(c);", "rcomp[m] = c;"),
]


def build_f32(_build):
    """The float32 pre-pass's library: the source with TO_F32 applied,
    compiled with the kernels' flags; returns its bound launch function."""
    src = (_build.CSRC / "fused_qdot.cu").read_text()
    for old, new in TO_F32:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_qdot.cu: expected once: {old}")
        src = src.replace(old, new)
    out = os.path.join(ROOT, "build", "prepass_f32")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "fused_qdot.cu"), os.path.join(out, "f32.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", so, cu], check=True,
                   stdout=subprocess.DEVNULL)
    sym, argtypes = _build.SIGNATURES["fused_qdot"]
    fn = getattr(ctypes.CDLL(so), sym)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def prepass_rows(dev, f64, f32):
    """Part 1: {shape, mode, f64/f32 device ms and max |err|} per case."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build, check, ops
    cfg = configs.get("qwen3-1.7b")
    D, H, Kv, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    merged = [("wqkv", D, (H + 2 * Kv) * hd), ("wo", H * hd, D),
              ("w_gateup", D, 2 * F), ("w_down", F, D)]
    rows = []
    for signed in (False, True):
        for i, (name, K, N) in enumerate(merged):
            for M, iters in ((4, 200), (256, 20)):
                c = check.fused_case(M, K, N, signed, 100 + i, dev)
                want = check.fused_plain(c)
                times, err = {"f64": [], "f32": []}, {}
                for tag in ("f64", "f32", "f32", "f64"):
                    _build._FUNCS["fused_qdot"] = f64 if tag == "f64" \
                        else f32
                    got = ops.fused_qdot_packed(**c)
                    err[tag] = float((got - want).abs().max())
                    times[tag].append(check.cuda_time(
                        lambda: ops.fused_qdot_packed(**c), iters,
                        queued=True))
                _build._FUNCS["fused_qdot"] = f64
                r = {"part": "prepass", "shape": f"{name} M={M} K={K} N={N}",
                     "mode": "sym_i8" if signed else "asym_u8",
                     "f64_device_ms": sum(times["f64"]) / 2,
                     "f32_device_ms": sum(times["f32"]) / 2,
                     "f64_runs": times["f64"], "f32_runs": times["f32"],
                     "f64_max_abs_err": err["f64"],
                     "f32_max_abs_err": err["f32"]}
                r["f64_minus_f32_ms"] = r["f64_device_ms"] - \
                    r["f32_device_ms"]
                rows.append(r)
                print(json.dumps(r), flush=True)
                del c, want
    torch.cuda.empty_cache()
    return rows


def planned_at(per_sm: int):
    """ops.attention_chunks with ``per_sm`` in place of
    ATTN_BLOCKS_PER_SM."""
    from repro_torch.kernels import ops

    def chunks(S_max, B, Kv, sms=ops.ATTN_SMS):
        n = max(1, min(ops.ATTN_MAX_CHUNKS, S_max // ops.ATTN_MIN_ROWS,
                       per_sm * sms // (B * Kv)))
        rows = -(-S_max // n)
        return -(-S_max // rows), rows
    return chunks


def split_rows(dev):
    """Part 2: {case, chunks, device ms and max |err|} with the split
    planned at 2 and at 3 blocks an SM."""
    import torch
    from repro_torch.kernels import check, ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = 4
    cases = [("nemotron-4-340b", 96, 8, 192, None),
             ("recurrentgemma-2b", 10, 1, 256, 2048),
             ("group 16", 16, 1, 256, None)]
    rows = []
    keep = ops.attention_chunks
    assert planned_at(ops.ATTN_BLOCKS_PER_SM)(4096, 4, 8, 132) == \
        keep(4096, 4, 8, 132)
    for tag, H, Kv, hd, w in cases:
        for S, pos, iters in ((80, 72, 200), (4096, 4095, 50)):
            c = check.attention_case(B, S, H, Kv, hd, 1700 + S, dev,
                                     qk_norm=False, window=w, pos=[pos] * B)
            times, err, split = {2: [], 3: []}, {}, {}
            for per_sm in (2, 3, 3, 2):
                ops.attention_chunks = planned_at(per_sm)
                split[per_sm] = ops.attention_chunks(S, B, Kv, sms)
                err[per_sm] = check.check_attention(c)["max_abs_err"]
                times[per_sm].append(check.cuda_time(
                    lambda: ops.decode_attention_step(**c), iters,
                    queued=True))
            ops.attention_chunks = keep
            r = {"part": "split", "case": f"{tag} B={B} H={H} Kv={Kv} "
                 f"hd={hd} S={S} pos={pos} window={w}"}
            for per_sm in (2, 3):
                chunks, n_rows = split[per_sm]
                r[f"per_sm_{per_sm}"] = {
                    "chunks": chunks, "rows": n_rows,
                    "blocks": chunks * B * Kv,
                    "device_ms": sum(times[per_sm]) / 2,
                    "runs": times[per_sm], "max_abs_err": err[per_sm]}
            rows.append(r)
            print(json.dumps(r), flush=True)
            del c
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    f64 = _build.kernel("fused_qdot")
    f32 = build_f32(_build)
    with torch.no_grad():
        pre = prepass_rows(dev, f64, f32)
        split_rows(dev)
    dec = [r for r in pre if " M=4 " in r["shape"]]
    print(json.dumps({"prepass_decode_layer_ms": {
        mode: {v: sum(r[f"{v}_device_ms"] for r in dec if r["mode"] == mode)
               for v in ("f64", "f32")} for mode in ("asym_u8", "sym_i8")}}))
    print(smi)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
