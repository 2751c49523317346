"""Time the decode_attention wrappers on the card, at the serve path's
shape and at long context, for any checkout of the port.

    python src/repro_torch/launch/time_attention.py [--src DIR]

The kernels timed are those of DIR (default: the ``src`` directory this
file lies in), so one copy of this script times another checkout's
kernels (an earlier commit unpacked with ``git archive``) beside this
one's, in turns within one run on one card; the timer
(``check.cuda_time``) is always this checkout's.  The shapes are
qwen3-1.7b's (B=4, H=16, Kv=8, hd=128): every slot at position 72 of an
80-position cache (mid-decode of the serve path) and at 4095 of 4096
(67 MB of caches, beyond the 50 MB L2), the position one 0-dim int32
tensor as the serve path passes it.  Each wrapper is timed twice:
``ms``, back-to-back calls, and ``device_ms``, the same calls queued
behind a spin on the card (null where the wrapper makes the host wait
for the card, so that no call can be queued).
``decode_attention_step`` leaves the caches as they are;
``decode_attention`` is the layer's call, which appends the new rows (to
copies of the caches here).  Prints one JSON line per (wrapper, shape),
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = ((80, 72, 200), (4096, 4095, 50))   # (S_max, pos, calls timed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=SRC)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 2
    from repro_torch.kernels.check import cuda_time
    if os.path.abspath(args.src) != SRC:     # the other checkout's port
        for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[m]
        sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import configs
    from repro_torch.kernels import check, ops
    cfg = configs.get("qwen3-1.7b")
    B, H, Kv, hd = 4, cfg.n_heads, cfg.n_kv, cfg.hd
    print(f"[time_attention] port from {ops.__file__}", flush=True)
    with torch.no_grad():
        for S, pos, iters in SHAPES:
            c = check.attention_case(B, S, H, Kv, hd, 7, "cuda",
                                     pos=[pos] * B)
            # one position for every slot, a 0-dim tensor, as the serve
            # path's uniform decode passes it
            c["pos"] = c["pos"][0].clone()
            kc, vc = c["k_cache"].clone(), c["v_cache"].clone()
            calls = {
                "decode_attention_step": lambda: ops.decode_attention_step(
                    **c),
                "decode_attention": lambda: ops.decode_attention(
                    c["q"][:, None], c["k_new"][:, None],
                    c["v_new"][:, None], kc, vc, c["pos"], n_heads=H,
                    n_kv=Kv, head_dim=hd, rope_theta=c["theta"],
                    q_gain=c["q_gain"], k_gain=c["k_gain"])}
            for name, fn in calls.items():
                row = {"wrapper": name, "B": B, "H": H, "Kv": Kv, "hd": hd,
                       "S": S, "pos": pos, "ms": cuda_time(fn, iters)}
                try:
                    row["device_ms"] = cuda_time(fn, iters, queued=True)
                except AssertionError as e:   # the wrapper waits for the card
                    row["device_ms"], row["note"] = None, str(e)
                print(json.dumps(row), flush=True)
            del c, kc, vc
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
