"""The correctness check's control, and for a train cell its planted
faults: the program's readings and theirs, seed by seed, in one process.

    python bench/control.py --workload <cell> --seeds 1 2 3 [--tf32]

For each seed the cell's set-up and a short stretch at its own load,
then the check's numbers for the program and, put in its place, for the
control: the reference with every operand at 4-bit precision (the
precision below the configuration's int8 products); with ``--tf32``
also the TF32 control (the precision below its float32: a serving
cell's head, a train cell's every float32 product).  A train cell also
reads half of the batch left out (the mean over the rest), planted in
the reference put in the program's place.  Prints one JSON line a seed.  The limits in ``bench/limits/``
are set from these readings and the runs' own (PERF.md gives them).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tf32", action="store_true",
                    help="also read the TF32 control")
    args = ap.parse_args(argv)
    harness.prepare_env()
    import torch
    wl = harness.Workload(args.workload)
    kind = wl.kind()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(dict(seed=seed, **kind.control(wl, seed, dev,
                                                        args.tf32))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
