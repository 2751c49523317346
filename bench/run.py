"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Without a CUDA card, or with fewer cards
than the cell asks for, it exits with code 3 and prints no result.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit (also the last lines of
standard error).
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.prepare_env()
    wl = harness.Workload(args.workload)

    import torch
    chips = wl.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    out = wl.kind().run(wl, args.seed, args.seconds, bool(args.trace),
                        T_PROC)
    rec, checks = out["record"], out["checks"]
    units = {m["name"]: m["unit"] for m in
             wl.bench["end_to_end"] + wl.bench["per_layer"]}
    metrics = {}
    if args.trace:
        for m in wl.per_layer:
            value = wl.metric_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wl.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(rec.peak_bytes)}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tr = rec.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops_by_time(),
                               "idle_gaps": tr.idle_by_host_range()}
    result["checks"] = checks

    bad = harness.forbidden_loaded()
    if bad:
        print(f"[bench] modules of JAX or of the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 4
    print(json.dumps({k: v for k, v in result.items() if k != "checks"}
                     | {"e2e_all": out["e2e"]}, default=float),
          file=sys.stderr)
    print(harness.checks_text(checks), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
