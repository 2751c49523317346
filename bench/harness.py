"""What every cell shares: the workload's files found by name, the
environment, the result line, the trace's reduction and the check that
nothing of JAX was loaded.

A cell (an entry of BENCHMARK.json's ``workloads``) names a
configuration (``configs[].file``, a JSON of sizes) and a traffic mix
(``bench/traffic/<traffic>.json``, whose ``kind`` names the driver
``bench/traffic/kinds/<kind>.py``).  Its correctness limits are
``bench/limits/<cell>.json``.  Each per-layer metric is read by
``bench/metrics/<metric>.py``, or where there is no such file by the
reader its names share up to the first dot (``device_idle_pct.py`` for
``device_idle_pct.serve`` and ``.train``): a ``read(run)`` that returns
a number or None (nothing to read).
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def prepare_env() -> None:
    """Caches inside the checkout, at fixed paths, before torch loads; no
    library may load JAX on its own."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Workload:
    """A cell of BENCHMARK.json with its configuration, traffic, limits
    and the metrics it reports."""

    def __init__(self, name: str, bench: Optional[Dict] = None):
        self.bench = bench or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the cells are "
                             f"{sorted(cells)}")
        self.cell = cells[name]
        self.name = name
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = confs[self.cell["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(BENCH / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moves)]

    def kind(self):
        kind = self.traffic["kind"]
        return load_module(BENCH / "traffic" / "kinds" / f"{kind}.py",
                           f"bench_kind_{kind}")

    def metric_reader(self, name: str):
        path = BENCH / "metrics" / f"{name}.py"
        if not path.exists():
            name = name.split(".")[0]
            path = BENCH / "metrics" / f"{name}.py"
        return load_module(path, "bench_metric_" + name.replace(".", "_"))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) of every sample, by linear
    interpolation between the closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    spans = sorted(intervals)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s


def idle_gaps(intervals, start: float, end: float):
    """The gaps of [start, end] that no interval covers, as (s, e)."""
    gaps, at = [], start
    for s0, e0 in sorted(intervals):
        if s0 > at:
            gaps.append((at, min(s0, end)))
        at = max(at, e0)
        if at >= end:
            break
    if at < end:
        gaps.append((at, end))
    return [(s, e) for s, e in gaps if e > s]


class Trace:
    """A profiler window reduced to what the metrics read: device
    operations (name, start_us, end_us), the harness's labelled host
    ranges (record_function names starting with ``bench.``) and the
    window's bounds in the same timebase."""

    def __init__(self, device_ops, host_ranges, start_us, end_us):
        self.device_ops = device_ops
        self.host_ranges = host_ranges
        self.start_us, self.end_us = start_us, end_us

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith("bench."):   # a range's device mirror
                    continue
                dev.append((e.name, float(tr.start), float(tr.end)))
            elif e.name.startswith("bench."):
                host.append((e.name[len("bench."):], float(tr.start),
                             float(tr.end)))
        win = [r for r in host if r[0] == "window"]
        if not win:
            raise RuntimeError("the traced window has no bench.window range")
        return cls(dev, host, win[0][1], win[0][2])

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device_ops
                             if e > self.start_us and s < self.end_us]) / 1e6

    @staticmethod
    def is_kernel(name: str) -> bool:
        return not name.startswith(("Memcpy", "Memset"))

    def kernels_in(self, label: str):
        """Device kernels that start inside the host ranges named
        ``label`` (a range that ends in a device sync owns the kernels
        its host code launched)."""
        ranges = [(s, e) for n, s, e in self.host_ranges if n == label]
        out = []
        for name, s, e in self.device_ops:
            if self.is_kernel(name) and any(a <= s <= b for a, b in ranges):
                out.append((name, s, e))
        return out

    def device_ops_by_time(self, top: int = 10):
        by: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_by_host_range(self, top: int = 10):
        """Idle device time of the window, by the innermost harness range
        the host was in when each gap began."""
        gaps = idle_gaps([(s, e) for _, s, e in self.device_ops],
                         self.start_us, self.end_us)
        ranges = sorted(self.host_ranges, key=lambda r: r[2] - r[1])
        by: Dict[str, float] = {}
        for s, e in gaps:
            label = next((n for n, a, b in ranges if a <= s < b), "other")
            by[label] = by.get(label, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda kv: -kv[1])[:top]


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def checks_text(checks: Dict[str, Dict[str, float]]) -> str:
    return "\n".join(f"check {n}: {c['value']!r} limit {c['limit']!r}"
                     for n, c in checks.items())


def now() -> float:
    return time.perf_counter()
