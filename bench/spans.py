"""The program's own spans (``repro_torch.trace``) on the profiler's
timebase, for the metrics that read them.

While a torch profiler records, the port keeps spans of its steps in its
own memory: host start and end on ``time.perf_counter_ns`` and, on the
card, device start and end from CUDA events put on the same clock.  The
profiler counts from its own start.  Each program step span
(``serve.prefill``, ``serve.step``, ``train.step``) runs inside one of the
harness's ranges (``prefill``, ``decode_step``, ``train_step``), one for
one and in order; the offset between the two clocks is the smallest one
that puts every step span's start inside its range.  Where the counts
differ, or a step span does not fit its range at that offset, or the
program has no tracer, nothing is read (None).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

from bench import harness

STEPS = (("serve.prefill", "prefill"), ("serve.step", "decode_step"),
         ("train.step", "train_step"))


class Mapped(NamedTuple):
    """A program span in microseconds on the profiler's timebase
    (``dev_start``/``dev_end`` None without CUDA); ``parent`` is an index
    into the same list, or None."""
    name: str
    start: float
    end: float
    dev_start: Optional[float]
    dev_end: Optional[float]
    parent: Optional[int]

    @property
    def device_us(self) -> Optional[float]:
        if self.dev_start is None:
            return None
        return self.dev_end - self.dev_start


def program_spans() -> list:
    """The tracer's closed spans, or [] for a program that has none."""
    try:
        from repro_torch import trace
    except ImportError:
        return []
    return [s for s in trace.spans() if s.end_ns is not None]


def fit(pairs) -> Optional[float]:
    """``pairs``: ((start, end) of a span, (start, end) of its range) on
    two clocks.  The smallest offset that puts every span's start inside
    its range, or None if no offset does or a span then ends outside."""
    if not pairs:
        return None
    off = max(a - s for (s, _), (a, _) in pairs)
    if all(e + off <= b for (_, e), (_, b) in pairs):
        return off
    return None


def mapped(rec) -> Optional[List[Mapped]]:
    """The program's spans of the traced window on ``rec.trace``'s
    timebase, or None."""
    tr = getattr(rec, "trace", None)
    if tr is None:
        return None
    recs = program_spans()
    pairs = []
    for prog, label in STEPS:
        mine = sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in recs
                      if s.name == prog)
        theirs = sorted((a, b) for n, a, b in tr.host_ranges if n == label)
        if len(mine) != len(theirs):
            return None
        pairs += zip(mine, theirs)
    off = fit(pairs)
    if off is None:
        return None
    index = {id(s): i for i, s in enumerate(recs)}

    def dev(ns):
        return None if ns is None else ns / 1e3 + off
    return [Mapped(s.name, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off,
                   dev(s.device_start_ns), dev(s.device_end_ns),
                   index.get(id(s.parent)))
            for s in recs]


def per_unit(rec) -> int:
    """The traced rounds of a serving cell, or the traced steps of a
    training cell."""
    return getattr(rec, "trace_rounds", 0) or getattr(rec, "trace_steps", 0)


def device_ms(rec, name: str, keep=None) -> Optional[float]:
    """Device time of the spans called ``name`` (those ``keep(span,
    spans)`` accepts) per traced round or step, in ms; None without CUDA
    or without such spans."""
    spans = mapped(rec)
    units = per_unit(rec)
    if not spans or not units:
        return None
    picked = [s for s in spans
              if s.name == name and (keep is None or keep(s, spans))]
    if not picked or any(s.device_us is None for s in picked):
        return None
    return sum(s.device_us for s in picked) / units / 1e3


def outermost(span: Mapped, spans: List[Mapped]) -> bool:
    """No span of the same name encloses it."""
    p = span.parent
    while p is not None:
        if spans[p].name == span.name:
            return False
        p = spans[p].parent
    return True


def _intersect(a, b):
    """Intersections of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_split(rec) -> Optional[dict]:
    """The device's idle time in the harness's steps (``decode_step`` in a
    serving cell, else ``train_step``), split by whether the program had
    the step in hand: ``program``, idle while the host was inside a
    program span or the device had not yet passed the end of one (the
    device waits on the launch chain, or between the kernels it
    queued); ``caller``, the rest (the tokens' or the loss's round trip
    and the caller's loop), each in ms per step.  A span's device
    interval counts beside its host one because the host leaves a step
    long before the device does and then waits for the tokens outside
    any span, while the device still runs, and pauses between, the
    kernels the step queued.  A gap counts whole for the step it begins
    in, as ``Trace.idle_by_host_range`` counts it, so the two parts add
    up to that breakdown's idle of the step."""
    spans = mapped(rec)
    tr = rec.trace if spans else None
    if not spans or not tr.device_ops:
        return None
    labels = {n for n, _, _ in tr.host_ranges}
    label = "decode_step" if "decode_step" in labels else "train_step"
    ranges = [(a, b) for n, a, b in tr.host_ranges if n == label]
    if not ranges:
        return None
    gaps = harness.idle_gaps([(s, e) for _, s, e in tr.device_ops],
                             tr.start_us, tr.end_us)
    idle = [(s, e) for s, e in gaps if any(a <= s < b for a, b in ranges)]
    held = _merged([(s.start, s.end) for s in spans]
                   + [(s.dev_start, s.dev_end) for s in spans
                      if s.dev_start is not None])
    program = sum(e - s for s, e in _intersect(idle, held))
    total = sum(e - s for s, e in idle)
    return {"program": program / len(ranges) / 1e3,
            "caller": (total - program) / len(ranges) / 1e3}
