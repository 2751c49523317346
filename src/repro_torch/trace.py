"""Spans of the port's steps, on the host's clock and on the device's.

``span(name)`` marks a layer boundary (``with trace.span("quant.qdot"):``).
While tracing is off it costs one flag test and returns a shared object
that does nothing: no profiler range, no CUDA event, no synchronise, no
allocation.  Tracing is on while a torch profiler records, so that a
profiler window gets the spans of the steps it covers, and after
``enable()``, for an operator's run (``recording``: the launchers'
``--trace-out``).

An open span records its name, the span around it on its own thread, the
thread, host start and end (``time.perf_counter_ns``), the port's kernel
launches issued inside it (``launched``, called by ``kernels.ops``; a
span's count includes its children's on the same thread) and, when the
process has initialised CUDA, a pair of timing events on the thread's
current stream (two event records: a span costs a kernel launch or two
of host time while tracing).  Autograd runs the backward of CUDA tensors, and with it a
non-reentrant checkpoint's recompute, on a thread of its own; spans
opened there start a stack of their own.

Records stay in this module's memory and never enter the profiler's
event list, so what a profiler reads of the device is the same with spans
as without.  ``spans()`` returns them, after putting the device times on
the host's clock: the first span after ``reset()`` synchronises once and
records an anchor event beside a ``perf_counter_ns`` reading, and each
event's time is the anchor's plus the elapsed time between the two
(float32 milliseconds: about a microsecond of resolution for 15 s after
the anchor).  One device.  ``to_chrome(path)`` writes the records as a
Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler

_enabled = False            # enable(): on outside a profiler window too
_records: List["Span"] = []
_local = threading.local()  # .stack: the open spans of a thread
_anchor = None              # (event, host ns), taken by the first span
_streams = {}               # thread -> the stream its events go on


class Span:
    """One span; its fields are read once it has closed.  Times are in
    nanoseconds on ``time.perf_counter_ns``'s clock; ``device_start_ns``
    and ``device_end_ns`` stay None without CUDA, until ``spans()``
    resolves them."""
    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns",
                 "launches", "device_start_ns", "device_end_ns", "_events")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = self.device_start_ns = self.device_end_ns = None
        self.launches = 0
        self._events = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        self.start_ns = time.perf_counter_ns()
        if torch.cuda.is_initialized():
            self._events = (_recorded(self.thread), None)
        stack.append(self)
        _records.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events = (self._events[0], _recorded(self.thread))
        self.end_ns = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].launches += self.launches
        return False


class _Off:
    """What ``span`` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records the block as one span while tracing
    is on, and does nothing otherwise."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name)


def launched() -> None:
    """Credit one kernel launch to the innermost open span of this
    thread."""
    if _enabled or _profiler._is_profiler_enabled:
        stack = getattr(_local, "stack", None)
        if stack:
            stack[-1].launches += 1


def enable(on: bool = True) -> None:
    """Trace outside a profiler window too (``on``), or stop doing so."""
    global _enabled
    _enabled = on


def reset() -> None:
    """Drop every record and the anchor; the next span takes a new one."""
    global _anchor
    _records.clear()
    _streams.clear()
    _anchor = None


def spans() -> List[Span]:
    """Every span recorded since ``reset()``, in the order they opened,
    their device times resolved (this waits for the device)."""
    pending = [s for s in _records
               if s._events is not None and s._events[1] is not None]
    if pending:
        torch.cuda.synchronize()
        event, host_ns = _anchor
        for s in pending:
            start, end = s._events
            s.device_start_ns = host_ns + round(
                event.elapsed_time(start) * 1e6)
            s.device_end_ns = host_ns + round(event.elapsed_time(end) * 1e6)
            s._events = None
    return list(_records)


def to_chrome(path: str) -> None:
    """Write the closed spans as Chrome-trace JSON (chrome://tracing,
    Perfetto): one row of host spans, one of device spans, microseconds
    from the first span's start; each event's args give the launches,
    the thread and the parent's index."""
    recs = [s for s in spans() if s.end_ns is not None]
    index = {id(s): i for i, s in enumerate(recs)}
    t0 = min((s.start_ns for s in recs), default=0)
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": row}}
              for pid, row in ((1, "host"), (2, "device"))]
    for i, s in enumerate(recs):
        args = {"index": i, "launches": s.launches, "thread": s.thread,
                "parent": index.get(id(s.parent))}
        rows = [(1, s.start_ns, s.end_ns)]
        if s.device_start_ns is not None:
            rows.append((2, s.device_start_ns, s.device_end_ns))
        for pid, a, b in rows:
            events.append({"name": s.name, "ph": "X", "pid": pid, "tid": 0,
                           "ts": (a - t0) / 1e3, "dur": (b - a) / 1e3,
                           "args": args})
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)


@contextlib.contextmanager
def recording(path: Optional[str]):
    """Trace the block, an operator's run, from a clean slate, and write
    its spans to ``path`` with ``to_chrome`` when it ends; without a
    path, leave tracing as it is."""
    if path is None:
        yield
        return
    reset()
    enable()
    try:
        yield
    finally:
        enable(False)
        to_chrome(path)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _recorded(thread: int):
    """A timing event recorded now on ``thread``'s stream.  The stream is
    the one current on the thread at its first span since ``reset()``
    (the port runs on one stream), looked up once: asking torch for the
    current stream costs twice what recording the event does."""
    stream = _streams.get(thread)
    if stream is None:
        if _anchor is None:
            _take_anchor()
        stream = _streams[thread] = torch.cuda.current_stream()
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


def _take_anchor() -> None:
    global _anchor
    torch.cuda.synchronize()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    _anchor = (event, time.perf_counter_ns())

