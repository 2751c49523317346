"""The port's tracer (``repro_torch.trace``) at the benchmark's CPU smoke
sizes (``bench/tests/_smoke.py``), one thread.

  * Off, a serve round and a train step record no span and touch neither
    the profiler's ranges nor CUDA events nor a synchronise.
  * Under a CPU ``torch.profiler.profile`` they record the spans the
    benchmark's readers look up, nested as the readers read them (remat's
    recompute opens ``model.layer`` again inside ``train.backward``), each
    with the kernel launches issued inside it.
  * ``bench/spans.py`` puts the spans on the profiler's timebase: it
    recovers a known offset, refuses spans that fit no range, and fits a
    real profiler window; it splits a step's device idle between the
    program and its caller.
  * The span readers on a traced CPU run: nothing to read but the host's
    issue time of a decode step.
  * The launchers' ``--trace-out`` writes a Chrome trace.
"""
import collections
import contextlib
import json
import sys
import threading
import types
from pathlib import Path

import pytest
import torch
from threadpoolctl import threadpool_limits
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness, inputs  # noqa: E402
from bench import spans as bspans  # noqa: E402
from bench.tests import _smoke  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402

SEED = 2 ** 31 + 12345
SERVE, TRAIN = "minitron-8b.eval-prompt", "minitron-8b.qat-train"
# the metrics that read the program's spans
SPAN_METRICS = ["decode_issue_ms", "idle_program_ms.serve",
                "idle_caller_ms.serve", "proj_ms.serve", "attn_ms",
                "head_ms", "idle_program_ms.train", "idle_caller_ms.train",
                "proj_ms.train", "recompute_ms", "optimizer_ms"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.fixture(scope="module")
def serve_cell():
    wl = _smoke.smoke_workload(SERVE)
    kind = wl.kind()
    return wl, kind, kind.Program(wl.config["model"], wl.config["quant"],
                                  SEED, "cpu")


@pytest.fixture(scope="module")
def train_cell():
    wl = _smoke.smoke_workload(TRAIN)
    kind = wl.kind()
    return wl, kind, kind.Program(wl.config["model"], wl.config["quant"],
                                  wl.traffic, SEED, "cpu")


def serve_round(cell, traced=False):
    wl, kind, prog = cell
    t = wl.traffic
    prompts = inputs.round_prompts(prog.model, SEED, 1, t["batch"],
                                   t["prompt_len"])[0]
    return kind.one_round(prog, prompts, t["gen_len"], traced=traced)


def train_step(cell, traced=False):
    wl, kind, prog = cell
    t = wl.traffic
    (tokens, labels), = kind.batches(wl.config["model"], SEED, 1,
                                     t["batch"], t["seq"])
    with (record_function("bench.train_step") if traced
          else contextlib.nullcontext()):
        float(prog.step(tokens, labels))


def names_above(span):
    out = []
    while span.parent is not None:
        span = span.parent
        out.append(span.name)
    return out


def test_off_records_nothing(serve_cell, train_cell, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("called while tracing is off")
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(trace, "Span", boom)
    assert trace.span("a") is trace.span("b")
    serve_round(serve_cell)
    train_step(train_cell)
    assert trace.spans() == []


def test_profiled_spans_nest_and_count_launches(serve_cell, train_cell,
                                                monkeypatch):
    """The plain versions count a launch as their kernels do on the card;
    each span's launches equal ops.LAUNCHES's growth over it."""
    for fn, kernel in (("fused_qdot_ref", "fused_qdot"),
                       ("approx_matmul_ref", "lut_matmul"),
                       ("decode_attention_step_ref", "decode_attention")):
        def counted(*args, _plain=getattr(ops.ref, fn), _kernel=kernel,
                    **kwargs):
            ops._launched(_kernel)
            return _plain(*args, **kwargs)
        monkeypatch.setattr(ops.ref, fn, counted)
    seen = {}

    def total():
        return sum(ops.LAUNCHES.values())

    def enter(self, _enter=trace.Span.__enter__):
        seen[id(self)] = [total()]
        return _enter(self)

    def leave(self, *exc, _exit=trace.Span.__exit__):
        out = _exit(self, *exc)
        seen[id(self)].append(total())
        return out
    monkeypatch.setattr(trace.Span, "__enter__", enter)
    monkeypatch.setattr(trace.Span, "__exit__", leave)

    with profile(activities=[ProfilerActivity.CPU]):
        serve_round(serve_cell)
        train_step(train_cell)
    recs = trace.spans()
    G = serve_cell[0].traffic["gen_len"]
    n_layers = _smoke.SMOKE["n_layers"]
    count = collections.Counter(s.name for s in recs)
    assert count["serve.prefill"] == 1 and count["serve.step"] == G - 1
    for s in recs:
        assert s.end_ns >= s.start_ns
        assert s.device_start_ns is None          # no CUDA here
        before, after = seen[id(s)]
        assert s.launches == after - before, s.name
    steps = [s for s in recs if s.name == "serve.step"]
    assert all(s.launches == 4 * n_layers + n_layers for s in steps)
    for name in ("model.attn_core", "quant.qdot", "model.head"):
        inside = [s for s in recs if s.name == name
                  and "serve.step" in names_above(s)]
        assert inside, name
    for name in ("train.backward", "train.optimizer"):
        (s,) = [s for s in recs if s.name == name]
        assert names_above(s) == ["train.step"]
    layers = [s for s in recs if s.name == "model.layer"]
    again = [s for s in layers if "train.backward" in names_above(s)]
    assert len(layers) == 2 * n_layers and len(again) == n_layers
    for s in again:
        qdots = [c for c in recs if c.parent is s and c.name == "quant.qdot"]
        assert len(qdots) == 6 and s.launches == 6


def test_launches_credit_the_innermost_span_of_their_thread():
    trace.enable()
    before = ops.LAUNCHES["fused_qdot"]
    with trace.span("outer") as outer:
        ops._launched("fused_qdot")
        with trace.span("inner") as inner:
            ops._launched("fused_qdot")
            ops._launched("fused_qdot")

            def elsewhere():
                with trace.span("other"):
                    ops._launched("fused_qdot")
            worker = threading.Thread(target=elsewhere)
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
    trace.enable(False)
    ops._launched("fused_qdot")
    assert ops.LAUNCHES["fused_qdot"] - before == 5
    (other,) = [s for s in trace.spans() if s.name == "other"]
    assert (outer.launches, inner.launches, other.launches) == (3, 2, 1)
    assert inner.parent is outer and other.parent is None
    assert other.thread != outer.thread


def fake_span(name, start_us, end_us):
    return types.SimpleNamespace(
        name=name, start_ns=start_us * 1e3, end_ns=end_us * 1e3,
        device_start_ns=None, device_end_ns=None, parent=None, thread=1,
        launches=0)


def test_fit_recovers_a_known_offset(monkeypatch):
    off = 123456.25
    ranges = [("decode_step", 1000.0 * i + 5, 1000.0 * i + 600)
              for i in range(1, 4)]
    late = [2.5, 0.0, 7.0]        # how long after its range a span opens
    fake = [fake_span("serve.step", a - off + d, a - off + d + 400)
            for (_, a, _), d in zip(ranges, late)]
    rec = types.SimpleNamespace(trace=harness.Trace([], ranges, 0.0, 1e4))
    monkeypatch.setattr(bspans, "program_spans", lambda: fake)
    got = bspans.mapped(rec)
    assert [s.start for s in got] == pytest.approx(
        [a + d for (_, a, _), d in zip(ranges, late)])
    assert bspans.fit([((s.start_ns / 1e3, s.end_ns / 1e3), (a, b))
                       for s, (_, a, b) in zip(fake, ranges)]) == \
        pytest.approx(off)
    # a span longer than its range fits no offset; nor do unequal counts
    fake[1].end_ns += 300e3
    assert bspans.mapped(rec) is None
    monkeypatch.setattr(bspans, "program_spans", lambda: fake[:2])
    assert bspans.mapped(rec) is None


def test_idle_split_puts_each_gap_with_the_step_it_begins_in(monkeypatch):
    """Two decode steps on a synthetic timeline (µs, the fit's offset 0):
    idle while a step's span is open on the host or unfinished on the
    device is the program's, the rest the caller's."""
    ranges = [("decode_step", 0.0, 100.0), ("decode_step", 110.0, 200.0)]
    ops_ = [("k", 10.0, 30.0), ("k", 35.0, 80.0), ("Memcpy", 90.0, 95.0),
            ("k", 125.0, 190.0)]
    fake = [fake_span("serve.step", 0.0, 20.0),
            fake_span("serve.step", 110.0, 120.0)]
    fake[0].device_start_ns, fake[0].device_end_ns = 5e3, 82e3
    fake[1].device_start_ns, fake[1].device_end_ns = 115e3, 191e3
    monkeypatch.setattr(bspans, "program_spans", lambda: fake)
    rec = types.SimpleNamespace(
        trace=harness.Trace(ops_, ranges + [("window", 0.0, 200.0)], 0.0,
                            200.0))
    # program: 0-10, 30-35, 80-82, 110-125, 190-191; caller: 82-90,
    # 95-110 (a gap of the first step's), 191-200
    split = bspans.idle_split(rec)
    assert split["program"] == pytest.approx(33.0 / 2 / 1e3)
    assert split["caller"] == pytest.approx(32.0 / 2 / 1e3)
    ((label, idle_s),) = rec.trace.idle_by_host_range()
    assert label == "decode_step"
    assert idle_s == pytest.approx((33.0 + 32.0) / 1e6)


def test_span_readers_on_a_traced_cpu_run(serve_cell, train_cell):
    wl, kind, prog = serve_cell
    rec = kind.serve_window(prog, wl.traffic, SEED, 0.0, True)
    assert bspans.mapped(rec) is not None
    got = {m: wl.metric_reader(m).read(rec) for m in SPAN_METRICS
           if m in {p["name"] for p in wl.per_layer}}
    assert got.pop("decode_issue_ms") > 0
    assert len(got) == 5 and set(got.values()) == {None}

    trace.reset()
    wl, kind, prog = train_cell
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            train_step(train_cell, traced=True)
    rec = kind.Record(wl.config["model"], wl.traffic, 0.0,
                      trace=harness.Trace.from_profiler(prof), trace_steps=1)
    assert bspans.mapped(rec) is not None
    got = {m: wl.metric_reader(m).read(rec) for m in SPAN_METRICS
           if m in {p["name"] for p in wl.per_layer}}
    assert len(got) == 5 and set(got.values()) == {None}


def test_trace_out_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "serve.json"
    serve.main(["--smoke", "--requests", "2", "--prompt-len", "3",
                "--gen-len", "3", "--calibrate", "1", "--device", "cpu",
                "--trace-out", str(out)])
    events = json.loads(out.read_text())["traceEvents"]
    rows = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert rows == {"host", "device"}
    names = collections.Counter(e["name"] for e in events if e["ph"] == "X")
    assert names["serve.prefill"] >= 1 and names["serve.step"] >= 2
    assert names["quant.qdot"] > 0 and names["model.head"] > 0
    assert not trace._enabled

    out = tmp_path / "train.json"
    train.main(["--smoke", "--device", "cpu", "--steps", "1", "--seq", "8",
                "--batch", "2", "--trace-out", str(out)])
    spans = [e for e in json.loads(out.read_text())["traceEvents"]
             if e["ph"] == "X"]
    by_index = {e["args"]["index"]: e for e in spans}
    opt = next(e for e in spans if e["name"] == "train.optimizer")
    assert by_index[opt["args"]["parent"]]["name"] == "train.step"
