"""On the card: a program span's device interval (``repro_torch.trace``'s
CUDA events), put on the profiler's timebase by ``bench/spans.py``'s
clock fit, brackets the profiler's interval of the kernels launched
inside it, to within 50 µs at either end.  Run from the root of the
checkout with ``python -m pytest -s -m gpu bench/tests/test_bench_spans_gpu.py``
(``-s`` prints the errors measured)."""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench import harness, spans
from repro_torch import trace
from repro_torch.kernels import check, ops

TOL_US = 50.0
STEPS = 20
# about 1 ms of device time before each span: the host runs ahead, so the
# span's events queue right beside its kernels
SPIN_CYCLES = 2_000_000
KERNELS = ("quantize_rows", "tile_kernel<")


@pytest.mark.gpu
def test_span_device_interval_brackets_its_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    case = check.fused_case(8, 4096, 4096, False, 21, dev, compensate=True)
    ops.fused_qdot_packed(**case)              # build and warm
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for _ in range(STEPS):
                with record_function("bench.train_step"):
                    with trace.span("train.step"):
                        torch.cuda._sleep(SPIN_CYCLES)
                        with trace.span("quant.qdot"):
                            ops.fused_qdot_packed(**case)
                    torch.cuda.synchronize()
    rec = types.SimpleNamespace(trace=harness.Trace.from_profiler(prof))
    mapped = spans.mapped(rec)
    trace.reset()
    assert mapped is not None
    qdots = [s for s in mapped if s.name == "quant.qdot"]
    launched = sorted((s, e) for n, s, e in rec.trace.device_ops
                      if any(k in n for k in KERNELS))
    assert len(qdots) == STEPS and len(launched) == 2 * STEPS
    early, late = [], []
    for i, span in enumerate(qdots):
        (k0, _), (_, k1) = launched[2 * i], launched[2 * i + 1]
        early.append(k0 - span.dev_start)     # > 0: the kernel starts inside
        late.append(span.dev_end - k1)        # > 0: it ends inside
    print(f"\n[spans] kernel start after the span's device start (us): "
          f"{min(early):.2f} to {max(early):.2f}; kernel end before the "
          f"span's device end: {min(late):.2f} to {max(late):.2f}")
    assert all(-TOL_US <= d <= TOL_US for d in early + late)
