"""The control (the reference at 4-bit operand precision in the
program's place) comes out not correct.  At the cells' size it is run on
the card by ``bench/control.py`` (PERF.md gives its readings); here at
smoke size against the smoke limits of the fault tests."""
import torch

from _smoke import smoke_workload
from test_bench_faults import SMOKE_LIMITS


def test_int4_control_fails_the_limits():
    torch.set_num_threads(1)
    wl = smoke_workload("minitron-8b.eval-prompt")
    out = wl.kind().control(wl, 123456789012, torch.device("cpu"))
    print(out)
    assert all(out["program"][k] <= lim for k, lim in SMOKE_LIMITS.items())
    assert any(out["int4"][k] > lim for k, lim in SMOKE_LIMITS.items())
