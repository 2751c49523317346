"""The cells at the CPU smoke sizes the port's configs use (the port's
own SMOKE widths, 2 layers), with small rounds and steps."""
import torch

from bench import harness

SMOKE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 2,
         "vocab": 512}
SMOKE_TRAFFIC = {"static_rounds": {"batch": 3, "prompt_len": 8, "gen_len": 5,
                                   "trace_rounds": 1},
                 "qat_steps": {"batch": 2, "seq": 16, "trace_steps": 1}}
CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


def smoke_model(model):
    return dict(model, **SMOKE, head_dim=None, d_ff=256)


def smoke_workload(name, limits=None):
    """The cell with its model and traffic at smoke size."""
    wl = harness.Workload(name)
    wl.config = dict(wl.config, model=smoke_model(wl.config["model"]))
    wl.traffic = dict(wl.traffic, **SMOKE_TRAFFIC[wl.traffic["kind"]])
    if limits is not None:
        wl.limits = limits
    return wl


def run_cell(name, seed=123456789012, seconds=0.3, trace=False,
             limits=None, kind=None):
    """One run of a cell on the CPU at smoke size, one thread (so that the
    plain kernels' float sums run in one order)."""
    torch.set_num_threads(1)
    wl = smoke_workload(name, limits)
    kind = kind or wl.kind()
    return wl, kind.run(wl, seed, seconds, trace, harness.now(),
                        device="cpu", model=wl.config["model"],
                        traffic=wl.traffic)
