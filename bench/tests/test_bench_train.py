"""The QAT cell at smoke size: rates over the whole window, the
reference following the program's first steps, the program's faults
and the control coming out not correct."""
import pytest
import torch

from bench import harness

from _smoke import run_cell, smoke_workload

CELL = "minitron-8b.qat-train"
SMOKE_LIMITS = {"loss": 1e-5, "grad": 1e-3, "change": 1e-3,
                "embed_rows": 1e-3, "grad_span": 1e-4}


def test_rates_and_agreement():
    wl, out = run_cell(CELL, seconds=0.5, trace=True)
    rec = out["record"]
    B, S = wl.traffic["batch"], wl.traffic["seq"]
    assert rec.steps >= 2 and rec.window_s >= 0.5
    assert out["e2e"]["train_tok_s"] == pytest.approx(
        rec.steps * B * S / rec.window_s)
    assert out["attempted"] == rec.steps
    assert all(c["value"] < 1e-5 for c in out["checks"].values())
    assert set(out["checks"]) >= {"embed_rows", "grad_span"}
    got = {m["name"]: wl.metric_reader(m["name"]).read(rec)
           for m in wl.per_layer}
    assert got["proj_roofline.train"] is None       # no device trace here


def _state_unchanged(step_fn):
    def bad(params, state, batch):
        from repro_torch.train.optimizer import tree_map
        copy = (tree_map(torch.clone, params),
                type(state)(*(tree_map(torch.clone, s) if s is not None
                              else None for s in state)))
        _, _, metrics = step_fn(*copy, batch)
        return params, state, metrics
    return bad


def _half_batch(step_fn):
    def bad(params, state, batch):
        half = {k: v[: len(v) // 2] for k, v in batch.items()}
        return step_fn(params, state, half)
    return bad


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_fault_is_caught(monkeypatch, fault):
    kind = harness.Workload(CELL).kind()
    orig = kind.Program.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.step_fn = fault(self.step_fn)

    monkeypatch.setattr(kind.Program, "__init__", init)
    _, out = run_cell(CELL, limits=SMOKE_LIMITS, kind=kind)
    print(fault.__name__, out["checks"])
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_control_and_planted_faults_fail_the_limits():
    torch.set_num_threads(1)
    wl = smoke_workload(CELL)
    out = wl.kind().control(wl, 77, torch.device("cpu"))
    print(out)
    assert all(out["program"][k] <= lim for k, lim in SMOKE_LIMITS.items())
    for name in ("int4", "half_batch"):
        assert any(out[name][k] > lim for k, lim in SMOKE_LIMITS.items())
    # half of the batch left out: the rows of its tokens lose their lookup
    assert out["half_batch"]["embed_rows"] > 0.3


def test_grad_span_reads_the_products_precision():
    """A gradient X^T dY lies in the row space of X, which the embedding's
    rows fix: in float32 up to rounding, with X rounded to TF32 (10 bits
    of mantissa) before the product, a thousandth out."""
    from bench.reference import train as ref_train
    g = torch.Generator().manual_seed(3)
    params = {"embed": torch.randn(50, 96, generator=g),
              "units.0.norm1": torch.ones(2, 96)}
    tokens = torch.randint(0, 50, (2, 16), generator=g)
    basis = ref_train.span_basis(params, tokens)
    x = params["embed"][tokens.reshape(-1)]
    x = x * torch.rsqrt((x * x).mean(1, keepdim=True) + 1e-6)
    dy = torch.randn(32, 80, generator=g)
    assert ref_train.span_share(x.T @ dy, basis) < 1e-6
    tf32 = (x.view(torch.int32) + 0x1000 & ~0x1FFF).view(torch.float32)
    assert ref_train.span_share(tf32.T @ dy, basis) > 1e-4
