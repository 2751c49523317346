"""End-to-end rates are over the whole window and tails over every
sample; the traced run gives every per-layer metric it can read."""
import pytest

from bench import harness

from _smoke import SMOKE_TRAFFIC, run_cell


def test_rates_over_the_whole_window():
    wl, out = run_cell("minitron-8b.eval-prompt", seconds=0.5, trace=True)
    rec = out["record"]
    B, P, G = (SMOKE_TRAFFIC["static_rounds"][k]
               for k in ("batch", "prompt_len", "gen_len"))
    n = len(rec.rounds)
    assert n >= 2
    assert rec.window_s >= 0.5
    assert rec.window_s >= rec.rounds[-1].times[-1] - rec.rounds[0].t_start
    assert out["e2e"]["serve_tok_s"] == pytest.approx(
        n * B * (P + G) / rec.window_s)
    gaps = [b - a for r in rec.rounds for a, b in zip(r.times, r.times[1:])]
    assert len(gaps) == n * (G - 1)
    assert out["e2e"]["itl_ms_p95"] == pytest.approx(
        harness.percentile(gaps * B, 95) * 1e3)
    assert out["attempted"] == n * B and out["failed"] == 0
    assert out["e2e"]["setup_s"] > 0
    # the per-layer readers: host spans read on the CPU, device ones not
    got = {m["name"]: wl.metric_reader(m["name"]).read(rec)
           for m in wl.per_layer}
    assert got["prefill_ms"] > 0 and got["decode_step_ms"] > 0
    assert got["device_idle_pct.serve"] is None
    assert got["proj_roofline.serve"] is None
