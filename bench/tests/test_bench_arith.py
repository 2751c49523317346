"""The yardstick's arithmetic against hand counts on tiny shapes."""
import pytest

from bench import arith, harness

TINY = {"family": "dense", "n_layers": 1, "d_model": 4, "n_heads": 2,
        "n_kv": 1, "d_ff": 8, "vocab": 16, "mlp_kind": "relu2"}


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert harness.union_length(spans) == 4
    assert harness.idle_gaps(spans, 0, 8) == [(3, 5), (6, 8)]
    assert harness.union_length([]) == 0


def test_percentile_counts_every_sample():
    v = [1.0] * 19 + [100.0]
    # 20 samples: rank 18.05 lies between the 19th and 20th
    assert harness.percentile(v, 95) == pytest.approx(1 + 99 * 0.05)
    assert harness.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_projection_bound():
    p = arith.Proj("x", 2, 4, 8)
    assert p.ops == 128 and p.bytes == 32 + 4 * 2 * 12
    assert p.least_s == max(128 / 3.35e12, 128 / 1979e12)


def test_layer_projections_by_hand():
    names = [(p.name, p.M, p.K, p.N)
             for p in arith.layer_projections(TINY, 3)]
    # head_dim 2: wqkv N = (2 + 2) * 2
    assert names == [("wqkv", 3, 4, 8), ("wo", 3, 4, 4), ("w_up", 3, 4, 8),
                     ("w_down", 3, 8, 4)]
    # an explicit head_dim widens wq and wo: 3 heads of 2 on d_model 4
    wide = dict(TINY, n_heads=3, head_dim=2)
    names = [(p.name, p.K, p.N)
             for p in arith.layer_projections(wide, 1, merged=False)]
    assert names[:4] == [("wq", 4, 6), ("wk", 4, 2), ("wv", 4, 2),
                         ("wo", 6, 4)]
    assert arith.attn_params(wide) == 4 * 6 + 2 * 4 * 2 + 6 * 4


def test_attention_and_head_flops():
    # one request, queries at 0 and 1 read 1 and 2 keys: 3 (q, k) pairs,
    # each 2 heads x head_dim 2 x (scores + weighted sum) x 2 flops
    assert arith.attention_flops(TINY, 1, [0, 1]) == 4 * 2 * 2 * 3
    assert arith.head_flops(TINY, 5) == 2 * 5 * 4 * 16


def test_serve_round_work():
    w = arith.serve_round_least_s(TINY, 1, 2, 2)
    ops = sum(p.ops for p in arith.call_projections(TINY, 2)) + \
        sum(p.ops for p in arith.call_projections(TINY, 1))
    assert w["proj_s"] == pytest.approx(ops / 1979e12)
    f32 = arith.attention_flops(TINY, 1, [0, 1]) + \
        arith.attention_flops(TINY, 1, [2]) + arith.head_flops(TINY, 2)
    assert w["f32_s"] == pytest.approx(f32 / 67e12)


def test_param_count_matches_the_program():
    from repro_torch import configs
    for name in ("minitron-8b", "gemma-7b"):
        cfg = configs.get(name)
        m = {k: getattr(cfg, k) for k in ("family", "n_layers", "d_model",
                                          "n_heads", "n_kv", "d_ff", "vocab",
                                          "mlp_kind")}
        m["head_dim"] = cfg.head_dim
        assert arith.param_count(m) == cfg.param_count()
