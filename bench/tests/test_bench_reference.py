"""The reference: its own multiplier table, its exact product sums, its
inputs, and its agreement with the port at smoke size."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness, inputs
from bench.reference.decoder import Products
from bench.reference.multiplier import product_table

from _smoke import run_cell

SERVE_CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]
    if w["traffic"] != "qat-train"]


def test_product_table_is_the_programs():
    from repro_torch.core import lut
    assert np.array_equal(product_table(), lut.build_lut("design2"))


@pytest.mark.parametrize("M,K,N", [(1, 8, 8), (5, 24, 16), (20, 16, 8)])
def test_product_sums_are_exact(M, K, N):
    g = torch.Generator().manual_seed(M * K)
    qa = torch.randint(0, 256, (M, K), generator=g)
    qw = torch.randint(0, 256, (K, N), generator=g).to(torch.uint8)
    tab = torch.as_tensor(product_table())
    direct = tab[qa[:, :, None], qw.long()[None]].sum(1).double()
    assert torch.equal(Products("cpu").sums(qa, qw), direct)


def test_calibration_prompts_are_the_ladders():
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.get("minitron-8b")
    m = {"vocab": cfg.vocab}
    ladder = serve._calibration_prompts(cfg, np.random.default_rng(4242), 1,
                                        4, 64)[0]
    assert np.array_equal(inputs.calibration_prompts(m), ladder)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import bench.reference.decoder, bench.inputs, bench.arith; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_reference_agrees_with_the_port(cell):
    """At smoke size, in one thread, the program's served tokens are the
    reference's best and their logits and KV caches agree to float32
    rounding, and its logits lie in the head's column space."""
    _, out = run_cell(cell)
    rec = out["record"]
    assert out["checks"]["gap"]["value"] == 0.0

    assert rec.rounds and all(r.served.shape == (3, 5) for r in rec.rounds)
    assert out["checks"]["cache_err"]["value"] < 1e-3
    assert out["checks"]["head_err"]["value"] < 1e-5


def test_head_residual_reads_the_heads_precision():
    """Float32 logits of a random table lie in its column space to float32
    rounding; with the operands rounded to bfloat16 they do not."""
    from bench.traffic.kinds import static_rounds as sr
    g = torch.Generator().manual_seed(5)
    E = torch.randn(4000, 64, generator=g) * 0.02
    x = torch.randn(6, 64, generator=g)
    assert sr.head_residual(E, x @ E.T) < 1e-6
    low = (x.to(torch.bfloat16) @ E.to(torch.bfloat16).T).float()
    assert sr.head_residual(E, low) > 1e-3
