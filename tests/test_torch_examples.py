"""The port's examples (examples/*_torch.py) run as a user runs them,
with --device cpu, each in a fresh interpreter; their printed numbers are
held against the JAX package's functions (the reference's own examples
cannot all run here: quickstart.py's Pallas step fails on jax 0.9.0).

The training example's losses come from random weights that torch draws
(the reference's come from jax.random, which torch cannot replay), so its
printed losses are held to the port's launcher run in this process, whose
steps tests/test_torch_train.py holds against the reference."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from repro.app import sharpening as rsh
from repro.core import compressors as RC
from repro.core import metrics as rmetrics
from repro.core import multipliers as RM
from repro.quant import QuantConfig as RQ
from repro.quant import qdot as rqdot
from repro.signed import RECOMPOSED as RREC
from repro.signed import SIGNED_MULTIPLIERS as RSIGNED
from repro_torch.launch import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(example: str, *args: str, cwd=ROOT) -> list:
    """The example's printed lines.  One BLAS and OpenMP thread: the
    suite runs its files side by side on every core (pytest-xdist)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", example),
         "--device", "cpu", *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=240, check=True)
    return out.stdout.splitlines()


def _quickstart_lines() -> list:
    """examples/quickstart.py's printed lines, from the reference's
    functions, but for step 5 (the Pallas kernel)."""
    st = RC.compressor_stats("3,3:2")
    lines = [f"3,3:2 compressor: NED={st['NED_C']:.5f} (paper: 0.08125), "
             f"{int(st['ER'] * 128)}/128 rows erroneous (paper: 48)"]
    for name in ("design1", "design2"):
        s = rmetrics.multiplier_stats(RM.MULTIPLIERS[name])
        lines.append(f"{name}: MED={s['MED']:.1f} "
                     f"NED={s['NED'] * 1e3:.2f}e-3 ER={s['ER'] * 100:.1f}%")
    lines.append(f"design2: 200 x 117 = {int(RM.mult_design2(200, 117))} "
                 f"(exact: {200 * 117} )")
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 64)),
                    jnp.float32)
    w = jnp.asarray(np.random.default_rng(1).normal(size=(64, 8)),
                    jnp.float32)
    y_ref = x @ w

    def rel(y):
        return float(jnp.abs(y - y_ref).mean() / jnp.abs(y_ref).mean())
    lines.append(f"approximate quantized matmul rel err: "
                 f"{rel(rqdot(x, w, RQ(design='design2'))):.3f}")
    lines.append(None)                                   # step 5
    lines.append(f"design2 signed: -100 x 77 = "
                 f"{int(np.asarray(RSIGNED['design2'](-100, 77)))} "
                 f"(exact: {-100 * 77} )")
    y_sym = rqdot(x, w, RQ(design="design2", mode="sym_i8"))
    lines.append(f"symmetric-signed quantized matmul rel err: "
                 f"{rel(y_sym):.3f}")
    spec = RREC["s16_hh_exact"]
    lines.append(f"16x16 (exact HH + design2 low blocks): -12345 x 6789 = "
                 f"{int(np.asarray(spec(-12345, 6789)))} "
                 f"(exact: {-12345 * 6789} )")
    return lines


def test_quickstart_prints_the_references_numbers():
    got = _run("quickstart_torch.py")
    want = _quickstart_lines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g == ("LUT-matmul output (cpu): (128, 128) torch.int32 "
                         "max |err| vs its plain version: 0")
        else:
            assert g == w


def test_image_sharpening_prints_table5_and_writes_under_build(tmp_path):
    got = _run("image_sharpening_torch.py", cwd=tmp_path)
    imgs = rsh.make_test_images()
    want = [f"{'multiplier':18s} {'PSNR':>7s} {'SSIM':>8s}"]
    for mult in ("design1", "design2", "momeni15", "venkatachalam16"):
        ps, ss = [], []
        for img in imgs:
            exact, test = rsh.sharpen(img, "exact"), rsh.sharpen(img, mult)
            ps.append(rsh.psnr(exact, test))
            ss.append(rsh.ssim(exact, test))
        want.append(f"{mult:18s} {np.mean(ps):7.2f} {np.mean(ss):8.4f}")
    assert got[:5] == want
    path = os.path.join("build", "sharpened_design2.npy")
    assert got[5] == f"wrote {path} (128, 96)"
    saved = np.load(tmp_path / path)
    assert saved.dtype == np.uint8
    assert np.array_equal(saved, rsh.sharpen(imgs[0], "design2"))


def test_train_example_prints_the_launchers_losses():
    got = _run("train_approx_lm_torch.py", "--steps", "2")
    last = got[-1].split()
    assert last[:2] == ["final", "losses:"], got[-1]
    vals = dict(kv.split("=") for kv in last[2:])
    want = {}
    for design in ("exact", "design2"):
        want[design] = ttrain.main([
            "--arch", "qwen3-1.7b", "--steps", "2", "--design", design,
            "--smoke", "--seq", "128", "--batch", "4", "--device", "cpu"])
        assert np.isfinite(want[design])
        assert vals[design] == f"{want[design]:.4f}"
    assert vals["gap"] == f"{want['design2'] - want['exact']:+.4f}"
    assert got.count("=== exact baseline ===") == 1
