"""The serve of internvl2-76b (the VLM) against the JAX package's, at
smoke size, on the reference's own weights (tests/test_torch_vlm.py holds
forward_train with the prefix).  Serving prepends no prefix, in both
packages: internvl2 serves as the dense decoder it holds.

Tolerances, and why:
  * serve.main --prequantize ('xla': lut_matmul products, dynamic
    activation scales), both modes, the reference op by op
    (jax.disable_jit): greedy ids equal.
  * serve.main --calibrate 1: decode-shaped calibration never runs
    frontend_proj, so both packages' apply_calibration raise the same
    KeyError naming it (the reference's caveat, reproduced).
"""
import jax
import numpy as np
import pytest

from repro.launch import serve as rserve
from repro.models import transformer as RT
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from test_torch_moe import MODES
from test_torch_serve_options import _ref_params
from test_torch_vlm import ARCH, base  # noqa: F401


def _argv(*extra):
    return ["--arch", ARCH, "--smoke", "--requests", "2", "--prompt-len",
            "3", "--gen-len", "4", *extra]


@pytest.mark.parametrize("mode", MODES)
def test_prequantize_serve_matches_reference(base, monkeypatch, mode):
    argv = _argv("--prequantize", "--quant-mode", mode)
    monkeypatch.setattr(RT, "init_params", lambda rng, cfg: base[2])
    with jax.disable_jit():
        ids_r, _ = rserve.main(argv)
    monkeypatch.setattr(TT, "init_params", _ref_params(base[2]))
    ids_t, logits = tserve.main(argv + ["--device", "cpu"])
    print(f"\n[internvl2 --prequantize {mode}] ids {ids_t.tolist()}")
    assert ids_t.shape == (2, 4)
    assert np.isfinite(logits).all()
    np.testing.assert_array_equal(ids_t, ids_r)


def test_calibrated_serve_is_refused_as_the_reference_refuses_it(
        base, monkeypatch):
    argv = _argv("--calibrate", "1")
    monkeypatch.setattr(RT, "init_params", lambda rng, cfg: base[2])
    with jax.disable_jit(), pytest.raises(KeyError) as r:
        rserve.main(argv)
    monkeypatch.setattr(TT, "init_params", _ref_params(base[2]))
    with pytest.raises(KeyError) as t:
        tserve.main(argv + ["--device", "cpu"])
    assert str(t.value) == str(r.value)
    assert "'frontend_proj' missing" in str(t.value)
    assert f"({7 * base[1].n_layers} sites recorded)" in str(t.value)
