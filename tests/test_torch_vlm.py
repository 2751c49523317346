"""The VLM family (internvl2-76b) against the JAX package, at smoke size,
on the reference's own weights (``T.init_params(PRNGKey(0), SMOKE)``
carried across with interop.params_from_numpy): forward_train with the
projected prefix and train-shaped calibration (the one pass that
visits frontend_proj).  The serve is held in tests/test_torch_vlm_serve.py
(the files run side by side).

Tolerances, and why (gaps measured on these sizes and inputs):
  * forward_train (xla, both modes, 4 prefix patches and 8 tokens)
    against the reference run op by op (jax.disable_jit): every product
    equal on the same operands, the prefix projection's too, 0 steps
    flipped, loss within rtol 2e-6 (the op-by-op bounds of
    tests/test_torch_train.py).
  * Train-shaped calibration (calibrate, forward_train under the
    observer): the same 15 sites (the bare ``frontend_proj`` among
    them), counts and weight histograms, lo/hi/amax within rtol 4.2e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calib as rcalib
from repro import configs as rconfigs
from repro.kernels import ops as rops
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import prequantize_weights as r_preq
from repro_torch import calib as tcalib
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import prequantize_weights as t_preq
from test_torch_moe import MODES, _RecordProducts

ARCH = "internvl2-76b"


@pytest.fixture(scope="module")
def base():
    cfg_r = rconfigs.get_smoke(ARCH)
    pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    cfg_t = tconfigs.get_smoke(ARCH)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                   device="cpu")
    return cfg_r, cfg_t, pj, pt


@pytest.mark.parametrize("mode", MODES)
def test_forward_train_with_the_prefix_matches_reference(base, mode):
    cfg_r, cfg_t, pj, pt = base
    batch = tconfigs.make_smoke_batch(cfg_t, 2, 8, seed=5)
    assert batch["frontend"].shape == (2, cfg_t.n_prefix,
                                       cfg_t.frontend_dim)
    rcfg = RQ(design="design2", backend="xla", mode=mode)
    tcfg = TQ(design="design2", backend="xla", mode=mode)
    with jax.disable_jit(), _RecordProducts(rops, np.asarray) as rrec:
        r_loss, _ = RT.forward_train(
            pj, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_r, rcfg)
    with _RecordProducts(tops, lambda t: t.numpy()) as trec:
        t_loss, _ = TT.forward_train(
            pt, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t,
            tcfg)
    # the prefix projection, then 7 projections a layer over prefix + S
    assert len(trec.calls) == len(rrec.calls) == 1 + 7 * cfg_t.n_layers
    assert trec.calls[0][0].shape == (2, cfg_t.n_prefix, cfg_t.frontend_dim)
    assert trec.calls[1][0].shape[:2] == (2, cfg_t.n_prefix + 8)
    flips = total = 0
    for (ra, rb), (ta, tb) in zip(rrec.calls, trec.calls):
        np.testing.assert_array_equal(tb, rb)
        flips += int((ta != ra).sum())
        total += ra.size
    print(f"\ninternvl2 forward_train {mode}: {flips} of {total} steps "
          f"flipped; loss {float(t_loss)!r} vs {float(r_loss)!r}")
    assert flips == 0
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=2e-6)


def test_train_shaped_calibration_names_frontend_proj(base):
    cfg_r, cfg_t, pj, pt = base
    # 'xla' (its integer products are 'delta''s) shares the reference's
    # compiled ops with the forward_train test
    rq = RQ(design="design2", backend="xla", mode="asym_u8")
    tq = TQ(design="design2", backend="xla", mode="asym_u8")
    batches = [rconfigs.make_smoke_batch(cfg_r, 2, 8, seed=5)]
    with jax.disable_jit():
        table_r = rcalib.calibrate(r_preq(pj, rq), cfg_r, rq, batches)
    table_t = tcalib.calibrate(t_preq(pt, tq), cfg_t, tq, batches,
                               device="cpu")
    assert sorted(table_t.sites) == sorted(table_r.sites)
    assert len(table_t.sites) == 1 + 7 * cfg_t.n_layers
    assert "frontend_proj" in table_t.sites
    rel = 0.0
    for k, r in table_r.sites.items():
        t = table_t.sites[k]
        for f in ("lo", "hi", "amax"):
            rel = max(rel, abs(t[f] - r[f]) / max(abs(r[f]), 1e-30))
        assert t["count"] == r["count"]
        np.testing.assert_array_equal(t["hist_w"], r["hist_w"])
    print(f"\n[internvl2 train-shaped calibration] lo/hi/amax within "
          f"{rel:.3e} relative")
    assert rel <= 4.2e-7
