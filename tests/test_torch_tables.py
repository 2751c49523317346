"""The port's error metrics, table rows and the remaining small functions
of modules it had already copied, against the JAX package's, on the CPU:

  * every row of repro_torch.app.tables.ALL equals benchmarks/tables.py's
    (loaded from its file: pytest's path holds src, not the repo root);
  * core.metrics and core.lut's delta_fits_int16 / exact_rank /
    rank_profile for every registered design;
  * kernels.ops.approx_mul (the image pipelines' product), unsigned and
    signed, on broadcast shapes: bit-equal;
  * quant's dequantize, dequantize_int8, fake_quant (value and
    straight-through gradient) and qeinsum_heads.  The dequantizers and
    fake_quant are the same float32 operations as the reference's and
    are held bit-equal; qeinsum_heads is a qdot, held to the serving
    tolerance (rtol 1e-5 plus 1e-5 * max|y|: the integer product is
    exact, the compensation terms are float32 sums in another order).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.core import lut as rlut
from repro.core import metrics as rmetrics
from repro.core import multipliers as RM
from repro.kernels import ops as rops
from repro.quant import QuantConfig as RQ
from repro.quant import linear as rlin
from repro.quant import quantize as rquant
from repro.signed import SIGNED_MULTIPLIERS as RSIGNED
from repro_torch.app import tables
from repro_torch.core import lut as tlut
from repro_torch.core import metrics as tmetrics
from repro_torch.core import multipliers as TM
from repro_torch.kernels import ops as tops
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import (dequantize, dequantize_int8, fake_quant,
                               qeinsum_heads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGNS = sorted(RM.MULTIPLIERS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core
    (pytest-xdist), where threads for these small ops only contend."""
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def ref_tables():
    spec = importlib.util.spec_from_file_location(
        "reference_tables", os.path.join(ROOT, "benchmarks", "tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table_names_match(ref_tables):
    assert list(tables.ALL) == list(ref_tables.ALL)
    assert set(tables.DEVICE_TABLES) <= set(tables.ALL)


@pytest.mark.parametrize("name", list(tables.ALL))
def test_table_rows_equal(ref_tables, name):
    """Row for row, key for key, value for value (rounded as the
    reference rounds; design1's grad_PSNR is inf in both)."""
    got = tables.rows(name, "cpu")
    want = ref_tables.ALL[name]()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w), name
        assert g == w, (name, g, w)


def test_tables_cli_prints_csv(capsys):
    tables.main(["--only", "table1_truth_table,fig9_pdaep",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("### table1_truth_table\nsigma_in,sum_b,")
    # csv's own line ends, as benchmarks/run.py prints them
    assert "### fig9_pdaep\ndesign,PDAEP_ug,MED\r\n" in out
    with pytest.raises(SystemExit):
        tables.main(["--only", "table9", "--device", "cpu"])


def test_metric_constants():
    assert (tmetrics.N, tmetrics.MAX_ED) == (rmetrics.N, rmetrics.MAX_ED)


@pytest.mark.parametrize("design", DESIGNS)
def test_metrics_equal(design):
    tf, rf = TM.MULTIPLIERS[design], RM.MULTIPLIERS[design]
    assert np.array_equal(tmetrics.error_surface(tf),
                          rmetrics.error_surface(rf))
    assert np.array_equal(tmetrics.heatmap(tf), rmetrics.heatmap(rf))
    assert tmetrics.multiplier_stats(tf) == rmetrics.multiplier_stats(rf)
    for border in (16, 32):
        assert (tmetrics.border_error_ratio(tf, border)
                == rmetrics.border_error_ratio(rf, border))


@pytest.mark.parametrize("design", DESIGNS)
def test_lut_rank_functions_equal(design):
    assert tlut.delta_fits_int16(design) == rlut.delta_fits_int16(design)
    assert tlut.exact_rank(design) == rlut.exact_rank(design)
    assert tlut.rank_profile(design) == rlut.rank_profile(design)
    if design in RSIGNED:
        assert (tlut.delta_fits_int16(design, True)
                == rlut.delta_fits_int16(design, True))


@pytest.mark.parametrize("signed,design", [
    (False, "exact"), (False, "design2"), (False, "initial"),
    (False, "momeni15"), (True, "exact"), (True, "design2"),
    (True, "bw_design1")])
@pytest.mark.parametrize("sa,sb", [((3, 1, 5), (4, 1)), ((6,), (6,)),
                                   ((2, 3), ()), ((), (5, 2))])
def test_approx_mul_bit_equal(signed, design, sa, sb):
    lo, hi = (-128, 128) if signed else (0, 256)
    rng = np.random.default_rng(len(sa) * 7 + len(sb))
    a = rng.integers(lo, hi, sa).astype(np.int32)
    b = rng.integers(lo, hi, sb).astype(np.int32)
    got = tops.approx_mul(torch.from_numpy(a), torch.from_numpy(b), design,
                          signed)
    want = np.asarray(rops.approx_mul(jnp.asarray(a), jnp.asarray(b), design,
                                      signed))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_approx_mul_whole_table():
    """Every operand pair, unsigned, through both packages' tables."""
    v = np.arange(256, dtype=np.int32)
    got = tops.approx_mul(torch.from_numpy(v)[:, None],
                          torch.from_numpy(v)[None, :], "design1")
    assert np.array_equal(got.numpy(), rlut.build_lut("design1"))


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("axis", [None, 0, -1])
def test_dequantizers_and_fake_quant_equal(axis):
    x = _x((6, 10), 3)
    q, s, z = rquant.quantize_uint8(jnp.asarray(x), axis)
    got = dequantize(_t(q), _t(s), _t(z))
    assert np.array_equal(got.numpy(), np.asarray(rquant.dequantize(q, s, z)))
    q8, s8 = rquant.quantize_int8(jnp.asarray(x), axis)
    got = dequantize_int8(_t(q8), _t(s8))
    assert np.array_equal(got.numpy(),
                          np.asarray(rquant.dequantize_int8(q8, s8)))

    g = _x((6, 10), 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fake_quant(xt, axis)
    (y * torch.from_numpy(g)).sum().backward()
    want = rquant.fake_quant(jnp.asarray(x), axis)
    assert np.array_equal(y.detach().numpy(), np.asarray(want))
    rgrad = jax.grad(lambda v: jnp.sum(rquant.fake_quant(v, axis)
                                       * jnp.asarray(g)))(jnp.asarray(x))
    assert np.array_equal(xt.grad.numpy(), np.asarray(rgrad))
    assert np.array_equal(xt.grad.numpy(), g)     # the identity's gradient


@pytest.mark.parametrize("mode", ["asym_u8", "sym_i8"])
@pytest.mark.parametrize("design", ["design2", "exact"])
def test_qeinsum_heads_matches(mode, design):
    x, w = _x((2, 3, 16), 5), _x((4, 16, 8), 6)
    got = qeinsum_heads(torch.from_numpy(x), torch.from_numpy(w),
                        TQ(design=design, mode=mode))
    want = np.asarray(rlin.qeinsum_heads(jnp.asarray(x), jnp.asarray(w),
                                         RQ(design=design, mode=mode)))
    assert got.shape == want.shape == (2, 3, 4, 8)
    gap = np.abs(got.detach().numpy() - want).max()
    print(f"qeinsum_heads {mode} {design}: max |port - reference| {gap:.3g}"
          f" (max |y| {np.abs(want).max():.3g})")
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
