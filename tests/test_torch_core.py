"""The port's copies of the gate-level tables against the JAX package's:
delta tables bit for bit (values and dtype, the int32 fallback of design
'initial' included) and the mean-field compensation tables exactly; the
unit-gate cost model and the 16x16 recomposition for every candidate
design of the planner."""
import jax  # noqa: F401  (both packages side by side, as in every port test)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.calib import plan as rplan
from repro.core import cost as rcost
from repro.core import lut as rlut
from repro.quant import linear as rlin
from repro.signed import recompose as rrec
from repro_torch.core import cost as tcost
from repro_torch.core import lut as tlut
from repro_torch.core import multipliers as tmult
from repro_torch.quant import linear as tlin
from repro_torch.signed import recompose as trec


@pytest.mark.parametrize("name,signed", [("design2", False),
                                         ("design2", True),
                                         ("design1", True),
                                         ("initial", False)])
def test_delta_tables_bit_equal(name, signed):
    got = tlut.build_delta_lut(name, signed)
    want = rlut.build_delta_lut(name, signed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("signed", [False, True])
def test_product_tables_equal(signed):
    fn_t = tlut.build_signed_lut if signed else tlut.build_lut
    fn_r = rlut.build_signed_lut if signed else rlut.build_lut
    np.testing.assert_array_equal(fn_t("design2"), fn_r("design2"))


@pytest.mark.parametrize("signed", [False, True])
def test_mean_field_tables_equal(signed):
    mu_r, mu_c, mu = tlin._mean_field_tables("design2", signed)
    r_r, r_c, r_mu = rlin._mean_field_tables("design2", signed)
    np.testing.assert_array_equal(mu_r, np.asarray(r_r))
    np.testing.assert_array_equal(mu_c, np.asarray(r_c))
    assert np.float32(mu) == np.asarray(r_mu)


@pytest.mark.parametrize("design", sorted(set(rplan.CANDIDATES_UNSIGNED)
                                          - {"exact"}))
def test_cost_model_matches_reference(design):
    from repro.core import multipliers as rmult
    t = rplan._trunc_level(design)
    plan_t, pairs_t, rca_t = tmult._truncated_plan(t)
    plan_r, pairs_r, rca_r = rmult._truncated_plan(t)
    assert (plan_t, pairs_t, rca_t) == (plan_r, pairs_r, rca_r)
    got = tcost.multiplier_cost(plan_t, pairs_t, rca_t, n_trunc=t)
    assert got == rcost.multiplier_cost(plan_r, pairs_r, rca_r, n_trunc=t)
    assert tcost.pdap(got) == rcost.pdap(got)


def test_cost_cells_and_dadda_match_reference():
    assert tcost.CELLS == {k: tcost.CellCost(**v.__dict__)
                           for k, v in rcost.CELLS.items()}
    assert tcost.dadda_cost() == rcost.dadda_cost()
    assert tcost.mult62_cost() == rcost.mult62_cost()


@pytest.mark.parametrize("name", sorted(rrec.RECOMPOSED))
def test_recomposed16_matches_reference(name):
    a, b = trec.sample_operands(name, 1 << 12, 3)
    ra, rb = rrec.sample_operands(name, 1 << 12, 3)
    np.testing.assert_array_equal(a, ra)
    np.testing.assert_array_equal(b, rb)
    np.testing.assert_array_equal(trec.RECOMPOSED[name](a, b),
                                  rrec.RECOMPOSED[name](a, b))
    assert trec.sampled_stats(name, 1 << 12) == rrec.sampled_stats(
        name, 1 << 12)
