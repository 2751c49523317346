"""The port's copies of the gate-level tables against the JAX package's:
delta tables bit for bit (values and dtype, the int32 fallback of design
'initial' included) and the mean-field compensation tables exactly."""
import jax  # noqa: F401  (both packages side by side, as in every port test)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.core import lut as rlut
from repro.quant import linear as rlin
from repro_torch.core import lut as tlut
from repro_torch.quant import linear as tlin


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
