"""The QAT train step of the VLM internvl2-76b (frontend_proj over the
prefix patches, outside remat) against the JAX package's run op by op,
on the CPU, driven through make_train_step directly (both packages'
train CLIs raise KeyError: 'frontend' for it).
tests/test_torch_train_dense_families.py holds the helpers and the
tolerances.
"""
import pytest
from threadpoolctl import threadpool_limits

from test_torch_train_dense_families import check_train_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core."""
    with threadpool_limits(limits=1):
        yield


@pytest.mark.parametrize("arch", ["internvl2-76b"])
def test_train_step_matches_reference_op_by_op(arch):
    check_train_step(arch)
