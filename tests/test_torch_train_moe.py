"""The QAT train step of mixtral-8x7b (top-2 of 8 experts) against the
JAX package's run op by op, on the CPU: the gradients through the router,
the (E, C) dispatch, every expert's chain and the index_add_ combine.
tests/test_torch_train_dense_families.py holds the helpers and the
tolerances (a file of its own: the reference's op-by-op MoE step takes
about a minute).
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b"])
def test_train_step_matches_reference_op_by_op(arch):
    check_train_step(arch)
