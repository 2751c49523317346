"""The QAT train step of llama4-scout-17b-a16e (top-1 of 16 experts and
a shared expert) against the JAX package's run op by op, on the CPU.
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


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e"])
def test_train_step_matches_reference_op_by_op(arch):
    check_train_step(arch)
