"""The QAT train step of the hybrid recurrentgemma-2b (RG-LRU blocks, the
associative scan, local attention) against the JAX package's run op by
op, on the CPU.  tests/test_torch_train_dense_families.py holds the
helpers and the tolerances; test_torch_train_xlstm.py the ssm config (a
file each: the reference's op-by-op step takes 40-50 s a config).
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


@pytest.mark.parametrize("arch", ["recurrentgemma-2b"])
def test_train_step_matches_reference_op_by_op(arch):
    check_train_step(arch)
