"""train.make_prefill_logits against the JAX package's, on the CPU, for
the hybrid recurrentgemma-2b (RG-LRU blocks and local attention)
and the ssm xlstm-125m (mLSTM and sLSTM blocks), under
both QuantConfigs: tests/test_torch_prefill_logits.py holds the
tolerances and the helpers (a file of its own, so that the suite runs
the reference's op-by-op compiles of these configs beside the others').
"""
import pytest
from threadpoolctl import threadpool_limits

from test_torch_prefill_logits import QCFGS, check_prefill_logits

ARCHS = ["recurrentgemma-2b", "xlstm-125m"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core."""
    with threadpool_limits(limits=1):
        yield


@pytest.mark.parametrize("qname", list(QCFGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch, qname):
    check_prefill_logits(arch, qname)
