"""train.make_prefill_logits against the JAX package's, on the CPU, for
the encoder-decoder whisper-small (the encoder over the stub
frames, every decoder layer's cross block) and the VLM internvl2-76b
(the prefix projected by frontend_proj and prepended), under
both QuantConfigs: tests/test_torch_prefill_logits.py holds the
tolerances and the helpers (a file of its own, so that the suite runs
the reference's op-by-op compiles of these configs beside the others').
"""
import pytest
from threadpoolctl import threadpool_limits

from test_torch_prefill_logits import QCFGS, check_prefill_logits

ARCHS = ["whisper-small", "internvl2-76b"]


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
