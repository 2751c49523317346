"""train.make_prefill_logits (the cache-free full-sequence forward of the
dry run's prefill cells) against the JAX package's, on the CPU, at smoke
size on the reference's own weights (``init_params(PRNGKey(0), SMOKE)``
carried across with interop.params_from_numpy) and a seeded
``make_smoke_batch(cfg, 2, 16)``: one config of each family, under the
dry run's QuantConfig(design2, residual_xla, rank 16) and the default
QuantConfig() ('delta').  The reference runs op by op (jax.disable_jit),
which compiles every primitive at every new shape: about 25 s a config
on one core.  So the families are held in three files, which the suite
runs side by side: this one the dense qwen3-1.7b and the MoE
mixtral-8x7b (and the helpers), test_torch_prefill_logits_recurrent.py
the hybrid recurrentgemma-2b and the ssm xlstm-125m,
test_torch_prefill_logits_encdec_vlm.py whisper-small with its encoder
and internvl2-76b with its projected prefix.

Tolerances, and why (gaps measured on these sizes and inputs):
  * Weight operands are equal at every launch.
  * 'delta' free-running: 0 activation steps flipped (so every integer
    product has the reference's operands); logits within 8 float32 ulps
    of max|logit| (measured 3-4: torch's and XLA's float32 glue,
    rmsnorm and softmax sums, in another order).
  * residual_xla, launch by launch: the port's product on the port's
    operands within 1e-6 of max|out| of the reference's product on the
    same operands (measured 1.2e-7: its float32 correction sum runs in
    another order; tests/test_torch_train.py's bound).
  * residual_xla: a float32 ulp of a correction sum moves a tensor's
    amax, and with it the per-tensor dynamic scale of every step of the
    next projection's input; the random-weight model amplifies that
    (measured free-running: 0 to 13,580 steps flipped, logits up to
    0.23 apart).  So the chain is held with the reference's products
    fed to the port (each checked against the port's own, as above):
    0 steps flipped, logits within 8 ulps of max|logit| (measured 3-4).
    The free-running gap is printed, not held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro import configs as rconfigs
from repro.kernels import ops as rops
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.train import make_prefill_logits as r_prefill_logits
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import ops as tops
from repro_torch.quant import QuantConfig as TQ
from repro_torch.train import make_prefill_logits

ARCHS = ["qwen3-1.7b", "mixtral-8x7b"]
QCFGS = {"default": {},
         "residual_xla": dict(design="design2", backend="residual_xla",
                              rank=16)}
ULPS = 8
RESID_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core."""
    with threadpool_limits(limits=1):
        yield


_BASES = {}


def _base(arch):
    """(reference config, port config, reference params, port params,
    batch), built once an arch."""
    if arch not in _BASES:
        cfg_r, cfg_t = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
        pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
        pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                       device="cpu")
        batch = tconfigs.make_smoke_batch(cfg_t, 2, 16, seed=11)
        _BASES[arch] = (cfg_r, cfg_t, pj, pt, batch)
    return _BASES[arch]


def _ref_product(a, b, design, backend, rank, signed):
    with jax.disable_jit():
        return np.asarray(rops.approx_matmul(jnp.asarray(a), jnp.asarray(b),
                                             design, backend, rank, signed))


class _Products:
    """Patch the port's ops.approx_matmul: record each launch's operands;
    on a residual backend hold the port's product of them against the
    reference's product of the same operands, and with ``feed_reference``
    return the reference's product in place of the port's."""

    def __init__(self, feed_reference: bool):
        self.feed, self.calls, self.max_rel = feed_reference, [], 0.0

    def __enter__(self):
        self.orig = tops.approx_matmul

        def prod(a, b, design="design2", backend="delta", rank=32,
                 signed=False):
            mine = self.orig(a, b, design, backend, rank, signed)
            an, bn = a.numpy(), b.numpy()
            self.calls.append((an, bn))
            if not backend.startswith("residual"):
                assert not self.feed
                return mine
            want = _ref_product(an, bn, design, backend, rank, signed)
            got = mine.numpy()
            assert got.shape == want.shape
            scale = max(float(np.abs(want).max()), 1e-30)
            rel = float(np.abs(got - want).max()) / scale
            self.max_rel = max(self.max_rel, rel)
            assert rel <= RESID_REL, rel
            return torch.from_numpy(want.copy()) if self.feed else mine
        tops.approx_matmul = prod
        return self

    def __exit__(self, *exc):
        tops.approx_matmul = self.orig


class _RefRecord:
    def __enter__(self):
        self.orig, self.calls = rops.approx_matmul, []

        def rec(a, b, *args, **kw):
            self.calls.append((np.asarray(a), np.asarray(b)))
            return self.orig(a, b, *args, **kw)
        rops.approx_matmul = rec
        return self

    def __exit__(self, *exc):
        rops.approx_matmul = self.orig


def _flips(ref_calls, port_calls):
    """Activation steps that differ; weight operands must be equal."""
    assert len(port_calls) == len(ref_calls)
    flips = 0
    for (ra, rb), (ta, tb) in zip(ref_calls, port_calls):
        np.testing.assert_array_equal(tb, rb)
        assert ta.shape == ra.shape
        flips += int((ta != ra).sum())
    return flips


def _ulps(got, want):
    return float(np.abs(got - want).max()) / float(
        np.spacing(np.float32(np.abs(want).max())))


def check_prefill_logits(arch, qname):
    """make_prefill_logits of ``arch``'s smoke config under QCFGS[qname]
    against the reference's (see the module docstring)."""
    cfg_r, cfg_t, pj, pt, batch = _base(arch)
    rq, tq = RQ(**QCFGS[qname]), TQ(**QCFGS[qname])
    with jax.disable_jit(), _RefRecord() as rrec:
        want = np.asarray(r_prefill_logits(cfg_r, rq)(
            pj, {k: jnp.asarray(v) for k, v in batch.items()}))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fn = make_prefill_logits(cfg_t, tq)
    with _Products(feed_reference=False) as free:
        got = fn(pt, tb)
    assert not got.requires_grad
    got = got.numpy()
    prefix = cfg_t.n_prefix if cfg_t.family == "vlm" else 0
    rows = min(128, prefix + batch["tokens"].shape[1])
    assert want.shape == got.shape == (2, rows, cfg_t.vocab)
    assert np.isfinite(got).all()
    assert len(free.calls) == len(rrec.calls) > 0
    free_flips = _flips(rrec.calls, free.calls)
    free_ulps = _ulps(got, want)
    print(f"\n{arch} {qname}: {len(free.calls)} launches; free-running "
          f"{free_flips} steps flipped, logits {free_ulps:.1f} ulps of "
          f"max|logit| apart ({float(np.abs(got - want).max()):.3e}); "
          f"products within {free.max_rel:.2e} of max|out|")
    if qname == "default":
        assert free_flips == 0
        assert free_ulps <= ULPS
        return
    with _Products(feed_reference=True) as fed:
        got_fed = fn(pt, tb).numpy()
    fed_flips = _flips(rrec.calls, fed.calls)
    fed_ulps = _ulps(got_fed, want)
    print(f"{arch} {qname} fed the reference's products: {fed_flips} steps "
          f"flipped, logits {fed_ulps:.1f} ulps apart")
    assert fed_flips == 0
    assert fed_ulps <= ULPS


@pytest.mark.parametrize("qname", list(QCFGS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch, qname):
    check_prefill_logits(arch, qname)
