"""The QAT train step of every family against the JAX package's, on the
CPU: make_train_step on the reference's own smoke weights
(``init_params(PRNGKey(0), SMOKE)`` carried across with
interop.params_from_numpy) and one ``make_smoke_batch(batch=2, seq=16,
seed=1)`` batch, 'xla' asym_u8, remat on, one AdamW step, held against
the reference's make_train_step run op by op (jax.disable_jit).  This
file holds the helpers and the dense gemma-7b (geglu, head_dim 256) and
minitron-8b (relu2); test_torch_train_{moe,moe_scout,recurrent,xlstm,
encdec,vlm}.py hold the other families, a config a file (the reference
run op by op compiles every primitive per shape: 25-70 s a config).

What is held, and the tolerances (the gaps measured on these configs
with the op-by-op reference, with headroom):
  * the loss within 2e-6 relative (measured at most 2.3e-7, mixtral),
    and the MoE load-balancing aux within 2e-6 (measured 1.1e-7 and 0;
    0 for the other families, in both packages);
  * every gradient leaf, matched by its path, within 1e-5 relative in
    norm (measured at most 1.24e-6, xlstm's mLSTM wf; the float32
    backward products and softmax/scan chains sum in another order);
  * the grad norm within 1e-4 relative (measured at most 5.2e-5, xlstm:
    a float32 sum over every gradient entry in another order, as in
    qwen3's test);
  * the first moment (1 - b1) * clip * g within 1e-4 relative in norm
    (measured at most 5.2e-5: the grad norm's gap, through the clip)
    and the update within 1e-3 (measured at most 1.4e-4, whisper);
    qwen3's bounds;
  * 0 flipped quantization steps: each of the port's projection
    launches, forward and remat recompute, quantizes its activations to
    the steps of the reference's launch on the same weight;
  * the port's projection launches: the path's count, each forward
    projection twice under remat (the forward and its recompute), the
    encoder and the VLM's prefix projection once (they run outside the
    remat scope, as in the reference).
The reference's jitted step is no yardstick here: on whisper XLA's fused
float order flips quantization steps in the encoder (its jitted loss sits
9.6e-4 from its own op-by-op loss, and its gradients up to 39% apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro import configs as rconfigs
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.train import OptConfig as ROC
from repro.train import make_train_step as r_train_step
from repro.train import optimizer as ropt
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import ops as tops
from repro_torch.launch.shardings import tree_paths
from repro_torch.quant import QuantConfig as TQ
from repro_torch.train import OptConfig as TOC
from repro_torch.train import make_train_step as t_train_step
from repro_torch.train import optimizer as topt
from test_torch_train import (_flat_port, _flat_ref, _flips, _rel,
                              _Record, _RecordJitted)

OPT = dict(warmup_steps=5, total_steps=100)
LOSS_RTOL = 2e-6
LEAF_RTOL = 1e-5
GNORM_RTOL = 1e-4
MU_RTOL = 1e-4
UPDATE_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and OpenMP thread (numpy's and torch's) while this file
    runs: the suite runs its files side by side on every core."""
    with threadpool_limits(limits=1):
        yield


def train_launches(cfg) -> int:
    """Projection launches of one remat train step: per decoder layer its
    block's projections and (encdec) its cross block's four, each twice
    (forward and recompute); the encoder's and the frontend projection's
    once."""
    glu = cfg.mlp_kind in ("swiglu", "geglu")
    mlp = 3 if glu else 2
    per_kind = {"attn": 4 + mlp, "rec": 4 + mlp, "mlstm": 6, "slstm": 5,
                "moe": 4 + 1 + 3 * cfg.n_experts
                + (3 if cfg.shared_expert_ff else 0)}
    n = sum(per_kind[k] for k in cfg.pattern) * cfg.n_units
    if cfg.family == "encdec":
        n += 4 * cfg.n_layers
    once = (4 + mlp) * cfg.enc_layers if cfg.family == "encdec" else 0
    if cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
        once += 1
    return 2 * n + once


def _ref_paths(tree):
    """(path, leaf) in jax.tree.leaves order, the path as tree_paths
    writes the port's."""
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in kp]
        out.append(("/".join(parts), np.asarray(leaf)))
    return out


class _Grads:
    """Record the gradients a train step hands its optimizer.apply (a
    copy: the port's apply updates them in place)."""

    def __init__(self, module, copy):
        self.module, self.copy, self.grads = module, copy, None

    def __enter__(self):
        self.orig = self.module.apply

        def rec(params, grads, *a, **k):
            self.grads = self.copy(grads)
            return self.orig(params, grads, *a, **k)
        self.module.apply = rec
        return self

    def __exit__(self, *exc):
        self.module.apply = self.orig


def run_train_step_both(arch, backend="xla", mode="asym_u8"):
    """One make_train_step step of ``arch``'s smoke config in both
    packages; returns the measured gaps and counts."""
    cfg_r, cfg_t = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    ref_params = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    batch_np = rconfigs.make_smoke_batch(cfg_r, batch=2, seq=16, seed=1)
    rq = RQ(design="design2", backend=backend, mode=mode)
    tq = TQ(design="design2", backend=backend, mode=mode)
    roc, toc = ROC(**OPT), TOC(**OPT)
    r_step = r_train_step(cfg_r, rq, roc, microbatches=1, remat=True)
    with jax.disable_jit(), _RecordJitted() as rrec, \
            _Grads(ropt, lambda g: g) as rgrads:
        rp, rs, rm = r_step(ref_params, ropt.init(ref_params, roc),
                            {k: jnp.asarray(v) for k, v in batch_np.items()})
        jax.effects_barrier()
    tp0 = interop.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                    cfg_t, device="cpu")
    with _Record(tops, lambda t: t.numpy()) as trec, \
            _Grads(topt, lambda g: topt.tree_map(torch.clone, g)) as tgrads:
        tp, ts, tm = t_train_step(cfg_t, tq, toc, remat=True)(
            tp0, topt.init(tp0, toc),
            {k: torch.from_numpy(v) for k, v in batch_np.items()})
    p0 = _flat_ref(ref_params)
    want = _ref_paths(rgrads.grads)
    got = [(p, t.double().numpy()) for p, t in tree_paths(tgrads.grads)]
    assert [p for p, _ in got] == [p for p, _ in want]
    leaves = {p: _rel(g.astype(np.float64).ravel(),
                      w.astype(np.float64).ravel())
              for (p, g), (_, w) in zip(got, want)}
    flips, steps = _flips(trec.calls, rrec.calls)
    assert int(ts.step) == int(rs.step) == 1
    return {"loss": abs(float(tm["loss"]) / float(rm["loss"]) - 1),
            "aux": (float(tm["aux"]), float(rm["aux"])),
            "grad_norm": abs(float(tm["grad_norm"])
                             / float(rm["grad_norm"]) - 1),
            "leaves": leaves,
            "mu": _rel(_flat_port(ts.mu), _flat_ref(rs.mu)),
            "update": _rel(_flat_port(tp) - p0, _flat_ref(rp) - p0),
            "flips": flips, "steps": steps, "launches": len(trec.calls),
            "want_launches": train_launches(cfg_t)}


def check_train_step(arch):
    """run_train_step_both, held to this file's tolerances."""
    g = run_train_step_both(arch)
    worst = max(g["leaves"], key=g["leaves"].get)
    print(f"\n{arch}: loss {g['loss']:.2e}, aux {g['aux']}, grad_norm "
          f"{g['grad_norm']:.2e}, {len(g['leaves'])} gradient leaves (worst "
          f"{worst} {g['leaves'][worst]:.2e}), mu {g['mu']:.2e}, update "
          f"{g['update']:.2e}, {g['flips']} of {g['steps']} steps flipped, "
          f"{g['launches']} launches")
    assert g["launches"] == g["want_launches"], g
    assert g["flips"] == 0, g
    assert g["loss"] <= LOSS_RTOL, g
    t_aux, r_aux = g["aux"]
    assert abs(t_aux - r_aux) <= LOSS_RTOL * abs(r_aux), g
    bad = {p: v for p, v in g["leaves"].items() if not v <= LEAF_RTOL}
    assert not bad, bad
    assert g["grad_norm"] <= GNORM_RTOL, g
    assert g["mu"] <= MU_RTOL, g
    assert g["update"] <= UPDATE_RTOL, g
    return g


@pytest.mark.parametrize("arch", ["gemma-7b", "minitron-8b"])
def test_train_step_matches_reference_op_by_op(arch):
    check_train_step(arch)
