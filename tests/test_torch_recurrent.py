"""The recurrent families (recurrentgemma-2b: RG-LRU blocks and local
attention; xlstm-125m: mLSTM and sLSTM blocks) against the JAX package,
at smoke size, on the reference's own weights
(``T.init_params(PRNGKey(0), SMOKE)`` carried across with
interop.params_from_numpy).  The calibrated serve of both is held in
tests/test_torch_recurrent_serve.py (the reference runs op by op, so
the two files run side by side).

Tolerances, and why (gaps measured on these sizes and inputs):
  * The RG-LRU's scan: models.recurrent.associative_scan against
    jax.lax.associative_scan run op by op, bit-equal at every length.
    The jitted reference contracts the combine's a_r * b_l + b_r into a
    fused multiply-add, so it is not the yardstick.
  * Each block (rglru, mlstm, slstm) against the reference's run op by op
    (jax.disable_jit), both modes, prequantized weights with dynamic
    activation quantization, a fresh and a carried state, S = 1 and
    S = 5: every quantized operand equal (0 steps flipped); the conv
    state bit-equal; the float states within STATE_RTOL and the outputs
    within OUT_RTOL of their largest magnitude, 3 and 4 float32 ulps of
    it (measured at most 1.9e-7 for a state, mLSTM's m, and 3.1e-7 for
    an output, mLSTM's y; the RG-LRU's h 1.7e-7).  So the recurrent
    float states are not bit-equal to the reference's: torch's exp,
    log1p, sigmoid, tanh and even sqrt are not XLA's CPU forms (which
    differ from them in the last bit on 0.4-60% of random float32
    inputs), and torch's einsum sums mLSTM's C q and n q in another
    order than XLA's dot.  The gap is printed.
  * forward_train (xla asym_u8) against the reference run op by op:
    every product equal on the same operands, at most 0.1% of the steps
    flipped, loss within rtol 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.kernels import ops as rops
from repro.models import recurrent as rrec
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import linear as rlin
from repro.quant import prequantize_weights as r_preq
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import ops as tops
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq
from test_torch_moe import (MODES, _count_flips, _np,  # noqa: F401
                            _observing, _RecordProducts, _Recorder)

ARCHS = ["recurrentgemma-2b", "xlstm-125m"]
STATE_RTOL = 3 * 2.0 ** -23  # of a float state's largest magnitude
OUT_RTOL = 4 * 2.0 ** -23    # of a block output's largest magnitude
B, P, GEN = 2, 4, 3         # served requests, prompt, generated


@pytest.fixture(scope="module")
def bases():
    out = {}
    for arch in ARCHS:
        cfg_r = rconfigs.get_smoke(arch)
        pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
        cfg_t = tconfigs.get_smoke(arch)
        pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                       device="cpu")
        out[arch] = (cfg_r, cfg_t, pj, pt)
    return out


def _gap(got, want):
    """(elements apart, max |gap|, max |want|) of two float arrays."""
    got, want = _np(got), _np(want)
    return (int((got != want).sum()), float(np.abs(got - want).max()),
            float(np.abs(want).max()))


def _assert_close(tag, got, want, exact=False, rtol=STATE_RTOL):
    n, gap, top = _gap(got, want)
    print(f"  {tag}: {n} of {np.size(_np(want))} apart, max |gap| "
          f"{gap:.3e} of max |value| {top:.3e}")
    if exact:
        assert n == 0, tag
    assert gap <= rtol * max(top, 1e-30), tag


def test_params_carry_across_with_the_recurrent_trees(bases):
    cfg_r, cfg_t, pj, pt = bases["recurrentgemma-2b"]
    assert [sorted(u) for u in pt["units"]] == [
        ["mlp", "norm1", "norm2", "rec"]] * 2 + [
        ["attn", "mlp", "norm1", "norm2"]]
    rec = pt["units"][0]["rec"]
    L, R = cfg_t.n_units, cfg_t.d_rnn
    assert tuple(rec["conv"].shape) == (L, 4, R)
    assert tuple(rec["a_param"].shape) == (L, R)
    _, cfg_x, pjx, ptx = bases["xlstm-125m"]
    assert [sorted(u) for u in ptx["units"]] == [["mlstm", "norm1"]] * 2 + \
        [["norm1", "slstm"]]
    H = cfg_x.n_heads
    assert tuple(ptx["units"][0]["mlstm"]["wi"].shape) == (
        cfg_x.n_units, cfg_x.d_model, H)
    bad = jax.tree.map(np.asarray, pjx)
    bad["units"][2]["slstm"]["wo_gate"] = bad["units"][2]["slstm"][
        "wo_gate"][:, :, :8]
    with pytest.raises(ValueError, match="units.2.slstm.wo_gate"):
        interop.params_from_numpy(bad, cfg_x, device="cpu")
    # the port's own a_param is the reference's softplus^-1(-log Lambda),
    # within a few float32 ulps (torch's linspace, log and expm1 are not
    # XLA's; serving uses the reference's params, converted)
    own = TT.init_params(torch.Generator().manual_seed(0), cfg_t,
                         device="cpu")
    np.testing.assert_allclose(own["units"][0]["rec"]["a_param"].numpy(),
                               np.asarray(pj["units"][0]["rec"]["a_param"]),
                               rtol=1e-5)


def test_only_the_ported_patterns_are_taken():
    import dataclasses
    cfg = dataclasses.replace(tconfigs.get_smoke("xlstm-125m"),
                              pattern=("mlstm", "slstm"), n_layers=2)
    with pytest.raises(NotImplementedError, match="ssm"):
        TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def _sites_per_layer(cfg):
    """qdot sites of one layer of each pattern slot."""
    mlp = (3 if cfg.mlp_kind in ("geglu", "swiglu") else 2) if cfg.d_ff \
        else 0
    n = {"attn": 4 + mlp, "rec": 4 + mlp, "mlstm": 6, "slstm": 5}
    return sum(n[k] for k in cfg.pattern) * cfg.n_units


def _comb(left, right):
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


@pytest.mark.parametrize("S", [1, 2, 3, 5, 8, 13, 64])
def test_associative_scan_is_the_references(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (S, 2, 64)).astype(np.float32)
    b = rng.normal(size=(S, 2, 64)).astype(np.float32)
    ga, gb = trec.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    with jax.disable_jit():
        wa, wb = jax.lax.associative_scan(
            _comb, (jnp.asarray(a), jnp.asarray(b)), axis=0)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


def _random_state(kind, cfg, rng):
    """A carried state of the block's shapes, as a decode would hold it."""
    D, H = cfg.d_model, cfg.n_heads
    if kind == "rec":
        return {"h": rng.normal(size=(B, cfg.d_rnn)) * 0.5,
                "conv": rng.normal(size=(B, 3, cfg.d_rnn))}
    if kind == "mlstm":
        hd = D // H
        return {"C": rng.normal(size=(B, H, hd, hd)) * 0.1,
                "n": rng.normal(size=(B, H, hd)) * 0.1,
                "m": rng.normal(size=(B, H))}
    return {"c": rng.normal(size=(B, D)), "n": rng.uniform(0.5, 2, (B, D)),
            "m": rng.normal(size=(B, D))}


BLOCKS = [("recurrentgemma-2b", 0, "rec"), ("xlstm-125m", 0, "mlstm"),
          ("xlstm-125m", 2, "slstm")]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch,slot,kind", BLOCKS)
def test_block_matches_reference(bases, arch, slot, kind, mode, S, carried):
    cfg_r, cfg_t, pj, pt = bases[arch]
    rq = RQ(design="design2", backend="xla", mode=mode, inference=True)
    tq = TQ(design="design2", backend="xla", mode=mode, inference=True)
    i = cfg_t.n_units - 1           # the slot's last layer
    lpj = jax.tree.map(lambda v: v[i], r_preq(pj, rq)["units"][slot][kind])
    lpt = TT.take_layer(t_preq(pt, tq)["units"][slot][kind], i)
    rng = np.random.default_rng(S + 10 * carried + 100 * len(kind))
    x = rng.normal(size=(B, S, cfg_r.d_model)).astype(np.float32)
    state = ({k: v.astype(np.float32) for k, v in
              _random_state(kind, cfg_r, rng).items()} if carried else None)
    sr = None if state is None else {k: jnp.asarray(v)
                                     for k, v in state.items()}
    st = None if state is None else {k: torch.from_numpy(v)
                                     for k, v in state.items()}
    fns = {"rec": (lambda p, v, q, s: rrec.rglru(p, v, q, state=s),
                   lambda p, v, q, s: trec.rglru(p, v, q, state=s)),
           "mlstm": (lambda p, v, q, s: rrec.mlstm(p, v, q, cfg_r.n_heads,
                                                   state=s),
                     lambda p, v, q, s: trec.mlstm(p, v, q, cfg_t.n_heads,
                                                   state=s)),
           "slstm": (lambda p, v, q, s: rrec.slstm(p, v, q, state=s),
                     lambda p, v, q, s: trec.slstm(p, v, q, state=s))}
    fr, ft = fns[kind]
    with jax.disable_jit(), _observing(rlin, _Recorder()) as rec_r:
        yr, fin_r = fr(lpj, jnp.asarray(x), rq, sr)
    with torch.no_grad(), _observing(tlin, _Recorder()) as rec_t:
        yt, fin_t = ft(lpt, torch.from_numpy(x), tq, st)
    flips, total, dx = _count_flips(rec_r.calls, rec_t.calls, static=False)
    print(f"\n[{kind} {mode} S={S} carried={carried}] {flips} of {total} "
          f"dynamic steps flipped (max |dx| {dx:.3e})")
    assert flips == 0
    assert sorted(fin_t) == sorted(fin_r)
    for k in sorted(fin_r):
        _assert_close(f"state {k}", fin_t[k], fin_r[k], exact=k == "conv")
    _assert_close("y", yt, yr, rtol=OUT_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(bases, arch):
    cfg_r, cfg_t, pj, pt = bases[arch]
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg_r.vocab, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rcfg = RQ(design="design2", backend="xla", mode="asym_u8")
    tcfg = TQ(design="design2", backend="xla", mode="asym_u8")
    with jax.disable_jit(), _RecordProducts(rops, np.asarray) as rrec:
        r_loss, _ = RT.forward_train(
            pj, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_r, rcfg)
    with _RecordProducts(tops, lambda t: t.numpy()) as trec:
        t_loss, _ = TT.forward_train(
            pt, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t,
            tcfg)
    assert len(trec.calls) == len(rrec.calls) == _sites_per_layer(cfg_t)
    flips = total = 0
    for (ra, rb), (ta, tb) in zip(rrec.calls, trec.calls):
        np.testing.assert_array_equal(tb, rb)
        flips += int((ta != ra).sum())
        total += ra.size
    print(f"\n{arch} forward_train: {flips} of {total} steps flipped; loss "
          f"{float(t_loss)!r} vs {float(r_loss)!r}")
    assert flips <= 1e-3 * total
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=2e-6)
