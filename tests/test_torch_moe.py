"""The MoE family: the port's models/moe.py, the MoE decoder and its
configs against the JAX package's, at smoke size, on the reference's own
weights (``T.init_params(PRNGKey(0), SMOKE)`` carried across with
interop.params_from_numpy).  The calibrated serve of both configs is
held in tests/test_torch_moe_serve.py (the reference calibrates op by
op, so the two files run side by side).

Tolerances, and why (gaps measured on these sizes and inputs):
  * moe() alone (both configs, both modes, a random batch and one that
    overflows an expert's capacity): the router's top-k choices, the
    (E, C) dispatch table and the keep mask are equal; every quantized
    operand of every qdot is equal (0 flipped steps); the gate values
    within rtol 1e-6, the output and the aux term within the float32
    bound kernels/check.py sets the fused product, rtol 1e-5 plus 1e-5
    x max|y| (measured at most 2.4e-7 apart; the softmax, silu and
    compensation sums are float32 in torch's order, not XLA's).
  * A tie in the router's probabilities, set up with two equal router
    columns, goes to the lower expert index in both packages
    (jax.lax.top_k's order; the port sorts stably).
  * forward_train of mixtral's smoke config against the reference run
    op by op (jax.disable_jit), xla asym_u8: loss within rtol 2e-6 and
    aux within rtol 2e-6 (tests/test_torch_train.py's op-by-op bounds;
    measured equal), every product equal on the same operands, at most
    0.1% of the steps flipped (measured 0).
  * The non-GLU (gelu) and GLU-gelu (geglu) experts through moe() as
    above, on a replaced smoke config without a shared expert.
  * param_count / active_param_count equal to the reference's for every
    config the port has (the dense and recurrent families' too).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.kernels import ops as rops
from repro.models import moe as rmoe
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import linear as rlin
from repro.quant import prequantize_weights as r_preq
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import fuse_projections as t_fuse
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
MODES = ["asym_u8", "sym_i8"]
Y_RTOL = Y_ATOL_REL = 1e-5          # check.FUSED_RTOL / FUSED_ATOL_REL


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class _Recorder:
    """A qdot observer for either package: keeps each call's activations
    and static quantizer per site (the reference's pscan unrolls the
    layer and expert scans under it)."""

    unroll = True

    def __init__(self):
        self._idx, self.calls = [], {}

    def push(self, i):
        self._idx.append(i)

    def pop(self):
        self._idx.pop()

    def record(self, x, pre, cfg):
        key = pre.path + "@" + ".".join(map(str, self._idx))
        sx = zx = None
        if pre.act_scale is not None:
            sx = np.asarray(_np(pre.act_scale), np.float32).reshape(())
            zx = (np.asarray(_np(pre.act_zp), np.float32).reshape(())
                  if pre.act_zp is not None else np.float32(0.0))
        self.calls.setdefault(key, []).append((_np(x), sx, zx, cfg.signed))


class _observing:
    def __init__(self, lin, obs):
        self.lin, self.obs = lin, obs

    def __enter__(self):
        self.lin.set_observer(self.obs)
        return self.obs

    def __exit__(self, *exc):
        self.lin.set_observer(None)


def _qx(x, sx, zx, signed):
    lo, hi = (-128, 127) if signed else (0, 255)
    return np.clip(np.round(x / sx) + zx, lo, hi)


def _qx_dynamic(x, signed):
    """qdot's dynamic per-call quantizer (all axes), in float32 numpy."""
    f = np.float32
    if signed:
        sx = np.maximum(np.abs(x).max() / f(127.0), f(1e-8))
        return _qx(x, sx, f(0.0), True)
    lo, hi = x.min(), x.max()
    sx = np.maximum((hi - lo) / f(255.0), f(1e-8))
    return _qx(x, sx, np.clip(np.round(-lo / sx), f(0), f(255)), False)


def _count_flips(calls_r, calls_t, static=True):
    """(flipped quantized steps, total, max |dx|) over every recorded
    call, both packages' calls in the same order per site."""
    assert sorted(calls_t) == sorted(calls_r)
    flips = total = 0
    worst = 0.0
    for key, cr in calls_r.items():
        for (xr, sx, zx, sg), (xt, sx2, zx2, _) in zip(cr, calls_t[key],
                                                      strict=True):
            if static:
                assert sx == sx2 and zx == zx2, key
                qr, qt = _qx(xr, sx, zx, sg), _qx(xt, sx, zx, sg)
            else:
                qr, qt = _qx_dynamic(xr, sg), _qx_dynamic(xt, sg)
            flips += int((qt != qr).sum())
            total += xr.size
            worst = max(worst, float(np.abs(xt - xr).max()))
    return flips, total, worst


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


def test_params_carry_across_with_the_moe_tree(bases):
    cfg_r, cfg_t, pj, pt = bases["llama4-scout-17b-a16e"]
    m = pt["units"][0]["moe"]
    L, D, E, F = cfg_t.n_units, cfg_t.d_model, cfg_t.n_experts, cfg_t.d_ff
    assert tuple(m["router"].shape) == (L, D, E)
    assert tuple(m["w_gate"].shape) == tuple(m["w_up"].shape) == (L, E, D, F)
    assert tuple(m["w_down"].shape) == (L, E, F, D)
    assert set(m["shared"]) == {"w_gate", "w_up", "w_down"}
    # the port's own init draws the reference's tree and shapes
    own = TT.init_params(torch.Generator().manual_seed(0), cfg_t,
                         device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), pj)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    bad = jax.tree.map(np.asarray, pj)
    bad["units"][0]["moe"]["w_down"] = bad["units"][0]["moe"]["w_down"][
        :, :2]
    with pytest.raises(ValueError, match="moe.w_down"):
        interop.params_from_numpy(bad, cfg_t, device="cpu")


@pytest.mark.parametrize("name", ["qwen3-1.7b"] + ARCHS + [
    "gemma-7b", "minitron-8b", "nemotron-4-340b", "recurrentgemma-2b",
    "xlstm-125m", "whisper-small", "internvl2-76b"])
def test_param_counts_match_reference(name):
    """Every ported config's CONFIG and SMOKE as the reference has them,
    listed in configs.ARCHS, with the reference's parameter counts (the
    rec / mlstm / slstm terms and the encoder's included)."""
    assert tconfigs.canon(name) in tconfigs.ARCHS
    for get in ("get", "get_smoke"):
        t, r = getattr(tconfigs, get)(name), getattr(rconfigs, get)(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert t.param_count() == r.param_count()
        assert t.active_param_count() == r.active_param_count()


def test_unported_families_are_refused_by_name():
    cfg = dataclasses.replace(tconfigs.get_smoke("mixtral-8x7b"),
                              family="hybrid", pattern=("rec", "attn"))
    with pytest.raises(NotImplementedError, match="hybrid"):
        TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid"):
        TT.init_decode_state(cfg, 1, 4, device="cpu")


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_expert_stacks_quantize_per_layer_and_expert(bases, mode,
                                                     per_channel,
                                                     monkeypatch):
    """prequantize_weights on the (L, E, K, N) expert stacks: one scale
    (per column with per_channel) for every (layer, expert) slice,
    bit-equal to the reference's; layer(l).layer(e) is memoized and
    carries that slice's own fields; fuse_projections merges the shared
    expert's w_gate|w_up and leaves the stacks; a stack built for another
    mode falls back to the master weights with a warning."""
    cfg_r, cfg_t, pj, pt = bases["llama4-scout-17b-a16e"]
    rq = RQ(mode=mode, w_per_channel=per_channel)
    tq = TQ(mode=mode, w_per_channel=per_channel)
    r_m, t_m = r_preq(pj, rq)["units"][0]["moe"], \
        t_preq(pt, tq)["units"][0]["moe"]
    L, E = cfg_t.n_units, cfg_t.n_experts
    for name in ("w_gate", "w_up", "w_down"):
        rw, tw = r_m[name], t_m[name]
        assert tw.path == rw.path == f"units.0.moe.{name}"
        for f in ("q", "scale", "zp", "colsum"):
            a, b = getattr(tw, f), getattr(rw, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        lead = tuple(tw.scale.shape[:2])
        assert lead == (L, E)
        assert tw.scale.shape[2:] == ((1, tw.q.shape[-1]) if per_channel
                                      else (1, 1))
        sl = tw.layer(1).layer(E - 1)
        assert tw.layer(1).layer(E - 1) is sl
        assert torch.equal(sl.scale, tw.scale[1, E - 1])
        assert torch.equal(sl.q, tw.q[1, E - 1])
    fused = t_fuse(t_preq(pt, tq))["units"][0]["moe"]
    assert "w_gateup" in fused["shared"] and "w_gate" not in fused["shared"]
    assert {"w_gate", "w_up", "w_down", "router"} <= set(fused)
    other = TQ(mode="sym_i8" if mode == "asym_u8" else "asym_u8",
               inference=True)
    x = torch.randn((3, cfg_t.d_model), generator=torch.Generator()
                    .manual_seed(0))
    monkeypatch.setattr(tlin, "_STALE_WARNED", set())   # warned once a key
    with pytest.warns(UserWarning, match="requantizing"):
        got = tlin.qdot(x, t_m["w_up"].layer(0).layer(2), other)
    assert torch.equal(got, tlin.qdot(x, pt["units"][0]["moe"]["w_up"][0, 2],
                                      other))


# ---------------------------------------------------------------------------
# moe() alone
# ---------------------------------------------------------------------------

def _layer_moe(pj, pt, layer=0):
    return (jax.tree.map(lambda a: a[layer], pj["units"][0]["moe"]),
            TT.take_layer(pt["units"][0]["moe"], layer))


def _batch(cfg, router, overflow, seed=5):
    """(2, 8, D) rows; with ``overflow`` every row leans toward router
    column 0, so more tokens pick expert 0 than it has slots."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    if overflow:
        r0 = np.asarray(router)[:, 0]
        x += (4.0 * r0 / np.linalg.norm(r0) * np.sqrt(cfg.d_model)) \
            .astype(np.float32)
    return x


def _run_moe_both(cfg_r, cfg_t, pj_l, pt_l, x, mode, mp):
    """moe() of both packages on the same prequantized layer and input,
    recording every qdot call, the top-k choices and the port's
    dispatch.  Returns (reference, port) dicts."""
    rq = RQ(design="design2", backend="delta", mode=mode, inference=True)
    tq = TQ(design="design2", backend="delta", mode=mode, inference=True)
    kw = dict(n_experts=cfg_r.n_experts, top_k=cfg_r.top_k,
              kind=cfg_r.mlp_kind, shared=bool(cfg_r.shared_expert_ff))
    got = {"r": {}, "t": {}}
    real_top_k = jax.lax.top_k

    def r_top_k(probs, k):
        vals, idx = real_top_k(probs, k)
        got["r"].update(probs=np.asarray(probs), vals=np.asarray(vals),
                        idx=np.asarray(idx))
        return vals, idx
    real_sel, real_disp = tmoe.select_top_k, tmoe.dispatch

    def t_sel(probs, k):
        vals, idx = real_sel(probs, k)
        got["t"].update(probs=probs.numpy(), vals=vals.numpy(),
                        idx=idx.numpy())
        return vals, idx

    def t_disp(gate_idx, n, C):
        table, keep, slot = real_disp(gate_idx, n, C)
        got["t"].update(table=table.numpy(), keep=keep.numpy(), C=C)
        return table, keep, slot
    mp.setattr(jax.lax, "top_k", r_top_k)
    mp.setattr(tmoe, "select_top_k", t_sel)
    mp.setattr(tmoe, "dispatch", t_disp)
    with _observing(rlin, _Recorder()) as rec:
        y_r, aux_r = rmoe.moe(r_preq(pj_l, rq), jnp.asarray(x), rq, **kw)
    with _observing(tlin, _Recorder()) as rec_t, torch.no_grad():
        y_t, aux_t = tmoe.moe(t_preq(pt_l, tq), torch.from_numpy(x), tq, **kw)
    got["r"].update(y=np.asarray(y_r), aux=float(aux_r), calls=rec.calls)
    got["t"].update(y=y_t.numpy(), aux=float(aux_t), calls=rec_t.calls)
    return got["r"], got["t"]


def _table_from_rows(calls, xt, n_experts, site):
    """The reference's (E, C) dispatch table, read back from the rows
    each expert's first projection received (T for a zero row)."""
    T = xt.shape[0]
    rows = []
    for e in range(n_experts):
        xe = calls[f"{site}@{e}"][0][0]
        ids = []
        for row in xe:
            hit = np.flatnonzero((xt == row).all(1))
            ids.append(int(hit[0]) if hit.size else
                       (T if not row.any() else -1))
        rows.append(ids)
    return np.asarray(rows)


def _check_moe(cfg_r, r, t, x, expect_drops):
    T = x.shape[0] * x.shape[1]
    np.testing.assert_array_equal(t["idx"], r["idx"])
    np.testing.assert_allclose(t["vals"], r["vals"], rtol=1e-6, atol=0)
    C = tmoe.capacity(T, cfg_r.top_k, cfg_r.n_experts)
    assert t["C"] == C == max(int(T * cfg_r.top_k * 1.25 / cfg_r.n_experts),
                              4)
    site = "w_gate" if cfg_r.mlp_kind in ("geglu", "swiglu") else "w_up"
    table_r = _table_from_rows(r["calls"], x.reshape(T, -1),
                               cfg_r.n_experts, site)
    np.testing.assert_array_equal(t["table"], table_r)
    # keep: a choice is kept iff its token sits in its expert's row
    keep_r = np.array([[tok in table_r[e] for e in r["idx"][tok]]
                       for tok in range(T)])
    np.testing.assert_array_equal(t["keep"], keep_r)
    assert (not keep_r.all()) == expect_drops
    flips, total, dx = _count_flips(r["calls"], t["calls"], static=False)
    bound = Y_ATOL_REL * float(np.abs(r["y"]).max())
    gap = float(np.abs(t["y"] - r["y"]).max())
    print(f"\n{cfg_r.name}: C={C}, {int((~keep_r).sum())} choices dropped; "
          f"{flips} of {total} quantized steps flipped (max |dx| "
          f"{dx:.3e}); max |y_port - y_ref| {gap:.3e} (bound {bound:.3e}); "
          f"aux {t['aux']!r} vs {r['aux']!r}")
    assert flips == 0
    np.testing.assert_allclose(t["y"], r["y"], rtol=Y_RTOL, atol=bound)
    np.testing.assert_allclose(t["aux"], r["aux"], rtol=Y_RTOL)


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(bases, arch, mode, overflow):
    cfg_r, cfg_t, pj, pt = bases[arch]
    pj_l, pt_l = _layer_moe(pj, pt)
    x = _batch(cfg_r, pj_l["router"], overflow)
    with pytest.MonkeyPatch.context() as mp:
        r, t = _run_moe_both(cfg_r, cfg_t, pj_l, pt_l, x, mode, mp)
    _check_moe(cfg_r, r, t, x, expect_drops=overflow)


@pytest.mark.parametrize("kind", ["gelu", "geglu"])
def test_moe_gelu_experts_match_reference(kind):
    """The non-GLU branch (w_up then gelu) and the GLU-gelu one, on
    mixtral's smoke config with another mlp kind (no shared expert)."""
    cfg_r = dataclasses.replace(rconfigs.get_smoke("mixtral-8x7b"),
                                mlp_kind=kind)
    cfg_t = dataclasses.replace(tconfigs.get_smoke("mixtral-8x7b"),
                                mlp_kind=kind)
    pj = RT.init_params(jax.random.PRNGKey(1), cfg_r)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                   device="cpu")
    assert ("w_gate" in pt["units"][0]["moe"]) == (kind == "geglu")
    pj_l, pt_l = _layer_moe(pj, pt, 1)
    x = _batch(cfg_r, pj_l["router"], True, seed=6)
    with pytest.MonkeyPatch.context() as mp:
        r, t = _run_moe_both(cfg_r, cfg_t, pj_l, pt_l, x, "asym_u8", mp)
    _check_moe(cfg_r, r, t, x, expect_drops=True)


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32)   # many ties
    for k in (1, 2, 3):
        v_r, i_r = jax.lax.top_k(jnp.asarray(probs), k)
        v_t, i_t = tmoe.select_top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_tie_resolves_as_the_reference(bases, arch):
    """Router columns 1 and 2 equal, so their logits tie exactly on
    every token, and leaning the rows toward them makes them the top
    two: the first choice is expert 1 in both packages (and the second
    expert 2 for top-2)."""
    cfg_r, cfg_t, pj, pt = bases[arch]
    pj_l, pt_l = _layer_moe(pj, pt)
    router = np.asarray(pj_l["router"]).copy()
    v = router[:, 1] / np.linalg.norm(router[:, 1])
    router[:, 2] = router[:, 1]
    router[:, 0] = router[:, 3] = -router[:, 1]
    pj_l = dict(pj_l, router=jnp.asarray(router))
    pt_l = dict(pt_l, router=torch.from_numpy(router))
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(1, 6, cfg_r.d_model)) * 0.1
         + 3.0 * v).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        r, t = _run_moe_both(cfg_r, cfg_t, pj_l, pt_l, x, "asym_u8", mp)
    assert (r["probs"][:, 1] == r["probs"][:, 2]).all()
    assert (t["probs"][:, 1] == t["probs"][:, 2]).all()
    want = np.tile(np.array([1, 2])[:cfg_r.top_k], (6, 1))
    np.testing.assert_array_equal(r["idx"], want)
    np.testing.assert_array_equal(t["idx"], want)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class _RecordProducts:
    """Patch a module's approx_matmul to record its integer operands."""

    def __init__(self, module, to_np):
        self.module, self.to_np, self.calls = module, to_np, []

    def __enter__(self):
        self.orig = self.module.approx_matmul

        def rec(a, b, *args, **kw):
            self.calls.append((self.to_np(a), self.to_np(b)))
            return self.orig(a, b, *args, **kw)
        self.module.approx_matmul = rec
        return self

    def __exit__(self, *exc):
        self.module.approx_matmul = self.orig


def test_forward_train_matches_reference(bases):
    cfg_r, cfg_t, pj, pt = bases["mixtral-8x7b"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg_r.vocab, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rcfg = RQ(design="design2", backend="xla", mode="asym_u8")
    tcfg = TQ(design="design2", backend="xla", mode="asym_u8")
    with jax.disable_jit(), _RecordProducts(rops, np.asarray) as rrec:
        r_loss, r_met = RT.forward_train(
            pj, {k: jnp.asarray(v) for k, v in batch.items()}, cfg_r, rcfg)
    with _RecordProducts(tops, lambda t: t.numpy()) as trec:
        t_loss, t_met = TT.forward_train(
            pt, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg_t,
            tcfg)
    per_layer = 5 + 3 * cfg_t.n_experts
    assert len(trec.calls) == len(rrec.calls) == per_layer * cfg_t.n_layers
    flips = total = 0
    for (ra, rb), (ta, tb) in zip(rrec.calls, trec.calls):
        np.testing.assert_array_equal(tb, rb)
        flips += int((ta != ra).sum())
        total += ra.size
        got = tops.approx_matmul(torch.from_numpy(ta), torch.from_numpy(tb),
                                 "design2", "xla").numpy()
        want = np.asarray(rops.approx_matmul(jnp.asarray(ta),
                                             jnp.asarray(tb), "design2",
                                             "xla"))
        np.testing.assert_array_equal(got, want)
    print(f"\nmixtral forward_train: {flips} of {total} steps flipped; loss "
          f"{float(t_loss)!r} vs {float(r_loss)!r}; aux "
          f"{float(t_met['aux'])!r} vs {float(r_met['aux'])!r}")
    assert flips <= 1e-3 * total
    assert float(t_met["aux"]) > 0
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=2e-6)
    np.testing.assert_allclose(float(t_met["aux"]), float(r_met["aux"]),
                               rtol=2e-6)
