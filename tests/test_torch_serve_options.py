"""launch.serve's options against the JAX package's, at smoke size on
the reference's own weights (``T.init_params(PRNGKey(0), SMOKE)``
carried across with interop.params_from_numpy): per-channel weight
scales, per-slot cache positions and continuous batching, serve's
``--backend`` and the quantized unembed.

Where a run calibrates, the port serves from the reference's table (its
own calibration runs too, and is held to the reference's in
test_torch_serve.py): the two tables differ by float32 ulps, and a
static scale an ulp apart flips quantization steps that the random model
amplifies into other ids.

Tolerances: integers (quantized weights, scales, zero points, colsums,
greedy ids, plan JSON) are exact.  qdot outputs: rtol 1e-5 plus 1e-5 *
max|y| (the compensation sums are float32 sums in torch's order, not
XLA's: test_torch_quant.py); the 'residual' backends' correction is a
float32 sum of K * rank products in another order, so their outputs are
held to RESID_TOL * max|y| (kernels: RESID_REF_TOL 1e-6 on the product;
the dequant scales it).  Logits within LOGIT_TOL (as test_torch_serve.py:
a few float32 ulps of |logit| <= 1); caches bit-equal.  rmsnorm's two
forms within NORM_RTOL (four float32 ulps) of the reference's, elementwise.
With hand-set static scales, qdot inputs within X_RTOL of their largest
until the first quantization flip, which moves at most ROOT_FLIPS steps.

The reference's 'pallas', 'pallas_legacy' and 'residual' backends reach
Pallas kernels that do not build on this jax (ROADMAP section 3), so each
port backend is held against the reference counterpart that computes the
same function here (TWIN).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calib as rcalib
from repro import configs as rconfigs
from repro.calib import plan as rplan
from repro.launch import serve as rserve
from repro.models import layers as rlayers
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import linear as rlin
from repro.train import make_prefill_step as r_prefill
from repro.train import make_serve_step as r_step
from repro_torch import calib as tcalib
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.calib import plan as tplan
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import linear as tlin
from repro_torch.train import make_prefill_step as t_prefill
from repro_torch.train import make_serve_step as t_step

ARCH = "qwen3-1.7b"
MODES = ["asym_u8", "sym_i8"]
TWIN = {"xla": "xla", "pallas_legacy": "xla", "residual": "residual_xla",
        "residual_xla": "residual_xla", "pallas": "delta_xla",
        "delta": "delta_xla", "delta_xla": "delta_xla", "fused": "delta_xla",
        "exact": "exact"}
RESID_TOL = 1e-5
LOGIT_TOL = 2e-6
NORM_RTOL = 4 * 2.0 ** -23       # four float32 ulps of the value
X_RTOL = 1e-5                    # qdot inputs of the two packages
ROOT_FLIPS = 2                   # quantized steps the first flip moves


@pytest.fixture(scope="module")
def base():
    cfg_r = rconfigs.get_smoke(ARCH)
    pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    cfg_t = tconfigs.get_smoke(ARCH)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                   device="cpu")
    return cfg_r, cfg_t, pj, pt


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=tol * np.abs(want).max())


def _wrappers(tree, mod):
    found = {}

    def grab(node):
        found[node.path] = node
        return node
    mod.map_quantized(tree, grab)
    return found


# ---------------------------------------------------------------------------
# per-channel weight scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_per_channel_prequantize_is_bit_equal(base, mode):
    _, _, pj, pt = base
    wj = _wrappers(rlin.prequantize_weights(
        pj, RQ(mode=mode, w_per_channel=True)), rlin)
    wt = _wrappers(tlin.prequantize_weights(
        pt, TQ(mode=mode, w_per_channel=True)), tlin)
    assert sorted(wj) == sorted(wt) and len(wt) == 7
    for path, r in wj.items():
        t = wt[path]
        assert t.per_channel and r.per_channel
        L, _, N = t.w.shape
        assert tuple(t.scale.shape) == (L, 1, N)
        np.testing.assert_array_equal(t.q.to(torch.int32).numpy(),
                                      np.asarray(r.q), err_msg=path)
        for f in ("scale", "zp", "colsum"):
            a, b = getattr(t, f), getattr(r, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{path}.{f}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", sorted(TWIN))
def test_per_channel_qdot_matches_reference(base, mode, backend):
    """Dynamic (master weights) and prequantized per-channel qdot, every
    backend name against its reference counterpart."""
    _, _, pj, pt = base
    rq = RQ(mode=mode, backend=TWIN[backend], w_per_channel=True,
            inference=True)
    tq = TQ(mode=mode, backend=backend, w_per_channel=True, inference=True)
    tol = RESID_TOL if backend.startswith("residual") else 1e-5
    x = (np.random.default_rng(5).normal(size=(2, 3, 64)) * 1.3
         ).astype(np.float32)
    wj = pj["units"][0]["attn"]["wq"][1]
    wt = pt["units"][0]["attn"]["wq"][1]
    _close(tlin.qdot(torch.from_numpy(x), wt, tq),
           rlin.qdot(jnp.asarray(x), wj, rq), tol)
    pre_j = _wrappers(rlin.prequantize_weights(pj, rq), rlin)
    pre_t = _wrappers(tlin.prequantize_weights(pt, tq), tlin)
    xd = np.random.default_rng(6).normal(size=(2, 1, 192)).astype(np.float32)
    for layer in (0, 1):
        _close(tlin.qdot(torch.from_numpy(xd),
                         pre_t["units.0.mlp.w_down"].layer(layer), tq),
               rlin.qdot(jnp.asarray(xd), jax.tree.map(
                   lambda a: a[layer], pre_j["units.0.mlp.w_down"]), rq),
               tol)


@pytest.mark.parametrize("mode", MODES)
def test_per_channel_members_merge(base, mode):
    """fuse_projections merges per-channel members (7 qdot calls a layer
    become 4), with the reference's fields, and the merged output equals
    the members' per column."""
    _, _, pj, pt = base
    rq = RQ(mode=mode, backend="delta", w_per_channel=True, inference=True)
    tq = TQ(mode=mode, backend="delta", w_per_channel=True, inference=True)
    sj = rlin.fuse_projections(rlin.prequantize_weights(pj, rq))
    st = tlin.fuse_projections(tlin.prequantize_weights(pt, tq))
    wj, wt = _wrappers(sj, rlin), _wrappers(st, tlin)
    assert sorted(wt) == sorted(wj) == [
        "units.0.attn.wo", "units.0.attn.wqkv", "units.0.mlp.w_down",
        "units.0.mlp.w_gateup"]
    for path, r in wj.items():
        t = wt[path]
        assert t.merged == r.merged and t.per_channel == r.per_channel
        for f in ("q", "scale", "zp", "colsum"):
            a, b = getattr(t, f), getattr(r, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(
                    a.to(torch.int32 if f == "q" else a.dtype).numpy(),
                    np.asarray(b), err_msg=f"{path}.{f}")
    unmerged = _wrappers(tlin.prequantize_weights(pt, tq), tlin)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 1, 64)).astype(np.float32))
    y = tlin.qdot(x, wt["units.0.attn.wqkv"].layer(1), tq)
    parts = [tlin.qdot(x, unmerged[f"units.0.attn.{n}"].layer(1), tq)
             for n in ("wq", "wk", "wv")]
    assert torch.equal(y, torch.cat(parts, -1))


@pytest.mark.parametrize("mode", MODES)
def test_stale_per_channel_cache_warns_and_requantizes(base, mode,
                                                       recwarn):
    """A per-tensor cache used under w_per_channel (and the reverse) is
    stale: both packages warn and requantize the master weights per
    channel; merged wrappers carry per-column scales whatever the config
    says and are not stale."""
    _, _, pj, pt = base
    x = np.random.default_rng(8).normal(size=(2, 1, 64)).astype(np.float32)
    for built, used in ((False, True), (True, False)):
        rq = RQ(mode=mode, backend="delta_xla", w_per_channel=used,
                inference=True)
        tq = TQ(mode=mode, backend="delta", w_per_channel=used,
                inference=True)
        pre_j = _wrappers(rlin.prequantize_weights(
            pj, dataclasses.replace(rq, w_per_channel=built)), rlin)
        pre_t = _wrappers(tlin.prequantize_weights(
            pt, dataclasses.replace(tq, w_per_channel=built)), tlin)
        rlin._STALE_WARNED.clear()
        tlin._STALE_WARNED.clear()
        with pytest.warns(UserWarning, match="per_channel") as rec:
            yt = tlin.qdot(torch.from_numpy(x),
                           pre_t["units.0.attn.wq"].layer(0), tq)
            yj = rlin.qdot(jnp.asarray(x), jax.tree.map(
                lambda a: a[0], pre_j["units.0.attn.wq"]), rq)
        assert sum("prequantize_weights" in str(w.message)
                   for w in rec) == 2
        _close(yt, yj)
        fresh = tlin.qdot(torch.from_numpy(x),
                          pt["units"][0]["attn"]["wq"][0], tq)
        assert torch.equal(yt, fresh)
    merged = tlin.fuse_projections(tlin.prequantize_weights(
        pt, TQ(mode=mode)))
    tlin._STALE_WARNED.clear()
    recwarn.clear()
    tlin.qdot(torch.from_numpy(x),
              _wrappers(merged, tlin)["units.0.attn.wqkv"].layer(0),
              TQ(mode=mode, backend="delta", inference=True))
    assert not [w for w in recwarn if "per_channel" in str(w.message)]


@pytest.mark.parametrize("mode", ["sym_i8"])
def test_plan_cli_per_channel_matches_reference(base, mode, tmp_path,
                                                monkeypatch):
    """python -m repro_torch.calib --per-channel: the reference's plan
    JSON exactly (on the reference's params); per-channel scales move
    this smoke model's plan, so the option is not a no-op here."""
    _, _, pj, _ = base
    monkeypatch.setattr(TT, "init_params", _ref_params(pj))
    argv = ["--smoke", "--batches", "1", "--quant-mode", mode,
            "--per-channel", "--no-recompose16"]
    want = rplan.main(argv + ["--out", str(tmp_path / "r.json")])
    got = tplan.main(argv + ["--out", str(tmp_path / "t.json"),
                             "--device", "cpu"])
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    tensor = tplan.main(argv[:-2] + ["--no-recompose16", "--out",
                                     str(tmp_path / "p.json"), "--device",
                                     "cpu"])
    assert json.dumps(tensor.to_json()) != json.dumps(got.to_json())


# ---------------------------------------------------------------------------
# per-slot cache positions
# ---------------------------------------------------------------------------

def test_init_decode_state_per_slot_shapes(base):
    cfg_r, cfg_t, _, _ = base
    for per_slot in (False, True):
        sr = RT.init_decode_state(cfg_r, 3, 11, per_slot=per_slot)
        st = TT.init_decode_state(cfg_t, 3, 11, device="cpu",
                                  per_slot=per_slot)
        for k in ("k", "v", "idx"):
            want = np.asarray(sr["caches"][0][k])
            got = st["caches"][0][k]
            assert tuple(got.shape) == want.shape, (per_slot, k)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), k
            assert not got.float().abs().sum()
    assert tuple(st["caches"][0]["idx"].shape) == (cfg_t.n_units, 3)


@pytest.mark.parametrize("shape", [(4, 1, 2048), (4, 64, 2048),
                                   (2, 5, 16, 128)])
def test_rmsnorm_forms_match_reference(shape):
    """layers.rmsnorm's two forms, run here on the CPU: the float32
    composite (the CPU's) and torch's fused rms_norm (the card's,
    layers.rmsnorm_fused), each elementwise within NORM_RTOL of the
    reference's rmsnorm (XLA's rsqrt and torch's round differently)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(
        0.1, 30, shape[:-1] + (1,))).astype(np.float32)
    g = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    want = np.asarray(rlayers.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    for form in (tlayers.rmsnorm, tlayers.rmsnorm_fused):
        got = form(torch.from_numpy(x), torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got, want, rtol=NORM_RTOL, atol=0,
                                   err_msg=form.__name__)


@pytest.fixture(scope="module")
def calibrated(base):
    """Per mode, both packages' calibrated serving trees (fused, merged),
    as serve --calibrate installs them, from one calibration table: the
    port's (the reference's own token-by-token calibration costs some 15 s
    a mode here; the two tables are held together in
    test_torch_serve.py), read by both through its JSON."""
    cfg_r, _, pj, pt = base
    trees = {}
    for mode in MODES:
        rq = RQ(design="design2", backend="fused", mode=mode,
                inference=True)
        tq = TQ(design="design2", backend="fused", mode=mode,
                inference=True)
        sj, st = rlin.prequantize_weights(pj, rq), \
            tlin.prequantize_weights(pt, tq)
        cal = np.random.default_rng(4242).integers(
            0, cfg_r.vocab, (2, 5)).astype(np.int32)
        tab_t = tcalib.calibrate_decode(st, cfg_r, tq, cal, gen_len=2,
                                        device="cpu")
        table = rcalib.CalibrationTable.from_json(tab_t.to_json())
        sj = rlin.fuse_projections(rcalib.attach_comp_cols(
            rcalib.apply_calibration(sj, table), rq))
        st = tlin.fuse_projections(tcalib.attach_comp_cols(
            tcalib.apply_calibration(st, tab_t), tq))
        trees[mode] = sj, st, rq, tq
    return trees


def _slots_inputs(cfg):
    """Two prompts of 3 and 6 tokens, a (2, 2) chunk and s_max 12."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
               for n in (3, 6)]
    return prompts, rng.integers(0, cfg.vocab, (2, 2)).astype(np.int32), 12


def _slots_reference(cfg, tree, q, jit=True):
    """The per-slot run on the reference: each prompt prefilled alone and
    scattered into its slot, the chunk through the generic S > 1 path,
    two decode steps.  Returns (ids, logits of the three calls, state)."""
    prompts, chunk, s_max = _slots_inputs(cfg)
    pf, step = r_prefill(cfg, q), r_step(cfg, q)
    if jit:
        pf, step = jax.jit(pf), jax.jit(step)
    sr = RT.init_decode_state(cfg, 2, s_max, per_slot=True)
    for slot, pr in enumerate(prompts):
        one = RT.init_decode_state(cfg, 1, s_max, per_slot=True)
        _, _, one = pf(tree, one, jnp.asarray(pr))
        sr = rserve._scatter_slot(sr, one, slot)
    tok, lg, sr = pf(tree, sr, jnp.asarray(chunk))
    lgs = [np.asarray(lg)]
    for _ in range(2):
        tok, lg, sr = step(tree, sr, tok)
        lgs.append(np.asarray(lg))
    return np.asarray(tok), lgs, sr


def _slots_port(cfg, tree, q):
    """The same run on the port (serve._scatter_slot writes in place)."""
    prompts, chunk, s_max = _slots_inputs(cfg)
    pf, step = t_prefill(cfg, q), t_step(cfg, q)
    with torch.no_grad():
        s2 = TT.init_decode_state(cfg, 2, s_max, device="cpu",
                                  per_slot=True)
        for slot, pr in enumerate(prompts):
            one = TT.init_decode_state(cfg, 1, s_max, device="cpu",
                                       per_slot=True)
            _, _, one = pf(tree, one, torch.from_numpy(pr))
            tserve._scatter_slot(s2, one, slot)
        assert s2["caches"][0]["idx"][:, 0].tolist() == [3] * cfg.n_units
        assert s2["caches"][0]["idx"][:, 1].tolist() == [6] * cfg.n_units
        tok, lg, s2 = pf(tree, s2, torch.from_numpy(chunk))
        lgs = [lg.numpy()]
        for _ in range(2):
            tok, lg, s2 = step(tree, s2, tok)
            lgs.append(lg.numpy())
    return tok.numpy(), lgs, s2


@pytest.mark.parametrize("mode", MODES)
def test_slots_at_different_depths_match_reference(base, calibrated, mode):
    """Two slots prefilled alone with prompts of 3 and 6 tokens and
    scattered into one per-slot state (serve._scatter_slot), then a
    2-token chunk through the generic S > 1 path with the batch-varying
    mask, then two decode steps (the attention kernel's per-slot
    positions): caches and idx bit-equal, logits within LOGIT_TOL."""
    cfg_r, cfg_t, _, _ = base
    sj, st, rq, tq = calibrated[mode]
    toks_r, lgs_r, sr = _slots_reference(cfg_r, sj, rq)
    toks_t, lgs_t, s2 = _slots_port(cfg_t, st, tq)
    np.testing.assert_array_equal(toks_t, toks_r)
    gap = max(float(np.abs(a - b).max()) for a, b in zip(lgs_t, lgs_r))
    print(f"\n[{mode}] per-slot logits: max |port - reference| = {gap:.3e}")
    for a, b in zip(lgs_t, lgs_r):
        np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(s2["caches"][0]["idx"].numpy(),
                                  np.asarray(sr["caches"][0]["idx"]))
    assert s2["caches"][0]["idx"][0].tolist() == [7, 10]
    for k in ("k", "v"):
        np.testing.assert_array_equal(
            s2["caches"][0][k].float().numpy(),
            np.asarray(jnp.asarray(sr["caches"][0][k], jnp.float32)))


class _Calls:
    """A qdot observer for either package: every call's site, activations
    and static quantizer, in the order the calls ran."""

    unroll = True            # the reference's pscan unrolls under it

    def __init__(self):
        self._idx, self.calls = [], []

    def push(self, i):
        self._idx.append(i)

    def pop(self):
        self._idx.pop()

    def record(self, x, pre, cfg):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        sx = np.asarray(pre.act_scale, np.float32).reshape(())
        zx = (np.asarray(pre.act_zp, np.float32).reshape(())
              if pre.act_zp is not None else np.float32(0.0))
        lo, hi = (-128, 127) if cfg.signed else (0, 255)
        self.calls.append((pre.path + "@" + ".".join(map(str, self._idx)),
                           x, np.clip(np.round(x / sx) + zx, lo, hi)))


@pytest.mark.parametrize("mode", MODES)
def test_slots_hand_set_scales_differ_only_by_flips(base, mode):
    """The per-slot run above on trees with hand-set static scales (0.031
    and 0.027, one a layer, as test_torch_quant.py sets them) in place of
    calibrated ones, both packages run eagerly with every qdot call
    recorded in order.  Up to the first call whose quantized activations
    differ, every call's activations agree within X_RTOL of their largest;
    at that call they agree likewise and at most ROOT_FLIPS entries
    differ, each by one step: values a float32 ulp apart on either side
    of a rounding edge, a quantization flip, not a per-slot fault.  (sym_i8 has one: the second decode step's layer-1 wqkv input,
    one float32 ulp from the reference's and 4e-6 of a step from the
    edge, which moves that layer's k/v rows by bf16 steps and the logits
    by 0.04; asym_u8 flips nothing.)  The flips are counted and
    printed."""
    _, _, pj, pt = base
    cfg_r, cfg_t = base[0], base[1]
    sx = np.array([0.031, 0.027], np.float32)
    zx = (np.array([127.0, 131.0], np.float32) if mode == "asym_u8"
          else None)
    trees = []
    for lin, calib, p, Q, arr in (
            (rlin, rcalib, pj, RQ, jnp.asarray),
            (tlin, tcalib, pt, TQ, torch.from_numpy)):
        q = Q(mode=mode, backend="fused", inference=True)
        tree = lin.map_quantized(lin.prequantize_weights(p, q), lambda n:
                                 n.replace(act_scale=arr(sx),
                                           act_zp=None if zx is None
                                           else arr(zx)))
        trees.append((lin.fuse_projections(calib.attach_comp_cols(tree, q)),
                      q))
    rec_r, rec_t = _Calls(), _Calls()
    rlin.set_observer(rec_r)
    try:
        _slots_reference(cfg_r, *trees[0], jit=False)
    finally:
        rlin.set_observer(None)
    tlin.set_observer(rec_t)
    try:
        _slots_port(cfg_t, *trees[1])
    finally:
        tlin.set_observer(None)
    assert [c[0] for c in rec_t.calls] == [c[0] for c in rec_r.calls]
    flips = [int((ct[2] != cr[2]).sum())
             for cr, ct in zip(rec_r.calls, rec_t.calls)]
    root = next((i for i, n in enumerate(flips) if n), len(flips))
    for (site, xr, qr), (_, xt, qt) in zip(rec_r.calls[:root + 1],
                                           rec_t.calls[:root + 1]):
        assert np.abs(xt - xr).max() <= X_RTOL * np.abs(xr).max(), site
    if root < len(flips):
        site, xr, qr = rec_r.calls[root]
        xt, qt = rec_t.calls[root][1:]
        assert flips[root] <= ROOT_FLIPS, (site, flips[root])
        moved = qt != qr
        assert (np.abs(qt - qr)[moved] == 1).all(), site
    print(f"\n[{mode}] hand-set scales: first flip at call {root} of "
          f"{len(flips)} ({rec_r.calls[root][0] if root < len(flips) else '-'}"
          f"); {sum(flips)} of {sum(c[1].size for c in rec_r.calls)} "
          f"quantized activations flipped in all")


# ---------------------------------------------------------------------------
# launch.serve: --continuous, --backend, --per-channel
# ---------------------------------------------------------------------------

def _ref_params(pj):
    """A stand-in for the port's init_params that returns the reference's
    params (converted afresh on every call)."""
    def init(generator, cfg, device="cuda"):
        return interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg,
                                         device="cpu")
    return init


def _serve_both(base, monkeypatch, argv):
    """serve.main of both packages with the same arguments: the port on
    the reference's params and, where it calibrates, serving from the
    reference's tables (its own calibration runs beside them).  Returns
    (reference ids, port ids)."""
    tables, served = [], []
    real_r, real_t = rcalib.calibrate_decode, tcalib.calibrate_decode

    def record(*a, **k):
        tables.append(real_r(*a, **k))
        return tables[-1]

    def reference_table(*a, **k):
        real_t(*a, **k)
        served.append(interop.table_from_json(json.dumps(
            tables[len(served) % len(tables)].to_json())))
        return served[-1]

    monkeypatch.setattr(rcalib, "calibrate_decode", record)
    ids_r, _ = rserve.main(argv)
    monkeypatch.setattr(tcalib, "calibrate_decode", reference_table)
    monkeypatch.setattr(TT, "init_params", _ref_params(base[2]))
    ids_t, logits = tserve.main(argv + ["--device", "cpu"])
    assert len(served) == len(tables)
    assert np.isfinite(logits).all()
    return ids_r, ids_t


def test_continuous_matches_reference_and_isolated_replays(base,
                                                           monkeypatch):
    """--continuous 5 over 2 slots: the reference's ids, and each request
    equal to itself served alone (a B = 1 prefill and decode steps on the
    tree serve ran, the reference's own property)."""
    cfg_r, cfg_t, pj, _ = base
    argv = ["--arch", ARCH, "--smoke", "--requests", "2", "--prompt-len",
            "4", "--gen-len", "5", "--calibrate", "1", "--continuous", "5"]
    ids_r, ids_t = _serve_both(base, monkeypatch, argv)
    assert ids_t.shape == (5, 5)
    np.testing.assert_array_equal(ids_t, ids_r)
    args = tserve.build_parser().parse_args(argv + ["--device", "cpu"])
    prep = tserve.prepare(args)
    assert prep.qcfg.backend == "fused"
    prompts = np.random.default_rng(0).integers(
        0, cfg_t.vocab, (5, 4)).astype(np.int32)
    pf, step = t_prefill(cfg_t, prep.qcfg), t_step(cfg_t, prep.qcfg)
    with torch.no_grad():
        for r in range(5):
            st = TT.init_decode_state(cfg_t, 1, 4 + 2 * 5 + 2, device="cpu",
                                      per_slot=True)
            tok, _, st = pf(prep.params, st, torch.from_numpy(
                prompts[r:r + 1]))
            got = [int(tok[0, 0])]
            for _ in range(4):
                tok, _, st = step(prep.params, st, tok)
                got.append(int(tok[0, 0]))
            np.testing.assert_array_equal(ids_t[r], got, err_msg=f"req {r}")
    res = tserve.run(args, prep)
    assert isinstance(res, tserve.ContinuousResult)
    assert res.slots == 2 and res.steps > 0
    np.testing.assert_array_equal(res.out, ids_t)


def test_backend_default_is_the_references():
    parse = tserve.build_parser().parse_args
    assert tserve.quant_config(parse([])).backend == "xla"
    assert tserve.quant_config(parse(["--calibrate", "1"])).backend == \
        "fused"
    assert tserve.quant_config(parse(["--plan", "p.json"])).backend == \
        "fused"
    assert tserve.quant_config(parse(["--backend", "residual",
                                      "--calibrate", "1"])).backend == \
        "residual"
    q = tserve.quant_config(parse(["--per-channel"]))
    assert q.w_per_channel and q.inference and not q.quant_unembed


_REF_IDS: dict = {}


@pytest.mark.parametrize("mode", ["asym_u8"])
@pytest.mark.parametrize("backend", sorted(TWIN))
def test_serve_backend_matches_reference(base, monkeypatch, mode, backend):
    """serve --backend X (uncalibrated: every projection through the
    backend's product) gives the ids of the reference's counterpart, in
    serve's default mode (sym_i8 through each backend is held at the
    qdot level above)."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "2", "--prompt-len",
            "3", "--gen-len", "4", "--quant-mode", mode, "--backend"]
    key = (TWIN[backend], mode)
    if key not in _REF_IDS:
        _REF_IDS[key], _ = rserve.main(argv + [TWIN[backend]])
    monkeypatch.setattr(TT, "init_params", _ref_params(base[2]))
    ids_t, logits = tserve.main(argv + [backend, "--device", "cpu"])
    assert np.isfinite(logits).all()
    np.testing.assert_array_equal(ids_t, _REF_IDS[key])


@pytest.mark.parametrize("mode", MODES)
def test_per_channel_fused_qdot_matches_reference(base, mode):
    """Per-channel wrappers with static activation scales on the fused
    backend, merged: the fused kernel's plain version reads the per-column
    sw / zw rows, as the reference's twin does (serve --per-channel
    --calibrate)."""
    _, _, pj, pt = base
    rq = RQ(mode=mode, backend="fused", w_per_channel=True, inference=True)
    tq = TQ(mode=mode, backend="fused", w_per_channel=True, inference=True)
    sx = np.array([0.031, 0.027], np.float32)
    zx = (np.array([127.0, 131.0], np.float32) if mode == "asym_u8"
          else None)
    sj = rlin.map_quantized(rlin.prequantize_weights(pj, rq), lambda n:
                            n.replace(act_scale=jnp.asarray(sx),
                                      act_zp=None if zx is None
                                      else jnp.asarray(zx)))
    st = tlin.map_quantized(tlin.prequantize_weights(pt, tq), lambda n:
                            n.replace(act_scale=torch.from_numpy(sx),
                                      act_zp=None if zx is None
                                      else torch.from_numpy(zx)))
    sj = rlin.fuse_projections(rcalib.attach_comp_cols(sj, rq))
    st = tlin.fuse_projections(tcalib.attach_comp_cols(st, tq))
    wj, wt = _wrappers(sj, rlin), _wrappers(st, tlin)
    x = (np.random.default_rng(9).normal(size=(2, 3, 64)) * 1.3
         ).astype(np.float32)
    for name in ("units.0.attn.wqkv", "units.0.mlp.w_gateup"):
        assert wt[name].per_channel and wt[name].merged
        for layer in (0, 1):
            _close(tlin.qdot(torch.from_numpy(x), wt[name].layer(layer), tq),
                   rlin.qdot(jnp.asarray(x), jax.tree.map(
                       lambda a: a[layer], wj[name]), rq))


# ---------------------------------------------------------------------------
# the quantized unembed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_quant_unembed_matches_reference(base, mode):
    """QuantConfig(quant_unembed=True): the tied head through qdot (the
    table quantized dynamically on every call; per position at prefill).
    Logits of a prefill and a decode step, and forward_train's loss."""
    cfg_r, cfg_t, pj, pt = base
    rq = RQ(mode=mode, backend="delta_xla", quant_unembed=True,
            inference=True)
    tq = TQ(mode=mode, backend="delta", quant_unembed=True, inference=True)
    sj, st = rlin.prequantize_weights(pj, rq), tlin.prequantize_weights(
        pt, tq)
    prompts = np.random.default_rng(12).integers(
        0, cfg_r.vocab, (2, 4)).astype(np.int32)
    rs = RT.init_decode_state(cfg_r, 2, 6)
    tok, lg_pr, rs = jax.jit(r_prefill(cfg_r, rq))(sj, rs,
                                                   jnp.asarray(prompts))
    _, lg_dr, _ = jax.jit(r_step(cfg_r, rq))(sj, rs, tok)
    with torch.no_grad():
        ts = TT.init_decode_state(cfg_t, 2, 6, device="cpu")
        tok_t, lg_pt, ts = t_prefill(cfg_t, tq)(st, ts,
                                                torch.from_numpy(prompts))
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok))
        _, lg_dt, _ = t_step(cfg_t, tq)(st, ts, tok_t)
    exact = TQ(mode=mode, backend="delta", inference=True)
    with torch.no_grad():
        ts = TT.init_decode_state(cfg_t, 2, 6, device="cpu")
        _, lg_x, _ = t_prefill(cfg_t, exact)(st, ts,
                                             torch.from_numpy(prompts))
    assert not torch.equal(lg_x, lg_pt)      # the head is quantized
    for got, want in ((lg_pt, lg_pr), (lg_dt, lg_dr)):
        _close(got, want)
    batch = rconfigs.make_smoke_batch(cfg_r, 2, 8, seed=3)
    rq_t = dataclasses.replace(rq, inference=False)
    tq_t = dataclasses.replace(tq, inference=False)
    loss_r = jax.jit(lambda p, b: RT.forward_train(p, b, cfg_r, rq_t)[0])(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, _ = TT.forward_train(pt, {k: torch.from_numpy(np.asarray(v))
                                      for k, v in batch.items()}, cfg_t,
                                 tq_t)
    print(f"\n[{mode}] quantized unembed: loss {float(loss_t)!r} vs "
          f"{float(loss_r)!r}")
    np.testing.assert_allclose(float(loss_t), float(loss_r), rtol=1e-6)
