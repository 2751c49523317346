"""The plan slice: per-layer design plans in the port against the JAX
package's, at smoke size unless stated, on the reference's own weights
(``init_params(PRNGKey(0), ...)`` carried across with interop).

  * The biased delta table (the unsigned 'initial' on the card's
    kernels): ops.narrow_delta round-trips every registered design's
    table exactly, and the products on (bits, unsigned, bias) equal those
    on the int32 table over the exhaustive 65,536-pair sweep (exact).
  * The search: the port's plan_designs on the reference's
    CalibrationTable (through its JSON) gives the reference's plan JSON
    exactly, recompose16 frontier included (numpy float64 on bit-equal
    tables on both sides).
  * Train-shaped calibration: the port's calibrate has the reference's
    site keys, counts and weight histograms; activation histogram bins
    that differ are counted (measured 0) and held to 0.1% of the counts.
  * The install and serve: a plan over the reference's calibration table
    is served calibrated through both packages (prefill + greedy
    decode).  Greedy ids equal, every cache leaf within check.check_rows
    (one bf16 step on at most 1% of entries; measured 0 apart), logits
    within atol 2e-6 (as test_torch_serve), the planned colsums of the
    column compensation bit-equal, and the static quantization steps
    that flip counted (measured 0) and held to 0.1%.  Cases: the
    committed smoke plan (sym_i8, 14 sites), a heterogeneous plan
    (design1 on layer 0, design2 on layer 1: a two-table bank, members
    merged) in both modes, and a plan whose merged members disagree on
    layer 0 (not merged, in both packages).
  * QAT through make_plan_injector, 2 steps against the reference run
    op by op: the bounds of test_torch_train.py's
    test_train_step_matches_reference_op_by_op (loss rtol 2e-6,
    grad_norm 1e-4, first moment 1e-4 and update 1e-3 relative in norm,
    0 flipped activation steps).
  * Full-width shapes on the CPU: qwen3-1.7b's widths (K = 2048/6144,
    head_dim 128) at 1 layer and a 512-entry vocab, calibrated and served
    through both packages in both modes: tables, compensation colsums,
    greedy ids, caches and flips held as at smoke size, against the
    reference run op by op (its jitted asym_u8 serve differs from its own
    op-by-op run at these widths; reported, see the test).
"""
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calib as rcalib
from repro import configs as rconfigs
from repro import data as rdata
from repro.calib import plan as rplan
from repro.core import lut as rlut
from repro.kernels import ref as rref
from repro.models import transformer as RT
from repro.quant import QuantConfig as RQ
from repro.quant import fuse_projections as r_fuse
from repro.quant import linear as rlin
from repro.quant import prequantize_weights as r_preq
from repro.train import OptConfig as ROC
from repro.train import make_prefill_step as r_prefill
from repro.train import make_serve_step as r_step
from repro.train import make_train_step as r_train_step
from repro.train import optimizer as ropt
from repro_torch import calib as tcalib
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.calib import plan as tplan
from repro_torch.core import lut as tlut
from repro_torch.core import multipliers as tmult
from repro_torch.kernels import check
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as TT
from repro_torch.quant import QuantConfig as TQ
from repro_torch.quant import fuse_projections as t_fuse
from repro_torch.quant import linear as tlin
from repro_torch.quant import prequantize_weights as t_preq
from repro_torch.signed import SIGNED_MULTIPLIERS
from repro_torch.train import OptConfig as TOC
from repro_torch.train import make_prefill_step as t_prefill
from repro_torch.train import make_serve_step as t_step
from repro_torch.train import make_train_step as t_train_step
from repro_torch.train import optimizer as topt

ARCH = "qwen3-1.7b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_PLAN = os.path.join(ROOT, "experiments",
                              "design_plan_qwen3-1.7b.json")
B, P, GEN = 2, 5, 4
MODES = ["asym_u8", "sym_i8"]
FLIP_SHARE = 1e-3


# ---------------------------------------------------------------------------
# step 0: the biased 16-bit delta table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,signed",
                         [(n, False) for n in tmult.MULTIPLIERS]
                         + [(n, True) for n in SIGNED_MULTIPLIERS])
def test_narrow_delta_round_trip_is_exact(name, signed):
    d = tlut.build_delta_lut(name, signed)
    bits, unsigned, bias = tops.narrow_delta(d)
    assert bits.dtype == torch.int16 and tuple(bits.shape) == (256, 256)
    back = tops.widen_delta(bits, unsigned, bias).numpy().astype(np.int64)
    np.testing.assert_array_equal(back, d.astype(np.int64))
    if d.dtype == np.int16:
        assert (unsigned, bias) == (False, 0)
    else:
        # only the unsigned 'initial' needs the bias: D in [-48744, 0]
        assert (name, signed) == ("initial", False)
        assert unsigned and bias == 48744 == -int(d.min())
        assert int((bits.to(torch.int32) & 0xFFFF).max()) == 48744


def test_narrow_delta_refuses_a_table_wider_than_16_bits():
    bad = np.zeros((256, 256), np.int32)
    bad[0, 0], bad[1, 1] = -40000, 40000
    with pytest.raises(ValueError, match="16"):
        tops.narrow_delta(bad)


def _exhaustive(signed):
    v = np.arange(-128, 128) if signed else np.arange(256)
    return (torch.from_numpy(v.astype(np.int32))[:, None].contiguous(),
            torch.from_numpy(v.astype(np.int32))[None, :].contiguous())


@pytest.mark.parametrize("design", ["initial", "design2"])
def test_biased_table_products_equal_the_int32_tables(design):
    """delta_matmul on (bits, unsigned, bias) against the plain product
    on the int32 table: the 65,536-pair sweep, and a K = 77 product whose
    K * bias subtraction is exercised; fused_qdot the same way."""
    d32 = torch.from_numpy(rlut.build_delta_lut(design, False)
                           .astype(np.int32))
    bits, unsigned, bias = tops.delta_table(design, False, "cpu")
    assert (unsigned, bias) == ((True, 48744) if design == "initial"
                                else (False, 0))
    a, b = _exhaustive(False)
    got = tops.delta_matmul(a, b, bits, unsigned=unsigned, bias=bias)
    want = tref.delta_matmul_ref(a, b, d32)
    assert torch.equal(got, want)
    # the sweep is the design's product table itself
    np.testing.assert_array_equal(got.numpy(), rlut.build_lut(design))
    case = check.delta_case(3, 77, 40, False, 7, "cpu", design=design)
    assert torch.equal(tops.delta_matmul(**case),
                       tref.delta_matmul_ref(case["a"], case["b"], d32))
    f = check.fused_case(3, 77, 40, False, 8, "cpu", design=design)
    got = tops.fused_qdot_packed(**f, return_int=True)
    want = tref.fused_qdot_ref(f["x"], f["qw"], d32, f["scal"], f["ntab"],
                               f["comp_r"], 0, True, True, return_int=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_uncalibrated_initial_serve_runs_on_the_biased_table():
    """serve --design initial --quant-mode asym_u8 (the uncalibrated
    'delta' backend) through the narrowed table: the CPU's own path, as
    the card's takes the same table."""
    args = tserve.build_parser().parse_args(
        ["--smoke", "--requests", "2", "--prompt-len", "3", "--gen-len",
         "3", "--design", "initial", "--quant-mode", "asym_u8",
         "--device", "cpu"])
    r = tserve.run(args)
    assert r.out.shape == (2, 3) and np.isfinite(r.logits).all()


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg_r = rconfigs.get_smoke(ARCH)
    pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj),
                                   tconfigs.get_smoke(ARCH), device="cpu")
    return cfg_r, tconfigs.get_smoke(ARCH), pj, pt


def _batches_np(cfg, n=2):
    return [rconfigs.make_smoke_batch(cfg, 2, 16, seed=i) for i in range(n)]


@pytest.fixture(scope="module", params=MODES)
def calibrated(request, smoke):
    """Both packages' train-shaped calibration tables, one mode."""
    mode = request.param
    cfg_r, cfg_t, pj, pt = smoke
    rq = RQ(design="design2", backend="xla", mode=mode)
    tq = TQ(design="design2", backend="xla", mode=mode)
    table_r = rcalib.calibrate(r_preq(pj, rq), cfg_r, rq, _batches_np(cfg_r))
    table_t = tcalib.calibrate(t_preq(pt, tq), cfg_t, tq, _batches_np(cfg_r),
                               device="cpu")
    return mode, rq, tq, table_r, table_t


def test_make_smoke_batch_matches_reference():
    for seed in (0, 3):
        want = rconfigs.make_smoke_batch(rconfigs.get_smoke(ARCH), 2, 16,
                                         seed=seed)
        got = tconfigs.make_smoke_batch(tconfigs.get_smoke(ARCH), 2, 16,
                                        seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_calibrate_matches_reference(calibrated):
    mode, _, _, table_r, table_t = calibrated
    assert table_t.mode == table_r.mode == mode
    assert sorted(table_t.sites) == sorted(table_r.sites)
    assert len(table_t.sites) == 14 and "units.0.mlp.w_down@1" in \
        table_t.sites
    moved = total = 0
    rel = 0.0
    for k, r in table_r.sites.items():
        t = table_t.sites[k]
        assert t["count"] == r["count"]
        np.testing.assert_array_equal(t["hist_w"], r["hist_w"])
        moved += int(np.abs(np.asarray(t["hist_x"])
                            - np.asarray(r["hist_x"])).sum()) // 2
        total += int(r["count"])
        for f in ("lo", "hi", "amax"):
            rel = max(rel, abs(t[f] - r[f]) / max(abs(r[f]), 1e-30))
    print(f"\n[{mode}] train-shaped calibration: {moved} of {total} "
          f"activation counts in another histogram bin; lo/hi/amax within "
          f"{rel:.3e} relative")
    assert moved <= FLIP_SHARE * total
    assert rel <= 1e-4


def test_plan_designs_matches_reference_json(calibrated):
    mode, rq, tq, table_r, _ = calibrated
    text = json.dumps(table_r.to_json())
    want = rplan.plan_designs(table_r, rq, arch=ARCH)
    want.recompose16 = rplan.recompose16_frontier()
    got = tplan.plan_designs(interop.table_from_json(text), tq, arch=ARCH)
    got.recompose16 = tplan.recompose16_frontier()
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    # and the plan survives the port's save / load
    back = tplan.DesignPlan.from_json(json.loads(json.dumps(got.to_json())))
    assert back.to_json() == got.to_json()


@pytest.mark.parametrize("signed", [False, True])
def test_design_costs_match_reference(signed):
    cands = (tplan.CANDIDATES_SIGNED if signed
             else tplan.CANDIDATES_UNSIGNED)
    assert cands == (rplan.CANDIDATES_SIGNED if signed
                     else rplan.CANDIDATES_UNSIGNED)
    for d in cands:
        assert tplan.design_cost(d, signed) == rplan.design_cost(d, signed)


# ---------------------------------------------------------------------------
# install and serve
# ---------------------------------------------------------------------------

class _Recorder:
    """A qdot observer for either package: each call's activations and
    its static quantizer, per site."""

    unroll = True            # the reference's pscan unrolls under it

    def __init__(self):
        self._idx, self.calls = [], {}

    def push(self, i):
        self._idx.append(i)

    def pop(self):
        self._idx.pop()

    def record(self, x, pre, cfg):
        key = pre.path + "@" + ".".join(map(str, self._idx))
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        sx = np.asarray(pre.act_scale, np.float32).reshape(())
        zx = (np.asarray(pre.act_zp, np.float32).reshape(())
              if pre.act_zp is not None else np.float32(0.0))
        self.calls.setdefault(key, []).append((x, sx, zx, cfg.signed))


def _qx(x, sx, zx, signed):
    lo, hi = (-128, 127) if signed else (0, 255)
    return np.clip(np.round(x / sx) + zx, lo, hi)


def _tables_through_json(table_r):
    text = json.dumps(table_r.to_json())
    return (rcalib.CalibrationTable.from_json(json.loads(text)),
            interop.table_from_json(text))


def _planned_trees(cfg_r, pj, pt, mode, plan_json, b=B, p=P):
    """prequantize -> calibrate_decode (the reference's table, through
    JSON, for both) -> apply_calibration -> apply_plan -> comp cols ->
    fuse_projections, in both packages.  Also returns the trees before
    fuse_projections."""
    rq = RQ(design="design2", backend="fused", mode=mode, inference=True)
    tq = TQ(design="design2", backend="fused", mode=mode, inference=True)
    sj, st = r_preq(pj, rq), t_preq(pt, tq)
    cal = np.random.default_rng(4242).integers(
        0, cfg_r.vocab, (b, p)).astype(np.int32)
    table_r = rcalib.calibrate_decode(sj, cfg_r, rq, cal, gen_len=2)
    tab_j, tab_t = _tables_through_json(table_r)
    sj = rcalib.apply_calibration(sj, tab_j)
    st = tcalib.apply_calibration(st, tab_t)
    if plan_json is not None:
        sj = rplan.apply_plan(sj, rplan.DesignPlan.from_json(plan_json), rq)
        st = tplan.apply_plan(st, tplan.DesignPlan.from_json(plan_json), tq)
    sj = rcalib.attach_comp_cols(sj, rq)
    st = tcalib.attach_comp_cols(st, tq)
    return sj, st, r_fuse(sj), t_fuse(st), rq, tq, table_r


def _wrappers(tree, lin):
    out = {}
    lin.map_quantized(tree, lambda n: out.setdefault(n.path, n))
    return out


def _colsums_equal(sj, st):
    """Every wrapper's column-compensation colsum bit-equal."""
    wr, wt = _wrappers(sj, rlin), _wrappers(st, tlin)
    assert sorted(wr) == sorted(wt)
    for k in wr:
        np.testing.assert_array_equal(wt[k].comp_col.numpy(),
                                      np.asarray(wr[k].comp_col))
    return len(wr)


def _run_ref(cfg_r, sj, rq, prompts, gen, jit=True):
    """The reference's prefill + greedy decode: (ids, logits per step,
    caches, recorder).  Jitted, or op by op: eagerly, its layer scans
    unrolled under a _Recorder (the way its calibration pass runs),
    which records every qdot call (recorder None when jitted)."""
    b, p = prompts.shape
    prefill, step = r_prefill(cfg_r, rq), r_step(cfg_r, rq)
    rec = None
    if jit:
        prefill, step = jax.jit(prefill), jax.jit(step)
    else:
        rec = _Recorder()
        rlin.set_observer(rec)
    try:
        s = RT.init_decode_state(cfg_r, b, p + gen)
        tok, lg, s = prefill(sj, s, jnp.asarray(prompts))
        ids_r, lg_r = [np.asarray(tok)], [np.asarray(lg)]
        for _ in range(gen - 1):
            tok, lg, s = step(sj, s, tok)
            ids_r.append(np.asarray(tok))
            lg_r.append(np.asarray(lg))
    finally:
        rlin.set_observer(None)
    return (np.concatenate(ids_r, 1), lg_r,
            jax.tree.map(np.asarray, s["caches"]), rec)


def _run_port(cfg_t, st, tq, prompts, gen, rec=None):
    b, p = prompts.shape
    tlin.set_observer(rec)
    try:
        with torch.no_grad():
            s = TT.init_decode_state(cfg_t, b, p + gen, device="cpu")
            tok, lg, s = t_prefill(cfg_t, tq)(st, s,
                                              torch.from_numpy(prompts))
            ids_t, lg_t = [tok.numpy()], [lg.numpy()]
            for _ in range(gen - 1):
                tok, lg, s = t_step(cfg_t, tq)(st, s, tok)
                ids_t.append(tok.numpy())
                lg_t.append(lg.numpy())
    finally:
        tlin.set_observer(None)
    return np.concatenate(ids_t, 1), lg_t, s["caches"]


def _count_flips(rec_r, rec_t):
    """(flipped static steps, total, max |dx|) over the qdot calls two
    _Recorders saw."""
    assert sorted(rec_t.calls) == sorted(rec_r.calls)
    flips = total = 0
    worst = 0.0
    for key, calls_r in rec_r.calls.items():
        for (xr, sx, zx, sg), (xt, sx2, zx2, _) in zip(
                calls_r, rec_t.calls[key], strict=True):
            assert sx == sx2 and zx == zx2
            flips += int((_qx(xt, sx, zx, sg) != _qx(xr, sx, zx, sg)).sum())
            total += xr.size
            worst = max(worst, float(np.abs(xt - xr).max()))
    return flips, total, worst


def _static_flips(cfg_r, cfg_t, rq, tq, sj, st, prompts):
    """Every qdot call of one prefill + one decode step, recorded in both
    packages eagerly."""
    rec_r = _run_ref(cfg_r, sj, rq, prompts, 2, jit=False)[3]
    rec_t = _Recorder()
    _run_port(cfg_t, st, tq, prompts, 2, rec_t)
    return _count_flips(rec_r, rec_t)


def _hold_serving(tag, cfg_r, cfg_t, sj, st, rq, tq, prompts, gen,
                  logit_atol=2e-6, jit=True):
    """Serve both packages and hold the port to the reference (jitted, or
    op by op); returns the reference's (ids, logits)."""
    ids_r, lg_r, caches_r, rec_r = _run_ref(cfg_r, sj, rq, prompts, gen,
                                            jit)
    rec_t = None if jit else _Recorder()
    ids_t, lg_t, caches_t = _run_port(cfg_t, st, tq, prompts, gen, rec_t)
    np.testing.assert_array_equal(ids_t, ids_r)
    gap = max(float(np.abs(a - c).max()) for a, c in zip(lg_t, lg_r))
    scale = max(float(np.abs(c).max()) for c in lg_r)
    entries = {}
    for name in ("k", "v"):
        got = caches_t[0][name].float().numpy()
        want = np.asarray(jnp.asarray(caches_r[0][name], jnp.float32))
        entries[name] = int((got != want).sum())
        check.check_rows(torch.tensor(got), torch.tensor(want))
    flips, total, dx = (_static_flips(cfg_r, cfg_t, rq, tq, sj, st, prompts)
                        if jit else _count_flips(rec_r, rec_t))
    print(f"\n[{tag}] ids {ids_t.tolist()} (reference "
          f"{'jitted' if jit else 'op by op'}); max |logit gap| {gap:.3e} "
          f"(max |logit| {scale:.3e}); cache entries a bf16 step apart "
          f"{entries}; {flips} of {total} static activation steps flipped "
          f"(max |x_port - x_ref| {dx:.3e})")
    for a, c in zip(lg_t, lg_r):
        np.testing.assert_allclose(a, c, rtol=0, atol=logit_atol)
    assert flips <= FLIP_SHARE * total
    return ids_r, lg_r


def _load_committed():
    with open(COMMITTED_PLAN) as fh:
        return json.load(fh)


def _hetero_plan(table_r, mode, layer0="design1", layer1="design2"):
    """Every site of layer 0 on ``layer0``, of layer 1 on ``layer1`` (as
    tests/test_calib.py forces heterogeneity)."""
    plan = rplan.plan_designs(table_r, RQ(mode=mode), arch=ARCH)
    for key in plan.layers:
        plan.layers[key] = layer0 if key.endswith("@0") else layer1
    return plan.to_json()


def _prompts(cfg, b=B, p=P):
    return np.random.default_rng(0).integers(0, cfg.vocab, (b, p)).astype(
        np.int32)


def test_committed_plan_serves_as_the_reference(smoke):
    cfg_r, cfg_t, pj, pt = smoke
    plan = _load_committed()
    assert (plan["mode"], len(plan["layers"])) == ("sym_i8", 14)
    sj0, st0, sj, st, rq, tq, _ = _planned_trees(cfg_r, pj, pt, "sym_i8",
                                                 plan)
    assert _colsums_equal(sj0, st0) == 7
    w = _wrappers(st, tlin)
    assert "units.0.attn.wqkv" in w and "units.0.mlp.w_gateup" in w
    _hold_serving("committed plan sym_i8", cfg_r, cfg_t, sj, st, rq, tq,
                  _prompts(cfg_r), GEN)


@pytest.mark.parametrize("mode", MODES)
def test_heterogeneous_plan_serves_as_the_reference(smoke, mode):
    cfg_r, cfg_t, pj, pt = smoke
    rq = RQ(design="design2", backend="xla", mode=mode)
    table = rcalib.calibrate(r_preq(pj, rq), cfg_r, rq, _batches_np(cfg_r))
    plan = _hetero_plan(table, mode)
    sj0, st0, sj, st, rq, tq, _ = _planned_trees(cfg_r, pj, pt, mode, plan)
    assert _colsums_equal(sj0, st0) == 7
    # every site's bank holds the two tables, one per layer
    for wt in _wrappers(st0, tlin).values():
        bank = tlin.get_dlut_bank(wt.dlut_bank)
        assert bank.shape == (2, 256, 256) and bank.dtype == torch.int16
        assert wt.dlut.tolist() == [0, 1] and wt.dlut.device.type == "cpu"
        for i, d in enumerate(("design1", "design2")):
            np.testing.assert_array_equal(
                bank[i].numpy(), tlut.build_delta_lut(d, mode == "sym_i8"))
    # the members of each group gather the same table on every layer:
    # merged in both packages, and the merged wrapper keeps the bank
    for w in (_wrappers(sj, rlin), _wrappers(st, tlin)):
        assert "units.0.attn.wqkv" in w and "units.0.mlp.w_gateup" in w
    assert _wrappers(st, tlin)["units.0.attn.wqkv"].dlut_bank is not None
    _hold_serving(f"heterogeneous plan {mode}", cfg_r, cfg_t, sj, st, rq,
                  tq, _prompts(cfg_r), GEN)


def test_members_with_different_tables_are_not_merged(smoke):
    """wq on design1 and wk/wv on design2 at layer 0: the attention group
    gathers two tables there, so neither package merges it (the mlp
    group, on one table a layer, is merged); served as the reference."""
    cfg_r, cfg_t, pj, pt = smoke
    mode = "asym_u8"
    rq = RQ(design="design2", backend="xla", mode=mode)
    table = rcalib.calibrate(r_preq(pj, rq), cfg_r, rq, _batches_np(cfg_r))
    plan = _hetero_plan(table, mode, layer0="design2")
    plan["layers"]["units.0.attn.wq@0"] = "design1"
    _, _, sj, st, rq, tq, _ = _planned_trees(cfg_r, pj, pt, mode, plan)
    for w in (_wrappers(sj, rlin), _wrappers(st, tlin)):
        assert "units.0.attn.wqkv" not in w and "units.0.attn.wq" in w
        assert "units.0.mlp.w_gateup" in w
    _hold_serving("split attention group asym_u8", cfg_r, cfg_t, sj, st, rq,
                  tq, _prompts(cfg_r), GEN)


def test_stray_plan_is_refused(smoke):
    _, _, _, pt = smoke
    tq = TQ(design="design2", backend="fused", mode="sym_i8")
    st = t_preq(pt, tq)
    stray = tplan.DesignPlan(arch="other", mode="sym_i8", default="design2",
                             layers={"units.9.attn.bogus@0": "design1"})
    with pytest.raises(KeyError, match="not in the design plan"):
        tplan.apply_plan(st, stray, tq)
    with pytest.warns(UserWarning, match="not in the design plan"):
        tplan.apply_plan(st, stray, tq, strict=False)
    with pytest.raises(ValueError, match="mode"):
        tplan.apply_plan(st, dataclasses.replace(stray, mode="asym_u8"), tq)


def test_odd_layers_moves_only_the_odd_layers():
    plan = tplan.DesignPlan(
        arch=ARCH, mode="sym_i8", default="design2",
        layers={f"units.0.{s}@{i}": "design1" for s in ("attn.wq", "mlp.w_down")
                for i in range(4)},
        meta={"clip": "minmax"})
    het = tcalib.odd_layers(plan, "design2")
    assert het.histogram() == {"design1": 4, "design2": 4}
    for key, d in het.layers.items():
        assert d == ("design2" if int(key.rsplit("@", 1)[1]) % 2
                     else "design1"), key
    assert {k: v for k, v in het.to_json().items() if k != "layers"} == \
        {k: v for k, v in plan.to_json().items() if k != "layers"}
    assert plan.histogram() == {"design1": 8}       # the input is kept


def test_unregistered_bank_is_a_clear_error():
    with pytest.raises(KeyError, match="not registered"):
        tlin.get_dlut_bank("no.such.site|sym_i8|design2")


# ---------------------------------------------------------------------------
# QAT through a plan
# ---------------------------------------------------------------------------

class _RecordDelta:
    """The (a, b) operands of every delta product of one package's
    planned projections: the port's ops.delta_matmul, the reference's
    ref.delta_matmul_ref (its _delta_prod; through jax.debug.callback,
    since remat traces the layer even op by op)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def rec(a, b, *args, **kw):
            if isinstance(a, torch.Tensor):
                self.calls.append((a.numpy(), b.numpy()))
            else:
                jax.debug.callback(lambda x, y: self.calls.append(
                    (np.asarray(x), np.asarray(y))), a, b)
            return self.orig(a, b, *args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in leaves])


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("mode", MODES)
def test_qat_through_a_plan_matches_reference_op_by_op(smoke, mode):
    cfg_r, cfg_t, pj, _ = smoke
    if mode == "sym_i8":
        plan_json = _load_committed()
    else:
        rq0 = RQ(design="design2", backend="xla", mode=mode)
        plan_json = _hetero_plan(rcalib.calibrate(
            r_preq(pj, rq0), cfg_r, rq0, _batches_np(cfg_r, 1)), mode)
    rq = RQ(design="design2", backend="xla", mode=mode)
    tq = TQ(design="design2", backend="xla", mode=mode)
    opt = dict(warmup_steps=5, total_steps=100, compress_grads=True)
    dcfg = rdata.DataConfig(vocab=cfg_r.vocab, seq_len=16, global_batch=4)
    batches = [rdata.host_batch(dcfg, s) for s in (3, 4)]

    inject_r = rplan.make_plan_injector(
        pj, rplan.DesignPlan.from_json(plan_json), rq)
    step_r = r_train_step(cfg_r, rq, ROC(**opt), remat=True,
                          params_transform=inject_r)
    rp, rs = pj, ropt.init(pj, ROC(**opt))
    with _RecordDelta(rref, "delta_matmul_ref") as rrec:
        with jax.disable_jit():
            for bt in batches:
                rp, rs, rm = step_r(rp, rs, {k: jnp.asarray(v)
                                             for k, v in bt.items()})
        jax.effects_barrier()
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                   device="cpu")
    inject_t = tplan.make_plan_injector(
        tp, tplan.DesignPlan.from_json(plan_json), tq)
    step_t = t_train_step(cfg_t, tq, TOC(**opt), remat=True,
                          params_transform=inject_t)
    ts = topt.init(tp, TOC(**opt))
    with _RecordDelta(tops, "delta_matmul") as trec:
        for bt in batches:
            tp, ts, tm = step_t(tp, ts, {k: torch.from_numpy(v)
                                         for k, v in bt.items()})
    # the optimizer tree stays raw tensors
    assert all(isinstance(x, torch.Tensor) for x in topt.tree_leaves(tp))
    # 7 projections x 2 layers x (forward + remat recompute) x 2 steps
    assert len(trec.calls) == 7 * cfg_t.n_layers * 2 * 2
    p0 = _flat(jax.tree.leaves(pj))
    gaps = {"loss": abs(float(tm["loss"]) / float(rm["loss"]) - 1),
            "grad_norm": abs(float(tm["grad_norm"])
                             / float(rm["grad_norm"]) - 1),
            "mu": _rel(_flat(x.numpy() for x in topt.tree_leaves(ts.mu)),
                       _flat(jax.tree.leaves(rs.mu))),
            "update": _rel(_flat(x.numpy() for x in topt.tree_leaves(tp))
                           - p0, _flat(jax.tree.leaves(rp)) - p0)}
    by_w = {}
    for a, b in rrec.calls:
        by_w.setdefault((b.astype(np.int64).tobytes(), a.shape),
                        []).append(a)
    flips = total = 0
    for a, b in trec.calls:
        cands = by_w[(b.astype(np.int64).tobytes(), a.shape)]
        flips += min(int((a != c).sum()) for c in cands)
        total += a.size
    print(f"\n[{mode}] QAT through a plan, 2 steps: {gaps}; {flips} of "
          f"{total} activation steps flipped")
    assert flips == 0
    assert gaps["loss"] <= 2e-6, gaps
    assert gaps["grad_norm"] <= 1e-4, gaps
    assert gaps["mu"] <= 1e-4, gaps
    assert gaps["update"] <= 1e-3, gaps


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_plan_serve_and_train_clis_end_to_end(tmp_path, capsys):
    out = tmp_path / "plan.json"
    plan = tplan.main(["--smoke", "--batches", "1", "--quant-mode",
                       "sym_i8", "--no-recompose16", "--device", "cpu",
                       "--out", str(out)])
    assert out.exists() and len(plan.layers) == 14
    assert "14 sites" in capsys.readouterr().out
    ids, logits = tserve.main(["--smoke", "--requests", "2", "--prompt-len",
                               "3", "--gen-len", "4", "--quant-mode",
                               "sym_i8", "--plan", str(out), "--device",
                               "cpu"])
    assert ids.shape == (2, 4) and np.isfinite(logits).all()
    assert "design plan" in capsys.readouterr().out
    loss = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "2",
                         "--seq", "16", "--batch", "2", "--quant-mode",
                         "sym_i8", "--plan", str(out)])
    assert np.isfinite(loss)
    assert "QAT through design plan" in capsys.readouterr().out


def test_plan_cli_refuses_per_channel(tmp_path, capsys):
    """The CLI refused --per-channel until per-channel weight scales were
    ported; it now takes it, as the reference's does (the plan's JSON is
    held against the reference's in test_torch_serve_options.py)."""
    out = tmp_path / "plan.json"
    plan = tplan.main(["--smoke", "--batches", "1", "--no-recompose16",
                       "--device", "cpu", "--per-channel", "--out",
                       str(out)])
    assert out.exists() and len(plan.layers) == 14
    assert "queue 1, item 3" not in capsys.readouterr().err


def test_plan_cli_default_out_is_under_build(tmp_path, monkeypatch):
    """Without --out the plan goes under build/ (gitignored), never over
    the reference's committed experiments/ plan."""
    monkeypatch.chdir(tmp_path)
    tplan.main(["--smoke", "--batches", "1", "--no-recompose16",
                "--device", "cpu"])
    assert (tmp_path / "build" / "plans"
            / "design_plan_qwen3-1.7b.json").exists()
    assert not (tmp_path / "experiments").exists()


# ---------------------------------------------------------------------------
# full-width shapes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width():
    cfg_r = dataclasses.replace(rconfigs.get(ARCH), n_layers=1, vocab=512)
    cfg_t = dataclasses.replace(tconfigs.get(ARCH), n_layers=1, vocab=512)
    pj = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    pt = interop.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t,
                                   device="cpu")
    return cfg_r, cfg_t, pj, pt


@pytest.mark.parametrize("mode", MODES)
def test_full_width_shapes_serve_as_the_reference(full_width, mode):
    """The projections at qwen3-1.7b's widths (K = 2048 and 6144, N up to
    6144, head_dim 128), calibrated token by token in both packages and
    served from the reference's table.  Held against the reference run
    op by op (eagerly, its layer scans unrolled).  The jitted reference
    is only reported:
    in asym_u8 at these widths XLA's compiled order of fused_qdot's
    zero-point epilogue moves the first projection's output by about
    1e-4 on identical quantized operands (measured 1.16e-4 of max |y|
    4.5 at K = 2048), which flips later static steps; sym_i8 (no
    zero-point terms) matches it exactly."""
    t0 = time.perf_counter()
    cfg_r, cfg_t, pj, pt = full_width
    assert (cfg_t.d_model, cfg_t.d_ff, cfg_t.hd) == (2048, 6144, 128)
    b, p, gen = 2, 3, 3
    rq = RQ(design="design2", backend="fused", mode=mode, inference=True)
    tq = TQ(design="design2", backend="fused", mode=mode, inference=True)
    cal = np.random.default_rng(4242).integers(
        0, cfg_r.vocab, (b, p)).astype(np.int32)
    table_t = tcalib.calibrate_decode(t_preq(pt, tq), cfg_t, tq, cal,
                                      gen_len=2, device="cpu")
    sj0, st0, sj, st, rq, tq, table_r = _planned_trees(
        cfg_r, pj, pt, mode, None, b=b, p=p)
    assert sorted(table_t.sites) == sorted(table_r.sites)
    moved, rel = 0, 0.0
    for k, r in table_r.sites.items():
        t = table_t.sites[k]
        assert t["count"] == r["count"]
        np.testing.assert_array_equal(t["hist_w"], r["hist_w"])
        moved += int(np.abs(np.asarray(t["hist_x"])
                            - np.asarray(r["hist_x"])).sum()) // 2
        for f in ("lo", "hi", "amax"):
            rel = max(rel, abs(t[f] - r[f]) / max(abs(r[f]), 1e-30))
    total = sum(int(s["count"]) for s in table_r.sites.values())
    print(f"\n[full width {mode}] calibration: {moved} of {total} "
          f"activation counts in another bin; lo/hi/amax within "
          f"{rel:.3e} relative")
    assert moved <= FLIP_SHARE * total
    assert rel <= 1e-4
    assert _colsums_equal(sj0, st0) == 7
    prompts = _prompts(cfg_r, b, p)
    ids_e, lg_e = _hold_serving(f"full width {mode}", cfg_r, cfg_t, sj, st,
                                rq, tq, prompts, gen, jit=False)
    ids_j, lg_j, _, _ = _run_ref(cfg_r, sj, rq, prompts, gen, jit=True)
    print(f"[full width {mode}] the reference jitted against its own run op "
          f"by op (not asserted): ids {ids_j.tolist()} vs {ids_e.tolist()},"
          f" max |logit gap| "
          f"{max(float(np.abs(a - c).max()) for a, c in zip(lg_j, lg_e)):.3e}"
          f"; {time.perf_counter() - t0:.1f}s")
