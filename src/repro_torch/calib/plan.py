"""Design planner: per-layer MED x PDAP search over the registered designs,
and the install of its plans.

The search (numpy, as the reference's): each (site, design) is scored by
the distribution-weighted mean error distance px^T |E_d| pw under the
site's calibrated operand histograms, and the design's unit-gate PDAP
(core.cost).  Objective "pdaep" (default) takes min weighted-MED x PDAP
over the approximate candidates; "budget" the cheapest design whose
weighted MED stays within ``rel_tol`` of the site's weighted mean
|a.b|, or 'exact' when none does.  The result is a ``DesignPlan`` (JSON
in the reference's format): per-site designs, the MED-vs-PDAP frontier
and the 16x16 four-block recomposition frontier.

The install: ``apply_plan`` puts a plan on a prequantized (optionally
calibrated) tree.  Each site's distinct delta tables go into a bank
(quant.linear.register_dlut_bank), int16 on every device; the wrapper
carries each layer's bank index (on the host), the layer design's
compensation tables and the precomputed column-compensation sums.  The
fused kernel then reads the layer's table as one row of the bank, picked
once per layer wrapper.  ``make_plan_injector`` wraps raw float params on
the fly for QAT through the planned designs.

CLI (calibrate -> plan; ``python -m repro_torch.calib`` runs the same):

    PYTHONPATH=src python -m repro_torch.calib.plan --arch qwen3-1.7b \\
        --batches 2 --out build/plans/design_plan_qwen3-1.7b.json
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
import warnings
from dataclasses import field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import cost as cost_mod
from ..quant import linear as qlin
from ..quant.quantize import QuantConfig
from .observe import CalibrationTable, site_key

# Candidate designs with unit-gate stage plans (core.cost): the
# truncation ladder spans the paper's accuracy/cost knob.  design2 IS
# design1_trunc6; 'initial' (int16-overflowing delta) and the
# competitor reconstructions (no stage plans) are excluded.
CANDIDATES_UNSIGNED = (
    "exact", "design1", "design1_trunc1", "design1_trunc2",
    "design1_trunc3", "design1_trunc4", "design1_trunc5", "design2",
    "design1_trunc7",
)
# sign-magnitude variants registered in signed.multipliers
CANDIDATES_SIGNED = ("exact", "design1", "design1_trunc4", "design2")

# Sign-magnitude wrapper overhead (unit-gate proxy, documented crude):
# two 8-bit conditional negates on the operands (inverters + increment
# ripple), one 16-bit conditional negate on the product, one sign XOR.
_SIGN_AREA = 2 * (8 * 0.5 + 8 * 3.0) + (16 * 0.5 + 16 * 3.0) + 2.0
_SIGN_DELAY = 8.0


def _trunc_level(design: str) -> int:
    if design == "design1":
        return 0
    if design == "design2":
        return 6
    if design.startswith("design1_trunc"):
        return int(design[len("design1_trunc"):])
    raise ValueError(design)


def design_cost(design: str, signed: bool = False) -> Dict[str, float]:
    """Unit-gate cost dict for a candidate design ('exact' is proxied by
    the Dadda accurate multiplier, the paper's Table 3 baseline)."""
    from ..core import multipliers as M
    if design in ("exact", "dadda"):
        c = dict(cost_mod.dadda_cost())
    else:
        t = _trunc_level(design)
        plan, pairs, rca = M._truncated_plan(t)
        c = dict(cost_mod.multiplier_cost(plan, pairs, rca, n_trunc=t))
    if signed:
        c["area"] += _SIGN_AREA
        c["energy"] += _SIGN_AREA
        c["delay"] += _SIGN_DELAY
    return c


def _abs_error_table(design: str, signed: bool) -> np.ndarray:
    from ..core import lut as lutmod
    e = (lutmod.signed_error_table(design) if signed
         else lutmod.error_table(design))
    return np.abs(e.astype(np.float64))


def _dists(site: dict):
    px = np.asarray(site["hist_x"], np.float64)
    pw = np.asarray(site["hist_w"], np.float64)
    px = px / max(px.sum(), 1.0)
    pw = pw / max(pw.sum(), 1.0)
    return px, pw


def weighted_med(design: str, site: dict, signed: bool) -> float:
    """E[|e_d(a,b)|] under the site's quantized operand histograms."""
    px, pw = _dists(site)
    return float(px @ _abs_error_table(design, signed) @ pw)


def weighted_mean_product(site: dict, signed: bool) -> float:
    """E[|a.b|] under the same histograms (separable): the magnitude the
    error budget is relative to."""
    px, pw = _dists(site)
    v = np.arange(256, dtype=np.float64) - (128.0 if signed else 0.0)
    return float((px @ np.abs(v)) * (pw @ np.abs(v)))


def _pareto(points: List[dict], xk: str, yk: str) -> None:
    """Mark non-dominated (minimize both xk, yk) points in place."""
    for p in points:
        p["on_frontier"] = not any(
            (q[xk] <= p[xk] and q[yk] <= p[yk]
             and (q[xk] < p[xk] or q[yk] < p[yk]))
            for q in points)


@dataclasses.dataclass
class DesignPlan:
    """A servable per-layer design assignment + the search evidence."""
    arch: str
    mode: str
    default: str
    layers: Dict[str, str]                       # site key -> design
    frontier: List[dict] = field(default_factory=list)
    recompose16: List[dict] = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    @property
    def signed(self) -> bool:
        return self.mode == "sym_i8"

    def design_for(self, key: str) -> str:
        return self.layers.get(key, self.default)

    def histogram(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.layers.values():
            out[d] = out.get(d, 0) + 1
        return dict(sorted(out.items()))

    def to_json(self) -> dict:
        return {"version": 1, "kind": "DesignPlan", "arch": self.arch,
                "mode": self.mode, "default": self.default,
                "layers": self.layers, "frontier": self.frontier,
                "recompose16": self.recompose16, "meta": self.meta}

    @classmethod
    def from_json(cls, d: dict) -> "DesignPlan":
        return cls(arch=d["arch"], mode=d["mode"], default=d["default"],
                   layers=dict(d["layers"]),
                   frontier=list(d.get("frontier", [])),
                   recompose16=list(d.get("recompose16", [])),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1)

    @classmethod
    def load(cls, path: str) -> "DesignPlan":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


def odd_layers(plan: DesignPlan, design: str) -> DesignPlan:
    """A copy of ``plan`` with every site of an odd layer on ``design``:
    the even layers keep the search's choice, so a site's bank holds two
    tables or more."""
    layers = {k: design if int(k.rsplit("@", 1)[1]) % 2 else d
              for k, d in plan.layers.items()}
    return DesignPlan.from_json(dict(plan.to_json(), layers=layers))


def plan_designs(table: CalibrationTable, qcfg: QuantConfig, *,
                 arch: str = "?", objective: str = "pdaep",
                 rel_tol: float = 0.02,
                 candidates: Optional[Sequence[str]] = None) -> DesignPlan:
    """Sweep candidate designs against the calibrated distributions and
    assign each site its design.

    objective 'pdaep' (default): min weighted-MED x PDAP over the
    approximate candidates.  objective 'budget': min PDAP s.t. weighted
    MED <= rel_tol x weighted mean |a.b| of the site; 'exact' when
    nothing fits.
    """
    signed = qcfg.signed
    if candidates is None:
        candidates = CANDIDATES_SIGNED if signed else CANDIDATES_UNSIGNED
    pdap = {d: cost_mod.pdap(design_cost(d, signed)) for d in candidates}

    layers: Dict[str, str] = {}
    agg = {d: 0.0 for d in candidates}
    for key, site in table.sites.items():
        wm = {d: weighted_med(d, site, signed) for d in candidates}
        for d in candidates:
            agg[d] += wm[d]
        if objective == "budget":
            cap = rel_tol * weighted_mean_product(site, signed)
            feasible = [d for d in candidates if wm[d] <= cap]
            choice = (min(feasible, key=lambda d: (pdap[d], wm[d]))
                      if feasible else "exact")
        elif objective == "pdaep":
            approx = [d for d in candidates if d != "exact"]
            choice = min(approx, key=lambda d: wm[d] * pdap[d])
        else:
            raise ValueError(f"unknown objective {objective!r}")
        layers[key] = choice

    n = max(len(table.sites), 1)
    frontier = [{"design": d, "weighted_MED": agg[d] / n, "PDAP_ug": pdap[d]}
                for d in candidates]
    _pareto(frontier, "weighted_MED", "PDAP_ug")

    counts: Dict[str, int] = {}
    for d in layers.values():
        counts[d] = counts.get(d, 0) + 1
    default = max(counts, key=counts.get) if counts else qcfg.design
    return DesignPlan(arch=arch, mode=qcfg.mode, default=default,
                      layers=layers, frontier=frontier,
                      meta={"objective": objective, "rel_tol": rel_tol,
                            "candidates": list(candidates),
                            "n_sites": len(layers),
                            "design_histogram": dict(sorted(counts.items()))})


# ---------------------------------------------------------------------------
# 16x16 recomposition frontier
# ---------------------------------------------------------------------------

# three ~24-bit recomposition additions gluing the four 8x8 blocks
_RECOMP_ADD_FA = 3 * 20


def recompose16_frontier(block_designs: Sequence[str] =
                         ("exact", "design1", "design2"),
                         n_samples: int = 1 << 14,
                         seed: int = 0) -> List[dict]:
    """Sweep the four-block (hh, hl, lh, ll) design space of the
    unsigned 16x16 recomposition (signed/recompose.py) and return the
    sampled-MED vs PDAP rows with the Pareto frontier marked.

    Cost proxy: sum of the four block costs + a ripple-adder glue term;
    delay = slowest block + glue ripple."""
    from ..signed.recompose import Recomposed16, sample_operands
    fa = cost_mod.CELLS["fa"]
    a, b = sample_operands("u16_exact", n_samples, seed)
    exact = a * b
    rows = []
    for hh, hl, lh, ll in itertools.product(block_designs, repeat=4):
        spec = Recomposed16(hh, hl, lh, ll)
        e = np.abs(spec(a, b) - exact)
        costs = [design_cost(d) for d in (hh, hl, lh, ll)]
        area = sum(c["area"] for c in costs) + _RECOMP_ADD_FA * fa.area
        delay = max(c["delay"] for c in costs) \
            + _RECOMP_ADD_FA * fa.d_carry / 3.0
        pdap = area * area * delay   # energy proxy == area (unit-gate)
        rows.append({"hh": hh, "hl": hl, "lh": lh, "ll": ll,
                     "MED": float(e.mean()), "max_ED": float(e.max()),
                     "area_ug": area, "delay_ug": delay,
                     "PDAP_ug": pdap})
    _pareto(rows, "MED", "PDAP_ug")
    return rows


# ---------------------------------------------------------------------------
# Plan installation
# ---------------------------------------------------------------------------

def _comp_tables(design: str, signed: bool):
    from ..core import lut as lutmod
    e = (lutmod.signed_error_table(design) if signed
         else lutmod.error_table(design)).astype(np.float64)
    return (e.mean(1).astype(np.float32), e.mean(0).astype(np.float32),
            np.float32(e.mean()))


def _site_tables(plan: DesignPlan, path: str, lead, *,
                 missing: Optional[list] = None) -> dict:
    """Stacked per-layer delta tables + compensation tables (numpy) for
    one wrapped weight with leading layer axes ``lead``.  Site keys absent
    from the plan resolve to plan.default and are appended to
    ``missing``.  The bank ``dlut`` stacks only the distinct designs the
    site uses (first-occurrence order); ``dlut_idx`` maps each layer to
    its row."""
    from ..core import lut as lutmod
    idxs = list(np.ndindex(*lead)) if lead else [()]
    keys = [site_key(path, idx) for idx in idxs]
    if missing is not None:
        missing.extend(k for k in keys if k not in plan.layers)
    designs = [plan.design_for(k) for k in keys]
    uniq = list(dict.fromkeys(designs))
    dl = np.stack([np.asarray(lutmod.build_delta_lut(d, plan.signed))
                   for d in uniq])
    didx = np.asarray([uniq.index(d) for d in designs],
                      np.int32).reshape(lead or ())
    cr, cc, cm = zip(*(_comp_tables(d, plan.signed) for d in designs))
    return {
        "dlut": dl,                                   # (n_uniq, 256, 256)
        "dlut_idx": didx,
        "comp_r": np.stack(cr).reshape(*lead, 256),
        "comp_c": np.stack(cc).reshape(*lead, 256),
        "comp_mu": np.asarray(cm, np.float32).reshape(lead or ()),
        "designs": designs,
        "uniq_designs": uniq,
    }


def _check_plan_coverage(plan: DesignPlan, missing: list, n_sites: int,
                         strict: bool) -> None:
    if not missing:
        return
    msg = (f"{len(missing)} of {n_sites} model sites are not in the "
           f"design plan (built for arch {plan.arch!r}, "
           f"{plan.meta.get('n_sites', len(plan.layers))} sites) — e.g. "
           f"{missing[:3]}; the plan was made for a different "
           f"arch/size (smoke vs full?).  Re-plan for this model, or "
           f"pass strict=False to serve plan.default={plan.default!r} "
           f"on the uncovered layers")
    if strict:
        raise KeyError(msg)
    warnings.warn(msg)


def _bank_key(path: str, plan: DesignPlan, designs) -> str:
    """Content-addressed registry key for a site's table bank: two plans
    collide only when they would install identical tables anyway."""
    return f"{path}|{plan.mode}|{','.join(designs)}"


def _bank(t: dict, device) -> torch.Tensor:
    """A site's bank as an int16 tensor on ``device``, on every device:
    the kernels keep one 128 KiB table in shared memory, and every
    candidate design's delta table fits int16 (the candidates exclude
    'initial').  Refuses a design whose table does not."""
    dl = t["dlut"]
    info = np.iinfo(np.int16)
    if dl.min() < info.min or dl.max() > info.max:
        raise ValueError(f"designs {t['uniq_designs']}: a plan's delta "
                         f"tables must fit int16 (plan from the candidate "
                         f"designs, which exclude 'initial')")
    return torch.from_numpy(dl.astype(np.int16)).to(device)


def _comp_col(q: torch.Tensor, comp_c: np.ndarray, signed: bool, lead):
    """take(comp_c[layer], q[layer]).sum(K) per layer, summed in float64
    and rounded to float32 as the reference does: (*lead, 1, N) f32."""
    cc = torch.from_numpy(comp_c.astype(np.float64)).to(q.device)
    off = 128 if signed else 0
    out = torch.empty((*lead, 1, q.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for idx in (list(np.ndindex(*lead)) if lead else [()]):
        g = cc[idx][q[idx].long() + off]
        out[idx] = g.sum(-2, keepdim=True).to(torch.float32)
    return out


def apply_plan(pparams, plan: DesignPlan, qcfg: QuantConfig, *,
               strict: bool = True):
    """Install a DesignPlan on a prequantized (optionally calibrated)
    params tree: each QuantizedWeight's distinct delta tables go into a
    bank (quant.linear.register_dlut_bank, on the weights' device), and
    the wrapper carries each layer's int32 bank index (on the host), the
    per-layer compensation tables of its design and, when the weights are
    cached, the column-compensation colsum the fused epilogue reads.

    strict=True (default) rejects a plan that does not cover this
    model's sites (a plan built on another arch/size would otherwise
    silently serve plan.default everywhere)."""
    if plan.mode != qcfg.mode:
        raise ValueError(f"plan was built for mode {plan.mode!r} but the "
                         f"serving QuantConfig uses {qcfg.mode!r}")
    missing: list = []
    n_sites = [0]

    def install(node):
        lead = tuple(int(d) for d in node.w.shape[:-2])
        n_sites[0] += int(np.prod(lead)) if lead else 1
        t = _site_tables(plan, node.path, lead, missing=missing)
        dev = node.w.device
        key = _bank_key(node.path, plan, t["uniq_designs"])
        qlin.register_dlut_bank(key, _bank(t, dev))
        return node.replace(
            dlut=torch.from_numpy(t["dlut_idx"]), dlut_bank=key,
            comp_r=torch.from_numpy(t["comp_r"]).to(dev),
            comp_c=torch.from_numpy(t["comp_c"]).to(dev),
            comp_mu=torch.from_numpy(t["comp_mu"]).to(dev),
            comp_col=(_comp_col(node.q, t["comp_c"], plan.signed, lead)
                      if node.q is not None else None))

    out = qlin.map_quantized(pparams, install)
    _check_plan_coverage(plan, missing, n_sites[0], strict)
    return out


def make_plan_injector(params, plan: DesignPlan, qcfg: QuantConfig, *,
                       strict: bool = True):
    """For training: returns ``inject(params) -> wrapped`` that wraps
    each raw dense weight in a QuantizedWeight carrying ONLY the plan's
    per-layer bank index and compensation tables (no cached q: weight
    quantization stays dynamic, as QAT needs).  Call inside the loss
    (train.make_train_step's ``params_transform``), so autograd sees
    straight through to the raw leaves and the optimizer tree is
    untouched.  strict=True rejects a plan that does not cover this
    model's sites."""
    if plan.mode != qcfg.mode:
        raise ValueError(f"plan was built for mode {plan.mode!r} but the "
                         f"training QuantConfig uses {qcfg.mode!r}")
    consts: Dict[str, dict] = {}
    missing: list = []
    n_sites = [0]

    def collect(v, path):
        lead = tuple(int(d) for d in v.shape[:-2])
        n_sites[0] += int(np.prod(lead)) if lead else 1
        t = _site_tables(plan, path, lead, missing=missing)
        key = _bank_key(path, plan, t["uniq_designs"])
        qlin.register_dlut_bank(key, _bank(t, v.device))
        consts[path] = {
            "dlut": torch.from_numpy(t["dlut_idx"]),
            "dlut_bank": key,
            "comp_r": torch.from_numpy(t["comp_r"]).to(v.device),
            "comp_c": torch.from_numpy(t["comp_c"]).to(v.device),
            "comp_mu": torch.from_numpy(t["comp_mu"]).to(v.device),
        }
        return v

    qlin.walk_dense(params, collect)
    _check_plan_coverage(plan, missing, n_sites[0], strict)

    def inject(p):
        def wrap(v, path):
            return qlin.QuantizedWeight(v, mode=qcfg.mode, path=path,
                                        per_channel=qcfg.w_per_channel,
                                        **consts[path])
        return qlin.walk_dense(p, wrap)

    return inject


# ---------------------------------------------------------------------------
# CLI: calibrate -> plan -> serialize
# ---------------------------------------------------------------------------

def build_parser():
    import argparse
    ap = argparse.ArgumentParser(
        description="Calibrate a model and emit a per-layer DesignPlan")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batches", type=int, default=2,
                    help="calibration batches (train-shaped)")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--design", default="design2",
                    help="enabling design for the calibration forward")
    ap.add_argument("--quant-mode", default="sym_i8",
                    choices=["asym_u8", "sym_i8"])
    ap.add_argument("--per-channel", action="store_true",
                    help="per-output-channel weight scales")
    ap.add_argument("--clip", default="minmax",
                    choices=["minmax", "pct999", "mse"],
                    help="activation-range clipping calibrator to report "
                         "(recorded in plan meta; serve.py --clip "
                         "installs it)")
    ap.add_argument("--objective", default="pdaep",
                    choices=["pdaep", "budget"])
    ap.add_argument("--rel-tol", type=float, default=0.02)
    ap.add_argument("--out", default=None,
                    help="plan path (default build/plans/design_plan_"
                         "<arch>.json)")
    ap.add_argument("--calib-out", default=None,
                    help="also save the raw CalibrationTable JSON")
    ap.add_argument("--no-recompose16", action="store_true",
                    help="skip the 16x16 four-block frontier sweep")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    from .. import configs
    from ..device import resolve
    from ..models import transformer as T
    from ..quant import prequantize_weights
    from . import observe, static as static_mod

    ap = build_parser()
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dev = resolve(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(
        args.arch)
    qcfg = QuantConfig(design=args.design, backend="xla",
                       mode=args.quant_mode,
                       w_per_channel=args.per_channel)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    pparams = prequantize_weights(params, qcfg)
    batches = [configs.make_smoke_batch(cfg, args.batch_size, args.seq,
                                        seed=i) for i in range(args.batches)]
    print(f"[plan] calibrating {args.arch} ({args.batches} batches, "
          f"mode {args.quant_mode}, device {dev})")
    table = observe.calibrate(pparams, cfg, qcfg, batches, device=dev)
    cov = static_mod.coverage(pparams, table)
    print(f"[plan] observed {cov['sites_recorded']} sites "
          f"({cov['sites_expected']} expected, "
          f"{len(cov['missing'])} missing)")
    if args.calib_out:
        table.save(args.calib_out)
        print(f"[plan] wrote calibration table to {args.calib_out}")
    if args.clip != "minmax":
        shrunk = 0
        for key in table.sites:
            s_mm, _ = static_mod.act_quant_clipped(table, key, "minmax")
            s_cl, _ = static_mod.act_quant_clipped(table, key, args.clip)
            shrunk += s_cl < s_mm
        print(f"[plan] clip={args.clip}: range shrunk on {shrunk}/"
              f"{len(table.sites)} sites vs minmax")

    plan = plan_designs(table, qcfg, arch=args.arch,
                        objective=args.objective, rel_tol=args.rel_tol)
    plan.meta["clip"] = args.clip
    if not args.no_recompose16:
        plan.recompose16 = recompose16_frontier()
    out = args.out or os.path.join("build", "plans",
                                   f"design_plan_{args.arch}.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    plan.save(out)
    print(f"[plan] design histogram: {plan.histogram()}")
    front = [r["design"] for r in plan.frontier if r["on_frontier"]]
    print(f"[plan] MED-PDAP frontier designs: {front}")
    if plan.recompose16:
        r16 = sum(r["on_frontier"] for r in plan.recompose16)
        print(f"[plan] recompose16 frontier: {r16} of "
              f"{len(plan.recompose16)} block assignments")
    print(f"[plan] wrote {out} ({len(plan.layers)} sites) in "
          f"{time.perf_counter() - t0:.1f}s")
    return plan


if __name__ == "__main__":
    main()
