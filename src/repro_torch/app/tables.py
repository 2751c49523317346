"""The rows of the paper's tables and figures (and the beyond-paper
tables), from the port's own copies of the gate-level multipliers, their
metrics and the applications.  Each function returns list-of-dict rows;
``table5_sharpening`` and ``table_edge_detection`` run their images on
``device``, the other nine are plain numpy.

    python -m repro_torch.app.tables [--only a,b] [--device cpu]

prints ``### name`` and each table's CSV.
"""
from __future__ import annotations

import argparse
import csv
import io
import math
from typing import Dict, List

import numpy as np

from ..core import compressors as C, cost, metrics, multipliers as M
from ..core.multipliers import _truncated_plan
from ..device import resolve


def table1_truth_table() -> List[Dict]:
    """Paper Table 1: the 3,3:2 truth table grouped by sigma-in."""
    tt = C.truth_table("3,3:2")
    grouped = {}
    for r in tt:
        bits = r[:7]
        key = (int(bits[3] + bits[4] + bits[5]),
               int(bits[0] + bits[1] + bits[2]), int(bits[6]))
        sigma = key[0] * 2 + key[1] + key[2]
        out = (int(r[9]), int(r[8]), int(r[7]), int(r[-1]))
        if key in grouped:
            assert grouped[key][1] == out, "non-uniform group!"
            grouped[key] = (grouped[key][0] + 1, out)
        else:
            grouped[key] = (1, out)
    rows = []
    for (sb, sa, cin), (count, (cout, carry, s, ed)) in sorted(
            grouped.items(), key=lambda kv: (kv[0][0] * 2 + kv[0][1]
                                             + kv[0][2], kv[0])):
        rows.append({"sigma_in": sb * 2 + sa + cin, "sum_b": sb,
                     "sum_a": sa, "cin": cin, "cout": cout, "carry": carry,
                     "sum": s, "ED": ed, "P(row)": f"{count}/128"})
    stats = C.compressor_stats("3,3:2")
    rows.append({"sigma_in": "NED_C", "ED": stats["NED_C"]})
    return rows


def table2_compressors() -> List[Dict]:
    """Paper Table 2 + Table 6: NED of every compressor + unit-gate cost
    proxies standing in for the 45nm FOM1/FOM2."""
    rows = []
    for name in C.SPECS:
        s = C.compressor_stats(name)
        cc = cost.CELLS[{
            "3,3:2": "3,3:2", "2,2:2": "2,2:2",
            "3,3:2-nocin": "3,3:2-nocin", "3,2:2-nocin": "3,2:2-nocin",
            "2,3:2": "2,3:2", "1,3:2": "1,3:2", "1,2:2": "1,2:2",
            "1,2:2-nocin": "1,2:2-nocin"}[name]]
        m = sum(C.SPECS[name].in_weights)
        n_out = len(C.SPECS[name].out_weights)
        delay = max(cc.d_sum, cc.d_carry, cc.d_cout)
        fom1 = delay / (math.log10(m) - math.log10(n_out)) \
            if m > n_out else float("inf")
        fom2 = delay * cc.energy / (1 - s["NED_C"])
        rows.append({"compressor": name, "NED": round(s["NED_C"], 5),
                     "MED": s["MED_C"], "ER": s["ER"],
                     "unitgate_delay": delay, "unitgate_area": cc.area,
                     "FOM1_proxy": round(fom1, 3),
                     "FOM2_proxy": round(fom2, 2)})
    return rows


def table3_accurate() -> List[Dict]:
    """Paper Table 3: proposed vs accurate multipliers (cost proxies)."""
    rows = []
    d1 = cost.multiplier_cost(M.DESIGN1_STAGE1, M.DESIGN1_CELL_PAIRS, 10)
    p2, pr2, r2 = _truncated_plan(6)
    d2 = cost.multiplier_cost(p2, pr2, r2, n_trunc=6)
    for name, c in [("dadda", cost.dadda_cost()),
                    ("mult62_exact[38]", cost.mult62_cost()),
                    ("design1", d1), ("design2", d2)]:
        rows.append({"multiplier": name, "delay_ug": c["delay"],
                     "area_ug": c["area"], "PDP_ug": cost.pdp(c),
                     "PDAP_ug": cost.pdap(c), "stages": c["stages"]})
    return rows


def table4_approx() -> List[Dict]:
    """Paper Table 4: error stats of all approximate multipliers."""
    rows = []
    paper = {"design1": (297.9, 4.58, 66.9), "design2": (409.7, 6.30, 94.5),
             "momeni15": (3480, 53.5, 99.8), "sabetzadeh14": (455.2, 7.0, 99.8),
             "venkatachalam16": (1157, 17.8, 85.4)}
    for name in ("design1", "design2", "initial", "momeni15",
                 "sabetzadeh14", "venkatachalam16"):
        s = metrics.multiplier_stats(M.MULTIPLIERS[name])
        row = {"multiplier": name, "MED": round(s["MED"], 1),
               "NED_e-3": round(s["NED"] * 1e3, 2),
               "ER_%": round(s["ER"] * 100, 1),
               "maxED": s["max_ED"]}
        if name in paper:
            row.update(paper_MED=paper[name][0], paper_NED=paper[name][1],
                       paper_ER=paper[name][2])
        rows.append(row)
    return rows


def fig9_pdaep() -> List[Dict]:
    """Fig. 9 analogue: PDAEP across precise-component counts is the
    paper's design-selection sweep; we sweep our reconstruction's
    truncation ladder + Design #1 (closest spanned family)."""
    rows = []
    d1 = cost.multiplier_cost(M.DESIGN1_STAGE1, M.DESIGN1_CELL_PAIRS, 10)
    med1 = metrics.multiplier_stats(M.mult_design1)["MED"]
    rows.append({"design": "design1(4 precise)",
                 "PDAEP_ug": cost.pdaep(d1, med1), "MED": round(med1, 1)})
    return rows


def fig11_truncation() -> List[Dict]:
    """Fig. 11: MED and PDAP vs number of truncated columns."""
    rows = []
    for t in range(0, 8):
        name = "design1" if t == 0 else f"design1_trunc{t}"
        med = metrics.multiplier_stats(M.MULTIPLIERS[name])["MED"]
        plan, pairs, rca = _truncated_plan(t)
        c = cost.multiplier_cost(plan, pairs, rca, n_trunc=t)
        rows.append({"truncated_cols": t, "MED": round(med, 1),
                     "PDAP_ug": round(cost.pdap(c), 1),
                     "area_ug": c["area"]})
    return rows


def fig13_heatmaps() -> List[Dict]:
    """Fig. 13: error-pattern statistics (border ratio = small-operand
    error concentration; the paper's explanation of application-level
    failures)."""
    rows = []
    for name in ("design1", "design2", "momeni15", "sabetzadeh14",
                 "venkatachalam16"):
        h = metrics.heatmap(M.MULTIPLIERS[name]).astype(np.float64)
        rows.append({
            "multiplier": name,
            "border_ratio": round(metrics.border_error_ratio(
                M.MULTIPLIERS[name]), 3),
            "mean_absED": round(h.mean(), 1),
            "q99_absED": float(np.quantile(h, 0.99)),
        })
    return rows


def table5_sharpening(device="cuda") -> List[Dict]:
    """Paper Table 5: PSNR/SSIM of approximately-sharpened images vs the
    accurately-sharpened ones, averaged over the 6-image synthetic set
    (Local Image Sharpness Database unavailable offline)."""
    from . import sharpening as sh
    dev = resolve(device)
    imgs = sh.make_test_images()
    paper = {"design1": (0.9469, 28.29), "design2": (0.8929, 22.47),
             "momeni15": (1e-6, 6.69)}
    rows = []
    for name in ("design1", "design2", "momeni15", "sabetzadeh14",
                 "venkatachalam16"):
        ps, ss = [], []
        for img in imgs:
            exact = sh.sharpen(img, "exact", dev)
            test = sh.sharpen(img, name, dev)
            ps.append(sh.psnr(exact, test))
            ss.append(sh.ssim(exact, test))
        row = {"multiplier": name, "PSNR": round(float(np.mean(ps)), 2),
               "SSIM": round(float(np.mean(ss)), 4)}
        if name in paper:
            row.update(paper_SSIM=paper[name][0], paper_PSNR=paper[name][1])
        rows.append(row)
    return rows


def table_signed_multipliers() -> List[Dict]:
    """Beyond-paper: error stats of the signed int8 derivations
    (signed) — sign-magnitude wrappers + the sign-focused BW
    reduction — over the exhaustive 65,536-pair signed sweep."""
    from ..signed import multipliers as SM
    rows = []
    for name in SM.SIGNED_MULTIPLIERS:
        s = SM.signed_multiplier_stats(name)
        rows.append({"multiplier": name, "MED": round(s["MED"], 1),
                     "NMED_e-3": round(s["NMED"] * 1e3, 3),
                     "ER_%": round(s["ER"] * 100, 1),
                     "maxED": s["max_ED"],
                     "mean_signed": round(s["mean_signed"], 1)})
    return rows


def table_recompose16() -> List[Dict]:
    """Beyond-paper: 16x16 multipliers recomposed from four 8x8 blocks
    with per-block design assignment (sampled sweep; the exact-design
    recompositions are bit-exact, asserted in tests)."""
    from ..signed import recompose as RC
    rows = []
    for name, spec in RC.RECOMPOSED.items():
        s = RC.sampled_stats(name, n=1 << 14)
        rows.append({"multiplier": name,
                     "blocks": "/".join(spec.blocks.values()),
                     "signed": spec.signed,
                     "MED": round(s["MED"], 1),
                     "NMED_e-6": round(s["NMED"] * 1e6, 3),
                     "ER_%": round(s["ER"] * 100, 1)})
    return rows


def table_edge_detection(device="cuda") -> List[Dict]:
    """Beyond-paper: Sobel edge detection through the signed multipliers
    (the headline application of the sign-focused-compressor work).
    Sign-magnitude design1 is exact here — with Sobel coefficients <= 2
    its inexact cells never see enough populated columns to err (the
    paper's small-operand border effect).  The truncated variants
    (design2 & co) drop exactly the low columns such small products live
    in, and the BW variant's constant bias dominates — both degrade."""
    from . import edge_detection as ed
    from .sharpening import make_test_images
    dev = resolve(device)
    imgs = make_test_images()
    rows = []
    for name in ("design1", "design2", "design1_trunc4", "bw_design1"):
        s = ed.evaluate(name, imgs, device=dev)
        rows.append({"multiplier": name,
                     "edge_F1": round(s["edge_F1"], 4),
                     "grad_PSNR": round(s["grad_PSNR"], 2)})
    return rows


ALL = {
    "table1_truth_table": table1_truth_table,
    "table2_compressors": table2_compressors,
    "table3_accurate": table3_accurate,
    "table4_approx": table4_approx,
    "table5_sharpening": table5_sharpening,
    "fig9_pdaep": fig9_pdaep,
    "fig11_truncation": fig11_truncation,
    "fig13_heatmaps": fig13_heatmaps,
    "table_signed_multipliers": table_signed_multipliers,
    "table_recompose16": table_recompose16,
    "table_edge_detection": table_edge_detection,
}


# the tables whose images run on a device; the rest take no arguments
DEVICE_TABLES = ("table5_sharpening", "table_edge_detection")


def rows(name: str, device="cuda") -> List[Dict]:
    """The rows of ALL[name], on ``device`` where the table has images."""
    if name in DEVICE_TABLES:
        return ALL[name](device)
    return ALL[name]()


def to_csv(rows: List[Dict]) -> str:
    """The rows as CSV, columns in order of first appearance."""
    if not rows:
        return ""
    keys = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=keys)
    w.writeheader()
    for r in rows:
        w.writerow(r)
    return buf.getvalue()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Print the paper's tables as CSV.")
    ap.add_argument("--only", default=None,
                    help="comma-separated table names (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="where the image tables run (cpu: the same torch "
                         "ops on the host)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    only = args.only.split(",") if args.only else list(ALL)
    unknown = sorted(set(only) - set(ALL))
    if unknown:
        ap.error(f"unknown table name(s) {unknown}; choose from "
                 f"{sorted(ALL)}")
    for name in ALL:
        if name in only:
            print(f"### {name}")
            print(to_csv(rows(name, dev)))


if __name__ == "__main__":
    main()
