"""Multi-pod dry run: every (architecture x input shape) cell on the
16x16 single-pod and 2x16x16 multi-pod production meshes, as the
reference's launch/dryrun.py lays them out, analysed without a device.

For every cell this builds the step's arguments as meta tensors (shapes
and dtypes, no storage; no weight is ever allocated): the params
(models.transformer.param_shapes), the optimizer state (train), the
decode state with whisper's encoder output (decode) and the inputs
(configs.input_specs).  It gives each argument leaf its sharding spec
(launch.shardings: param_spec for params and optimizer state, as
tree_shardings maps it, cache_spec for the decode state, batch_spec for
the inputs) and records
  * argument_bytes_per_device: the sum over every argument leaf of its
    bytes over the product of the mesh axes its spec names, the
    counterpart of the reference's
    compiled.memory_analysis().argument_size_in_bytes, taken from the
    shard shapes instead of a compiler;
  * flops_analytic: the model FLOPs of the cell (analytic_flops, the
    reference's formula), beside the params and active params.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
      --shape train_4k [--multi-pod] [--all] [--out experiments/dryrun_torch]

Not ported, and why:
  * compiled.memory_analysis()'s temp, output and alias sizes (and the
    bytes_per_device built from them): there is no XLA compile of the
    step for the production mesh here;
  * compiled.cost_analysis()'s HLO FLOPs and bytes: no compiled HLO;
  * collective_bytes: it parses compiled HLO text;
  * the 1- and 2-unit probes: they exist only to correct XLA's count of
    a scan body once; ``--no-probes`` is accepted and changes nothing.
The reference forces 512 host devices through XLA_FLAGS before jax
starts; this module needs no device and sets no environment variable.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import Dict, Optional

import torch

from .. import configs
from ..models import transformer as T
from ..models.sharding import (PRODUCTION_RULES, SINGLE_POD_RULES,
                               logical_axis_rules)
from ..quant import QuantConfig
from ..train import OptConfig
from ..train import optimizer as opt_mod
from . import shardings as shd
from .mesh import Mesh, make_production_mesh, mesh_axis_sizes


def analytic_flops(cfg, shape_name: str, qcfg) -> float:
    """Model FLOPs for this cell (TOTAL across chips): 6·N_active·D for
    train, 2·N_active·D for prefill, 2·N_active·B (+cache reads as flops
    for attention) per decode step; attention seq^2 term added for
    attention archs.  The 'residual_xla' backend multiplies matmul work
    by (1 + rank) — reported via the multiplier field."""
    seq, batch, kind = configs.SHAPES[shape_name]
    if cfg.family == "encdec":
        seq = min(seq, 448)
    n_act = cfg.active_param_count()
    mult = 1.0 + (qcfg.rank if qcfg.backend.startswith("residual") else 0.0)
    attn_layers = sum(1 for k in cfg.pattern if k in ("attn", "moe"))
    attn_frac = attn_layers / len(cfg.pattern) * cfg.n_layers
    if kind == "train":
        D = seq * batch
        base = 6.0 * n_act * D
        attn = 6.0 * 2.0 * batch * seq * min(seq, cfg.window or seq) \
            * cfg.n_heads * cfg.hd * attn_frac
        return base * mult + attn
    if kind == "prefill":
        D = seq * batch
        base = 2.0 * n_act * D
        attn = 2.0 * 2.0 * batch * seq * min(seq, cfg.window or seq) \
            * cfg.n_heads * cfg.hd * attn_frac
        return base * mult + attn
    # decode: one token against a seq-deep cache/state
    base = 2.0 * n_act * batch
    attn = 2.0 * 2.0 * batch * min(seq, cfg.max_seq) \
        * cfg.n_kv * cfg.hd * attn_frac
    return base * mult + attn


def cell_arguments(cfg, shape_name: str) -> Dict[str, object]:
    """The step's arguments of one cell as meta tensors, by role: params
    and the optimizer state (train), params and the inputs (prefill),
    params, the decode state and the new token (decode)."""
    seq, batch, kind = configs.SHAPES[shape_name]
    params = T.param_shapes(cfg)
    if kind == "train":
        return {"params": params,
                "opt": opt_mod.init(params, OptConfig()),
                "inputs": configs.input_specs(cfg, shape_name)}
    if kind == "prefill":
        return {"params": params,
                "inputs": configs.input_specs(cfg, shape_name)}
    s_max = min(seq, cfg.max_seq)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = torch.empty((batch, cfg.enc_seq, cfg.d_model),
                              dtype=torch.float32, device="meta")
    state = T.init_decode_state(cfg, batch, s_max, device="meta",
                                enc_out=enc_out)
    tokens = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    return {"params": params, "state": state, "inputs": {"tokens": tokens}}


def argument_bytes_per_device(args: Dict[str, object], mesh: Mesh) -> int:
    """Sum over every argument leaf of its bytes over the product of the
    mesh axes its spec names: param_spec for the params and the
    optimizer state (what tree_shardings maps), cache_spec for the decode
    state and batch_spec for the inputs."""
    total = 0
    for role, tree in args.items():
        for path, leaf in shd.tree_paths(tree):
            shape = tuple(leaf.shape)
            if role in ("params", "opt"):
                spec = shd.param_spec(path, shape, mesh)
            elif role == "state":
                spec = shd.cache_spec(mesh, shape)
            else:
                spec = shd.batch_spec(mesh, leaf.dim(), batch_size=shape[0])
            ways = shd.spec_ways(spec, mesh)
            nbytes = leaf.numel() * leaf.element_size()
            assert nbytes % ways == 0, (path, shape, spec)
            total += nbytes // ways
    return total


def analyse_cell(arch: str, shape_name: str, multi_pod: bool,
                 qcfg: Optional[QuantConfig] = None) -> Dict[str, object]:
    """One (arch, shape, mesh) cell's record."""
    cfg = configs.get(arch)
    qcfg = qcfg or QuantConfig(design="design2", backend="residual_xla",
                               rank=16)
    seq, batch, kind = configs.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = PRODUCTION_RULES if multi_pod else SINGLE_POD_RULES
    result: Dict[str, object] = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "design": qcfg.design, "backend": qcfg.backend, "rank": qcfg.rank,
    }
    with logical_axis_rules(rules, mesh_axis_sizes(mesh)):
        args = cell_arguments(cfg, shape_name)
        result["argument_bytes_per_device"] = argument_bytes_per_device(
            args, mesh)
    result["n_devices"] = mesh.size
    result["model_params"] = cfg.param_count()
    result["active_params"] = cfg.active_param_count()
    result["flops_analytic"] = analytic_flops(cfg, shape_name, qcfg)
    result["microbatches"] = 1
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every supported cell on this mesh")
    ap.add_argument("--design", default="design2")
    ap.add_argument("--backend", default="residual_xla")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted for the reference's CLI and changes "
                         "nothing: the 1/2-unit probes only corrected "
                         "XLA's count of a scan body, and nothing here "
                         "is compiled")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in configs.ARCHS:
            name = configs.get(arch).name
            for shp in configs.supported_cells(arch):
                cells.append((name, shp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    qcfg = QuantConfig(design=args.design, backend=args.backend,
                       rank=args.rank)
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shp in cells:
        tag = f"{configs.canon(arch)}__{shp}__" \
              f"{'2x16x16' if args.multi_pod else '16x16'}"
        try:
            res = analyse_cell(arch, shp, args.multi_pod, qcfg)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            gib = res["argument_bytes_per_device"] / 2**30
            print(f"OK   {tag}: {res['flops_analytic']:.3e} flops "
                  f"(analytic, all devices), {gib:.2f} GiB/dev of "
                  f"arguments")
        except Exception as e:
            failures += 1
            print(f"FAIL {tag}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=3)
    print(f"dry-run complete: {len(cells) - failures}/{len(cells)} cells OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
