"""QAT training launcher: the train step on one card with
checkpoint/restart, stateless deterministic data and straggler logging.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 200 --design design2 --backend residual_xla \
        --ckpt-dir ckpt [--smoke] [--device cpu]

Every dense projection runs forward through the approximate multiplier
(``--backend``: 'xla'/'pallas_legacy' launch the lut_matmul kernel,
'residual'/'residual_xla' the residual_matmul kernel, 'delta'/'pallas'
the delta_matmul kernel) and backward through the exact product (the
straight-through estimator).  ``residual_xla`` (rank-32 correction) is
the cheaper emulation for real models; ``xla`` is exact to the
multiplier.

  * restart-safe: restores params, optimizer state and step from the
    newest intact checkpoint (corrupt ones are skipped via manifest
    hashes);
  * data: batch(step) is stateless, so there is no loader state;
  * stragglers: a step slower than ``--straggler-factor`` x the EWMA of
    step times is reported.
  * ``--plan FILE``: QAT through a per-layer design plan (calib.plan):
    the raw weights are wrapped inside the loss with the plan's bank
    index and compensation tables (make_plan_injector), so every
    projection runs forward through its layer's design on the
    delta_matmul kernel, whatever ``--backend`` says.
  * ``--mesh host`` (the default): the step runs inside the logical
    axis rules of the one-card (1, 1) mesh (launch.mesh.make_host_mesh,
    models.sharding.SINGLE_POD_RULES), as the reference's host mesh: on
    one card every axis has size 1, so the rules place nothing and the
    losses are those of a run without them.  ``single`` and ``multi``
    (the 16x16 and 2x16x16 production meshes, 256 and 512 devices) are
    refused at parse time: the port runs on one card (launch.dryrun
    analyses those meshes without devices).
  * ``--trace-out PATH``: records the run's spans (repro_torch.trace: the
    step, its backward and optimizer, each layer and its remat
    recompute, attention, each projection, the head; host and device
    time) and writes them to PATH as a Chrome trace.
Float32 products run at full float32 precision (TF32 off), as the
reference's HIGHEST precision.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import torch

from .. import configs, trace
from ..data import DataConfig, host_batch
from ..device import resolve
from ..models import transformer as T
from ..models.sharding import SINGLE_POD_RULES, logical_axis_rules
from ..quant import QuantConfig
from ..train import OptConfig, make_train_step
from ..train import checkpoint as ckpt
from ..train import optimizer as opt_mod
from .mesh import make_host_mesh, make_production_mesh, mesh_axis_sizes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--design", default="design2")
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--quant-mode", default="asym_u8",
                    choices=["asym_u8", "sym_i8"])
    ap.add_argument("--plan", default=None, metavar="FILE",
                    help="DesignPlan JSON: QAT through its per-layer "
                         "designs")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host",
                    help="host: the one-card mesh; single / multi (256 / "
                         "512 devices) are refused")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="trace the run's steps and layers (host and "
                         "device time) into a Chrome trace at PATH")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh != "host":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
        ap.error(f"--mesh {args.mesh} is not ported to one machine: it "
                 f"needs the {'x'.join(map(str, mesh.shape))} mesh of "
                 f"{mesh.size} devices, and this machine has "
                 f"{torch.cuda.device_count()} CUDA card(s); the port "
                 f"trains on one card (--mesh host)")
    return args


@dataclasses.dataclass
class TrainResult:
    losses: List[float]        # loss of every step run
    grad_norms: List[float]
    step_s: List[float]        # wall seconds of every step run
    start: int                 # step restored from (0 without checkpoint)
    peak_bytes: int            # device memory high-water mark (cuda)
    params: dict
    opt_state: opt_mod.OptState


def _save(ckpt_dir: str, step: int, params, opt_state) -> None:
    t0 = time.perf_counter()
    path = ckpt.save(ckpt_dir, step, {"params": params, "opt": opt_state})
    print(f"[train] checkpoint {path} saved in "
          f"{time.perf_counter() - t0:.1f}s")


def run(args: argparse.Namespace, cfg=None) -> TrainResult:
    """Train as ``main`` does.  ``cfg``: the model config to train in place
    of ``--arch``'s (a depth-cut variant of it, say)."""
    dev = resolve(args.device)
    mesh = make_host_mesh(dev)
    with logical_axis_rules(SINGLE_POD_RULES, mesh_axis_sizes(mesh)):
        return _train(args, cfg, dev)


def _train(args: argparse.Namespace, cfg, dev: torch.device) -> TrainResult:
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    if cfg is None:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get(args.arch))
    qcfg = QuantConfig(design=args.design, backend=args.backend,
                       mode=args.quant_mode)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                     total_steps=args.steps,
                     compress_grads=args.compress_grads)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, device=dev)
    opt_state = opt_mod.init(params, ocfg)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, start = ckpt.restore(args.ckpt_dir,
                                       {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"[train] restored checkpoint at step {start}")
    params_transform = None
    if args.plan:
        from ..calib import DesignPlan, make_plan_injector
        plan = DesignPlan.load(args.plan)
        params_transform = make_plan_injector(params, plan, qcfg)
        print(f"[train] QAT through design plan {args.plan} (histogram "
              f"{plan.histogram()})")
    step_fn = make_train_step(cfg, qcfg, ocfg,
                              microbatches=args.microbatches,
                              remat=not args.smoke,
                              params_transform=params_transform)
    res = TrainResult([], [], [], start, 0, params, opt_state)
    ewma = None
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in host_batch(dcfg, step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])        # waits for the device
        dt = time.perf_counter() - t0
        res.losses.append(loss)
        res.grad_norms.append(float(metrics["grad_norm"]))
        res.step_s.append(dt)
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma and step > start + 3:
            print(f"[train][straggler] step {step} took {dt:.2f}s "
                  f"(ewma {ewma:.2f}s)")
        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"({dt * 1e3:.0f} ms)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args.ckpt_dir, step + 1, params, opt_state)
    if args.ckpt_dir:
        _save(args.ckpt_dir, args.steps, params, opt_state)
    if dev.type == "cuda":
        res.peak_bytes = torch.cuda.max_memory_allocated(dev)
    res.params, res.opt_state = params, opt_state
    return res


def main(argv=None) -> float:
    """Run the launcher; returns the final loss."""
    args = parse_args(argv)
    with trace.recording(args.trace_out):
        res = run(args)
    loss = res.losses[-1] if res.losses else float("nan")
    print(f"[train] done at step {len(res.losses) + res.start}, final loss "
          f"{loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
