"""QAT fine-tuning steps: the port's train step (``train.make_train_step``
with ``train.optimizer``'s AdamW at its default settings), one batch of
``batch`` x ``seq`` token ids a step, labels beside them, every row
drawn from the seed.

Set-up draws the weights on the device, builds the optimizer state and
the step, and drives that one object through its first ``checked_steps``
steps, which warm every shape; what they leave (each step's loss, from
the optimizer's first moment the first gradient's norms by leaf, its
embedding rows at the first batch's ids and its first-layer wq, wk and
wv, and each leaf's change over those steps) is kept for the check.  The window
then runs the same object's next steps, each loss read to the host, until
``--seconds`` has passed; the step in flight finishes and counts.  With
``--trace 1`` ``trace_steps`` more steps run under the profiler.

After the window the plain reference (``bench/reference/train.py``)
follows the same first steps from the same weights and batches.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import harness, inputs
from bench.reference import train as ref_train


@dataclasses.dataclass
class Record:
    model: Dict
    traffic: Dict
    setup_s: float
    window_s: float = 0.0
    steps: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[harness.Trace] = None
    trace_steps: int = 0
    peak_bytes: int = 0


def batches(model: Dict, seed: int, n: int, B: int, S: int):
    """n (tokens, labels) pairs of (B, S) int32, every row drawn anew."""
    rng = np.random.default_rng([int(seed), 3])
    ids = rng.integers(0, model["vocab"], (n, 2, B, S)).astype(np.int32)
    return [(ids[i, 0], ids[i, 1]) for i in range(n)]


class Program:
    """The port's train step on one set of weights and its state."""

    def __init__(self, model: Dict, quant: Dict, traffic: Dict, seed: int,
                 device):
        from repro_torch.configs import ArchConfig
        from repro_torch.quant import QuantConfig
        from repro_torch.train import OptConfig, make_train_step
        from repro_torch.train import optimizer
        self.dev = torch.device(device)
        fields = {f.name for f in dataclasses.fields(ArchConfig)}
        self.cfg = ArchConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                                 for k, v in model.items() if k in fields})
        self.qcfg = QuantConfig(design=quant["design"],
                                backend=quant["train_backend"],
                                mode=quant["mode"])
        self.ocfg = OptConfig()
        self.params = inputs.draw_params(model, seed, self.dev)
        self.state = optimizer.init(self.params, self.ocfg)
        self.step_fn = make_train_step(self.cfg, self.qcfg, self.ocfg,
                                       microbatches=traffic["microbatches"],
                                       remat=traffic["remat"])

    def step(self, tokens: np.ndarray, labels: np.ndarray) -> torch.Tensor:
        batch = {"tokens": torch.as_tensor(tokens, device=self.dev),
                 "labels": torch.as_tensor(labels, device=self.dev)}
        self.params, self.state, metrics = self.step_fn(self.params,
                                                        self.state, batch)
        return metrics["loss"]

    def leaves(self):
        return ref_train.leaves(self.params), \
            ref_train.leaves(self.state.mu)


def opt_settings() -> Dict:
    from repro_torch.train import OptConfig
    return dataclasses.asdict(OptConfig())


def set_up(model, quant, traffic, seed, device):
    """The step object driven through its checked steps: (program, what
    they left)."""
    prog = Program(model, quant, traffic, seed, device)
    B, S, n = traffic["batch"], traffic["seq"], traffic["checked_steps"]
    losses, first, seen = [], None, None
    for tokens, labels in batches(model, seed, n, B, S):
        losses.append(float(prog.step(tokens, labels)))
        if first is None:
            # the first gradient, from the first moment: (1 - b1) g
            b1 = prog.ocfg.b1
            mu = prog.leaves()[1]
            first = {k: float(v.norm()) / (1 - b1) for k, v in mu.items()}
            ids = torch.unique(torch.as_tensor(tokens, device=prog.dev)
                               .long())
            seen = ref_train.probes(mu, ids)
            seen["embed_rows"] /= 1 - b1
            del mu
    # each leaf's change: the weights drawn again, one leaf at a time
    start = ref_train.leaves(inputs.draw_params(model, seed, device))
    now = prog.leaves()[0]
    change = {}
    for k in list(start):
        change[k] = float((now[k] - start.pop(k)).norm())
    del start
    return prog, {"loss": losses, "grad_norm": first, "change": change,
                  "embed_rows": seen["embed_rows"], "layer0": seen["layer0"]}


def gaps(prog_side: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the widest relative loss gap over the checked
    steps, and by the worst leaf the gap between the program's and the
    reference's norm of the first gradient and of the change, against the
    reference's norm of the leaf or of the median leaf, whichever is
    larger (leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change); ``embed_rows``, the mean
    over the first batch's input ids of the relative gap between the two
    sides' norms of the embedding's first-gradient row (the rows of
    tokens a step leaves out lose the gradient of their lookup);
    ``grad_span``, the widest share of a first-layer projection's first
    gradient outside the row space of the layer's input, which the
    weights alone fix (``ref_train.span_share``: the float32 precision of
    the straight-through weight gradients)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog_side["loss"],
                                                    ref["loss"]))
    g_ref = ref["grad_norm"]
    g_med = float(np.median(list(g_ref.values())))

    def worst(name, keys):
        r = ref[name]
        med = float(np.median([r[k] for k in keys]))
        return max(abs(prog_side[name][k] - r[k]) / max(r[k], med)
                   for k in keys)
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    rows_p, rows_r = prog_side["embed_rows"], ref["embed_rows"]
    return {"loss": loss, "grad": worst("grad_norm", list(g_ref)),
            "change": worst("change", moving),
            "embed_rows": float(((rows_p - rows_r).abs() / rows_r).mean()),
            "grad_span": max(prog_side["span"].values())}


def span(prog_side: Dict, ref: Dict) -> Dict[str, float]:
    """The program's first-layer gradients against the span the
    reference's weights give."""
    return {k: ref_train.span_share(g, ref["basis"])
            for k, g in prog_side.pop("layer0").items()}


def control(wl, seed: int, device, tf32: bool = False) -> Dict:
    """The program's readings, and those of the reference put in the
    program's place: at 4-bit operand precision, with half of the batch
    left out (planted in the reference), and with ``tf32`` with every
    float32 product in TF32.  A state left unchanged reads 1 on
    ``change`` by construction and is not run; the step produces no
    tokens, and its answers, the loss and the updates, are what the
    numbers compare."""
    model, traffic = wl.config["model"], wl.traffic
    B, S = traffic["batch"], traffic["seq"]
    prog, seen = set_up(model, wl.config["quant"], traffic, seed, device)
    del prog
    _free()
    checked = [(torch.as_tensor(a, device=device),
                torch.as_tensor(b, device=device))
               for a, b in batches(model, seed, traffic["checked_steps"], B,
                                   S)]

    def follow(**kw):
        out = ref_train.follow(model, inputs.draw_params(model, seed, device),
                               opt_settings(), checked, device, **kw)
        _free()
        return out
    t = harness.now()
    ref = follow()
    seen["span"] = span(seen, ref)
    out = {"reference_s": harness.now() - t, "program": gaps(seen, ref),
           "reference_span": ref["span"], "program_span": seen["span"],
           "loss": {"program": seen["loss"], "reference": ref["loss"]}}
    ctls = [("int4", {"bits": 4}), ("half_batch", {"fault": "half_batch"})]
    if tf32 and torch.device(device).type == "cuda":
        ctls.append(("tf32", {"tf32": True}))
    for name, kw in ctls:
        out[name] = gaps(follow(**kw), ref)
    return out


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(wl, seed: int, seconds: float, trace: bool, t_proc: float,
        device="cuda", model: Optional[Dict] = None,
        traffic: Optional[Dict] = None) -> Dict:
    model = model or wl.config["model"]
    traffic = traffic or wl.traffic
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import _build
        t = harness.now()
        _build.build()
        print(f"[bench] kernel build or cache: {harness.now() - t:.2f}s",
              file=sys.stderr)
    prog, seen = set_up(model, wl.config["quant"], traffic, seed, dev)
    rec = Record(model, traffic, harness.now() - t_proc)
    B, S = traffic["batch"], traffic["seq"]
    pool = batches(model, seed + 1, traffic["max_steps"], B, S)
    t0 = harness.now()
    while harness.now() - t0 < seconds:
        if rec.steps == len(pool):
            raise RuntimeError("raise the traffic's max_steps")
        rec.losses.append(float(prog.step(*pool[rec.steps])))
        rec.steps += 1
    rec.window_s = harness.now() - t0
    if dev.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        n = traffic["trace_steps"]
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                for tokens, labels in pool[rec.steps:rec.steps + n]:
                    with record_function("bench.train_step"):
                        float(prog.step(tokens, labels))
        rec.trace = harness.Trace.from_profiler(prof)
        rec.trace_steps = n
    del prog
    _free()
    t = harness.now()
    checked = [(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev))
               for a, b in batches(model, seed, traffic["checked_steps"], B,
                                   S)]
    ref = ref_train.follow(model, inputs.draw_params(model, seed, dev),
                           opt_settings(), checked, dev)
    seen["span"] = span(seen, ref)
    nums = gaps(seen, ref)
    print(f"[bench] reference: {harness.now() - t:.1f}s; program {seen['loss']}"
          f" reference {ref['loss']}; readings {nums}", file=sys.stderr)
    checks = {n: {"value": nums[n], "limit": lim}
              for n, lim in wl.limits.items()}
    e2e = {"setup_s": rec.setup_s,
           "train_tok_s": rec.steps * B * S / rec.window_s,
           "peak_mem_gib": rec.peak_bytes / 2 ** 30}
    return {"record": rec, "e2e": e2e, "checks": checks,
            "attempted": rec.steps, "failed": 0}
