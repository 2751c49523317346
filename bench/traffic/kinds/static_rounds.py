"""Serving in static rounds: a closed loop of one client that sends a
batch of ``batch`` requests of ``prompt_len`` token ids and sends the
next batch when every request of the last one has its ``gen_len``
tokens.  A round is the port's serving engine as ``launch.serve`` drives
it: a fresh decode state, one fused prefill of the batch, then
``gen_len - 1`` batched greedy decode steps, each step's tokens read to
the host as they come.

Set-up draws the weights on the device from the seed, runs the serving
ladder (``serve.prepare_params``: prequantize, calibrate, compensation
columns, merged projections) and one round's prefill and two decode
steps on a throwaway state.  Rounds then run until ``--seconds`` has
passed; the round in flight finishes and counts.  With ``--trace 1``
``trace_rounds`` more rounds run under the profiler.

After the window one finished round, drawn from the seed, is run again
by the plain reference (``bench/reference/decoder.py``) with the
program's served tokens as its inputs; the numbers compared are in
``checks``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import harness, inputs  # noqa: F401  (inputs: also for bench/control.py)
from bench.reference.decoder import Reference


@dataclasses.dataclass
class Round:
    t_start: float
    t_first: float            # the prefill's tokens on the host
    times: List[float]        # each decode step's tokens on the host
    prompts: np.ndarray       # (B, P)
    served: np.ndarray        # (B, G)
    logits: Optional[torch.Tensor] = None  # (B, G, V) that chose them
    cache: Optional[list] = None   # the round's final KV cache, by layer


@dataclasses.dataclass
class Record:
    """What the window left for the metrics and the check."""
    model: Dict
    traffic: Dict
    setup_s: float
    window_s: float
    rounds: List[Round]
    trace: Optional[harness.Trace] = None
    trace_rounds: int = 0
    peak_bytes: int = 0


class Program:
    """The port's serving engine on one set of weights."""

    def __init__(self, model: Dict, quant: Dict, seed: int, device):
        from repro_torch.configs import ArchConfig
        from repro_torch.launch import serve
        from repro_torch.train import make_prefill_step, make_serve_step
        self.model = model
        self.dev = torch.device(device)
        fields = {f.name for f in dataclasses.fields(ArchConfig)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in model.items() if k in fields}
        self.cfg = ArchConfig(**kw)
        args = serve.build_parser().parse_args([
            "--design", quant["design"], "--quant-mode", quant["mode"],
            "--backend", quant["backend"],
            "--calibrate", str(quant["calibrate"]),
            "--requests", str(inputs.CALIB_REQUESTS),
            "--prompt-len", str(inputs.CALIB_PROMPT_LEN)])
        self.qcfg = serve.quant_config(args)
        params = inputs.draw_params(model, seed, self.dev)
        self.params, self.notes, _ = serve.prepare_params(
            params, self.cfg, self.qcfg, args, device=self.dev)
        del params
        self.prefill = make_prefill_step(self.cfg, self.qcfg)
        self.step = make_serve_step(self.cfg, self.qcfg)

    def new_state(self, batch: int, s_max: int):
        from repro_torch.models import transformer as T
        return T.init_decode_state(self.cfg, batch, s_max, device=self.dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def one_round(prog: Program, prompts: np.ndarray, G: int,
              traced: bool = False, keep_logits: bool = False) -> Round:
    """One static round.  ``keep_logits``: keep, on the device, the logits
    row that chose each served token (for the check)."""
    from torch.profiler import record_function

    def label(name):
        return record_function("bench." + name) if traced \
            else contextlib.nullcontext()

    B, P = prompts.shape
    kept = []
    t_start = harness.now()
    with label("prefill"):
        state = prog.new_state(B, P + G)
        tok, logits, state = prog.prefill(
            prog.params, state, torch.as_tensor(prompts, device=prog.dev))
        if keep_logits:
            kept.append(logits[:, -1].clone())
        del logits
        out = [tok.cpu()]
    times = [harness.now()]
    for _ in range(G - 1):
        with label("decode_step"):
            tok, logits, state = prog.step(prog.params, state, tok)
            if keep_logits:
                kept.append(logits[:, -1].clone())
            out.append(tok.cpu())
        times.append(harness.now())
    if not keep_logits:
        return Round(t_start, times[0], times, prompts,
                     torch.cat(out, 1).numpy())
    written = P + G - 1                  # the last token is never fed
    cache = [(c["k"][:, :, :written], c["v"][:, :, :written])
             for c in state["caches"]]
    return Round(t_start, times[0], times, prompts, torch.cat(out, 1).numpy(),
                 torch.stack(kept, 1), cache)


def serve_window(prog: Program, traffic: Dict, seed: int, seconds: float,
                 trace: bool) -> Record:
    """Rounds for ``seconds`` (the last one finishes), then with ``trace``
    the traced rounds."""
    B, P, G = traffic["batch"], traffic["prompt_len"], traffic["gen_len"]
    pool = inputs.round_prompts(prog.model, seed, traffic["max_rounds"], B, P)
    checked = inputs.sample_index(seed, traffic["sample_among"])
    rounds = []
    t0 = harness.now()
    while harness.now() - t0 < seconds or len(rounds) <= checked:
        if len(rounds) == len(pool):
            raise RuntimeError(f"more than {len(pool)} rounds in the window: "
                               f"raise the traffic's max_rounds")
        rounds.append(one_round(prog, pool[len(rounds)], G,
                                keep_logits=len(rounds) == checked))
    window_s = harness.now() - t0
    rec = Record(prog.model, traffic, 0.0, window_s, rounds)
    if prog.dev.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(prog.dev)
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        n = traffic["trace_rounds"]
        extra = inputs.round_prompts(prog.model, seed + 1, n, B, P)
        acts = [ProfilerActivity.CPU]
        if prog.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("bench.window"):
                for r in range(n):
                    one_round(prog, extra[r], G, traced=True)
                _sync(prog.dev)
        rec.trace = harness.Trace.from_profiler(prof)
        rec.trace_rounds = n
    return rec


def cache_errors(ref_cache: Dict, cache: list) -> List[float]:
    """Each layer's |k - k_ref| / |k_ref| and the same of v, the larger of
    the two, over every position the round wrote."""
    out, layer = [], 0
    for k_stack, v_stack in cache:
        for k, v in zip(k_stack, v_stack):
            kr, vr = (t.float() for t in ref_cache[layer])
            out.append(max(float((k.float().to(kr.device) - kr).norm()
                                 / kr.norm()),
                           float((v.float().to(vr.device) - vr).norm()
                                 / vr.norm())))
            layer += 1
    return out


def round_numbers(ref: tuple, served: np.ndarray, logits: torch.Tensor,
                  cache: list) -> Dict[str, float]:
    """What a round says against the reference's (logits (B, G, V), KV
    cache by layer): ``cache_err``, the median over the layers of each
    layer's relative distance of k or v (the larger) from the
    reference's, over every position the round wrote (``cache_err_max``
    the widest: it swings with the calibration at layers 1-3); ``gap``, the widest amount by which a served token's reference
    logit lies below the reference's best; ``logit_err``, the median over
    the served positions of |logits - reference| over |reference - its
    mean| (2-norms over the vocabulary); ``mismatch``, the share of served
    tokens that are not the reference's best."""
    ref_logits, ref_cache = ref
    ref_l = ref_logits.float()
    logits = logits.to(ref_l.device).float()
    tok = torch.as_tensor(served, device=ref_l.device).long()
    gap = ref_l.amax(-1) - ref_l.gather(-1, tok[..., None])[..., 0]
    err = (logits - ref_l).norm(dim=-1) / \
        (ref_l - ref_l.mean(-1, keepdim=True)).norm(dim=-1)
    layers = cache_errors(ref_cache, cache)
    return {"cache_err": float(np.median(layers)),
            "cache_err_max": max(layers), "gap": float(gap.max()),
            "logit_err": float(err.median()),
            "mismatch": float((gap > 0).float().mean()),
            "cache_err_by_layer": layers}


def reference_logits(model: Dict, params: Dict, rnd: Round, device,
                     bits: int = 8, keep_hidden: bool = False):
    """The reference's teacher-forced logits of a round and its KV cache
    (and with ``keep_hidden`` the head's input at the served positions)."""
    dev = torch.device(device)
    ref = Reference(model, params, dev, bits=bits)
    ref.calibrate(torch.as_tensor(inputs.calibration_prompts(model),
                                  device=dev))
    out = ref.serve_round(torch.as_tensor(rnd.prompts, device=dev),
                          torch.as_tensor(rnd.served, device=dev))
    return out + (ref.hidden,) if keep_hidden else out


def head_residual(embed: torch.Tensor, logits: torch.Tensor) -> float:
    """How far the served logits lie from the tied head's column space:
    the widest, over the rows, of |l - E x| / |l|, x the input that fits
    the row l best (least squares in float64 over the (V, D) table E).
    The rows of x E^T span nothing else, so what is left is the head
    GEMM's own rounding: about 1e-7 in float32, 1e-4 and more when its
    operands are rounded to TF32 or bfloat16.  The hidden state below the
    head, which carries the 8-bit noise of every layer, drops out."""
    E = embed.double()
    chol = torch.linalg.cholesky(E.T @ E)
    L = logits.reshape(-1, logits.shape[-1]).to(E.device).double()
    x = torch.cholesky_solve((L @ E).T, chol)              # (D, rows)
    res = (L - (E @ x).T).norm(dim=1) / L.norm(dim=1)
    return float(res.max())


def check(rec: Record, model: Dict, seed: int, limits: Dict,
          device) -> Dict[str, Dict[str, float]]:
    """The sampled round against the reference: each number compared with
    its limit."""
    rnd = next(r for r in rec.rounds if r.logits is not None)
    t = harness.now()
    params = inputs.draw_params(model, seed, device)
    nums = round_numbers(reference_logits(model, params, rnd, device),
                         rnd.served, rnd.logits, rnd.cache)
    nums["head_err"] = head_residual(params["embed"], rnd.logits)
    print(f"[bench] reference: {harness.now() - t:.1f}s; readings "
          f"{nums}", file=sys.stderr)
    return {n: {"value": nums[n], "limit": lim} for n, lim in limits.items()}


def control(wl, seed: int, device, tf32: bool = False) -> Dict:
    """The program's readings on one round at the cell's load, and the
    controls', each put in the program's place, its tokens those its
    logits put first: the reference at 4-bit operand precision; with
    ``tf32`` the reference's head in TF32 (on its own float32 hidden
    state: ``head_err`` reads nothing below the head)."""
    model, traffic = wl.config["model"], wl.traffic
    dev = torch.device(device)
    prog = Program(model, wl.config["quant"], seed, dev)
    prompts = inputs.round_prompts(model, seed, 1, traffic["batch"],
                                   traffic["prompt_len"])[0]
    rnd = one_round(prog, prompts, traffic["gen_len"], keep_logits=True)
    del prog
    free()
    params = inputs.draw_params(model, seed, dev)
    t = harness.now()
    ref_logits, ref_cache, hidden = reference_logits(model, params, rnd, dev,
                                                     keep_hidden=True)
    ref = (ref_logits, ref_cache)
    out = {"reference_s": harness.now() - t,
           "program": round_numbers(ref, rnd.served, rnd.logits, rnd.cache)}
    out["program"]["head_err"] = head_residual(params["embed"], rnd.logits)
    out["reference_head_err"] = head_residual(params["embed"], ref_logits)
    # a served token altered where it is produced, at a position drawn
    # from the seed: what the gap reads of it
    altered = rnd.served.copy()
    b, g = np.random.default_rng([int(seed), 4]).integers(
        0, altered.shape, size=2)
    altered[b, g] = (altered[b, g] + 1) % model["vocab"]
    out["token_altered"] = round_numbers(ref, altered, rnd.logits,
                                         rnd.cache)["gap"]
    if tf32 and dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            t32 = hidden @ params["embed"].T
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out["tf32"] = {"head_err": head_residual(params["embed"], t32),
                       "logit_err_vs_reference": float(
                           ((t32 - ref_logits).norm(dim=-1)
                            / ref_logits.norm(dim=-1)).max())}
        del t32
    del hidden
    ctl_logits, ctl_cache = reference_logits(model, params, rnd, dev, bits=4)
    ctl = [(torch.stack([ctl_cache[l][0] for l in sorted(ctl_cache)]),
            torch.stack([ctl_cache[l][1] for l in sorted(ctl_cache)]))]
    out["int4"] = round_numbers(ref, ctl_logits.argmax(-1).cpu().numpy(),
                                ctl_logits, ctl)
    out["int4"]["head_err"] = head_residual(params["embed"], ctl_logits)
    return out


def free() -> None:
    """Hand the memory of dropped objects back to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(wl, seed: int, seconds: float, trace: bool, t_proc: float,
        device="cuda", model: Optional[Dict] = None,
        traffic: Optional[Dict] = None) -> Dict:
    """One run of a serving cell.  ``model`` and ``traffic`` stand in for
    the cell's own (the CPU tests' smoke sizes)."""
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
    prog = Program(model, wl.config["quant"], seed, dev)
    B, P, G = traffic["batch"], traffic["prompt_len"], traffic["gen_len"]
    warm = inputs.round_prompts(model, seed + 2, 1, B, P)[0]
    state = prog.new_state(B, P + G)
    tok, _, state = prog.prefill(prog.params, state,
                                 torch.as_tensor(warm, device=dev))
    for _ in range(2):
        tok, _, state = prog.step(prog.params, state, tok)
    tok.cpu()
    del state, tok
    setup_s = harness.now() - t_proc

    rec = serve_window(prog, traffic, seed, seconds, trace)
    rec.setup_s = setup_s
    print("[bench] rounds (prefill ms, round s): " + ", ".join(
        f"({1e3 * (r.t_first - r.t_start):.1f}, "
        f"{r.times[-1] - r.t_start:.3f})" for r in rec.rounds),
        file=sys.stderr)
    del prog
    free()
    checks = check(rec, model, seed, wl.limits, dev)
    tokens = len(rec.rounds) * B * (P + G)
    gaps = [b - a for r in rec.rounds for a, b in zip(r.times, r.times[1:])
            for _ in range(B)]
    e2e = {"setup_s": setup_s,
           "serve_tok_s": tokens / rec.window_s,
           "itl_ms_p95": harness.percentile(gaps, 95) * 1e3,
           "peak_mem_gib": rec.peak_bytes / 2 ** 30}
    return {"record": rec, "e2e": e2e, "checks": checks,
            "attempted": len(rec.rounds) * B, "failed": 0}
