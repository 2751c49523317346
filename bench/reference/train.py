"""Plain PyTorch reference of the QAT train step of a dense decoder.

The forward of every projection is the program's straight-through
product: the value of the design-2 approximate product of the uint8
codes (both operands quantized per tensor on every call, compensated,
dequantized: ``decoder.Reference.qdot`` with one call's dynamic range),
the gradient of the exact float32 product.  Attention is causal over
float32 k and v, the head tied, the loss the mean next-token NLL.
AdamW with global-norm clipping, linear warm-up and cosine decay
follows the configuration's optimizer settings.  It imports nothing of
the program.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..arith import head_dim
from .decoder import Reference

def leaves(params: Dict) -> Dict[str, torch.Tensor]:
    """The params' leaves by path (``units.0.attn.wq``), stacked over the
    layers as the program keeps them."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}.{k}")
            else:
                out[f"{path}.{k}"] = v
    walk(params["units"][0], "units.0")
    return out


class Step:
    """The model's loss and the optimizer, on the given leaves (updated in
    place)."""

    def __init__(self, model: Dict, params: Dict, opt: Dict, device,
                 bits: int = 8, fault: str = ""):
        self.m, self.opt, self.bits, self.fault = model, opt, bits, fault
        self.dev = torch.device(device)
        self.p = {k: v.detach() for k, v in leaves(params).items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.step = 0
        self.ref = Reference(model, {}, device, bits=bits)

    def _qdot(self, ref, x, w):
        """The straight-through product of x (..., K) and w (K, N)."""
        exact = x @ w
        with torch.no_grad():
            rows = x.reshape(-1, x.shape[-1])
            group = torch.zeros(rows.shape[0], dtype=torch.long,
                                device=x.device)
            ref.qw.clear()                 # the weights move every step
            y = ref.qdot(("w",), rows, w, group, 1).reshape(exact.shape)
        return exact + (y - exact.detach())

    def loss(self, p, tokens, labels):
        m, ref = self.m, self.ref
        if self.fault == "half_batch":        # the mean over the rest
            tokens, labels = tokens[: len(tokens) // 2], labels[
                : len(labels) // 2]
        B, S = tokens.shape
        H, Kv = m["n_heads"], m["n_kv"]
        hd = head_dim(m)
        x = p["embed"][tokens.long()]
        pos = torch.arange(S, device=self.dev)
        mask = pos[None, :] <= pos[:, None]
        for l in range(m["n_layers"]):
            h = Reference.rmsnorm(x, p["units.0.norm1"][l])
            q = self._qdot(ref, h, p["units.0.attn.wq"][l]).reshape(B, S, H, hd)
            k = self._qdot(ref, h, p["units.0.attn.wk"][l]).reshape(B, S, Kv,
                                                                    hd)
            v = self._qdot(ref, h, p["units.0.attn.wv"][l]).reshape(B, S, Kv,
                                                                    hd)
            q, k = ref.rope(q, pos), ref.rope(k, pos)
            qg = q.reshape(B, S, Kv, H // Kv, hd)
            lg = torch.einsum("bsngd,btnd->bngst", qg, k) / math.sqrt(hd)
            lg = torch.where(mask, lg, torch.full_like(lg, -1e30))
            att = torch.einsum("bngst,btnd->bsngd", torch.softmax(lg, -1), v)
            x = x + self._qdot(ref, att.reshape(B, S, H * hd),
                               p["units.0.attn.wo"][l])
            h2 = Reference.rmsnorm(x, p["units.0.norm2"][l])
            up = self._qdot(ref, h2, p["units.0.mlp.w_up"][l])
            x = x + self._qdot(ref, torch.square(torch.relu(up)),
                               p["units.0.mlp.w_down"][l])
        x = Reference.rmsnorm(x, p["final_norm"])
        logp = torch.log_softmax(x @ p["embed"].T, -1)
        return -logp.gather(-1, labels.long()[..., None]).mean()

    def lr(self) -> float:
        o, s = self.opt, self.step
        warm = min(s / max(o["warmup_steps"], 1), 1.0)
        prog = min(max((s - o["warmup_steps"])
                       / max(o["total_steps"] - o["warmup_steps"], 1), 0.0),
                   1.0)
        return o["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi
                                                                * prog)))

    def run(self, tokens, labels) -> Dict[str, float]:
        """One step; returns its loss and each leaf's gradient as the
        optimizer gets it (clipped), and the gradients' norms."""
        live = {k: v.requires_grad_() for k, v in self.p.items()}
        loss = self.loss(live, tokens, labels)
        grads = torch.autograd.grad(loss, list(live.values()))
        with torch.no_grad():
            g = dict(zip(live, grads))
            for v in live.values():
                v.requires_grad_(False)
            gnorm = math.sqrt(sum(float((x.double() ** 2).sum())
                                  for x in g.values()))
            clip = min(1.0, self.opt["grad_clip"] / max(gnorm, 1e-12))
            self.step += 1
            b1, b2, eps = self.opt["b1"], self.opt["b2"], self.opt["eps"]
            c1, c2 = 1 - b1 ** self.step, 1 - b2 ** self.step
            lr, wd = self.lr(), self.opt["weight_decay"]
            for k, p in self.p.items():
                gk = g[k] * clip
                self.mu[k].mul_(b1).add_((1 - b1) * gk)
                self.nu[k].mul_(b2).add_((1 - b2) * gk * gk)
                upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + eps)
                p.sub_(lr * (upd + wd * p))
                g[k] = gk
        return {"loss": float(loss.detach()), "grads": g,
                "grad_norm": {k: float(v.norm()) for k, v in g.items()}}


def span_basis(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis (D, n), float64, of the row space of the first
    layer's input over ``tokens``: rmsnorm scales each row, so that space
    is spanned by the embedding's rows at the tokens' ids times the first
    norm's gain, all known from the weights alone."""
    ids = torch.unique(tokens.long())
    rows = params["embed"][ids].double() \
        * params["units.0.norm1"][0].double()
    return torch.linalg.qr(rows.T)[0]


def span_share(g: torch.Tensor, basis: torch.Tensor) -> float:
    """The share of a first-layer projection's gradient g (D, N) outside
    the basis's span.  In exact arithmetic g = X^T dY lies in the row
    space of X, the layer's input; rounding X to TF32 or bfloat16 before
    the product moves it out by about a thousandth, float32 by about
    1e-7.  A gradient that is all zero reads 1."""
    g = g.to(basis.device).double()
    if not bool(g.any()):
        return 1.0                       # no gradient at all
    res = g - basis @ (basis.T @ g)
    return float(res.norm() / g.norm())


LAYER0 = ("units.0.attn.wq", "units.0.attn.wk", "units.0.attn.wv")


def probes(g: Dict[str, torch.Tensor], ids: torch.Tensor) -> Dict:
    """What a first gradient ``g`` (by leaf, as the optimizer gets it)
    shows beyond its norms, on the host: ``embed_rows``, the norms of the
    tied embedding's rows at the first batch's input ids ``ids`` (unique),
    the rows the embedding's lookup reaches; ``layer0``, the first
    layer's wq, wk and wv gradients (for ``span_share``)."""
    return {"embed_rows": g["embed"][ids].norm(dim=1).cpu(),
            "layer0": {k: g[k][0].to("cpu", copy=True) for k in LAYER0}}


def follow(model: Dict, params: Dict, opt: Dict, batches: List, device,
           bits: int = 8, fault: str = "", tf32: bool = False) -> Dict:
    """The first len(batches) steps from ``params``: each step's loss, the
    first step's gradient norms by leaf, its ``embed_rows`` and the share
    of its first-layer gradients outside their exact span (``span``), the
    norm of each leaf's change over the steps, and the ``basis`` of that
    span.  ``fault="half_batch"`` plants that fault: the loss is the mean
    over the first half of each batch's rows.  ``tf32``: every float32
    product in TF32 (the control)."""
    st = Step(model, params, opt, device, bits, fault)
    start = {k: v.clone() for k, v in st.p.items()}
    tokens0 = batches[0][0]
    basis = span_basis(st.p, tokens0)
    losses, first, seen = [], None, None
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for tokens, labels in batches:
            out = st.run(tokens, labels)
            losses.append(out["loss"])
            if first is None:
                first = out["grad_norm"]
                seen = probes(out["grads"], torch.unique(tokens0.long()))
            del out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    change = {k: float((st.p[k] - start[k]).norm()) for k in st.p}
    return {"loss": losses, "grad_norm": first, "change": change,
            "embed_rows": seen["embed_rows"], "basis": basis,
            "span": {k: span_share(v, basis)
                     for k, v in seen["layer0"].items()}}
