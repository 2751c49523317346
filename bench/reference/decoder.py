"""Plain PyTorch reference of the served dense decoder.

It works out again, from the benchmark's own inputs, everything the
program derives: each weight's uint8 quantization, the calibration pass
(token by token, dynamic per-call activation quantization) and the
static activation scales it fixes, the mean-field compensation, the
design-2 products, attention over a bfloat16 KV cache, the norms and
the tied head.
It imports nothing of the program.

The approximate product sums are exact integers: the exact part is a
float64 matmul of the codes, and the table's delta part is a sum over
the 256 weight codes of int8 matmuls (the delta split into two 7-bit
planes against the one-hot of the weight code), which is exact in int32.

Layers run one at a time over every position of a pass, each position
belonging to a "call" (a prefill, or one decode step of all the
requests), so that per-call arithmetic (the calibration's dynamic
quantization ranges) is that of the program's calls.
``bits=4`` computes the same model with every operand rounded to 4-bit
precision (the control: the precision below the configuration's 8-bit
products).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..arith import head_dim
from .multiplier import product_table


class Products:
    """Exact design-2 product sums sum_k approx(a[m, k], b[k, n])."""

    def __init__(self, device):
        self.device = torch.device(device)
        prod = product_table()
        r = np.arange(256, dtype=np.int64)
        delta = prod - r[:, None] * r[None, :]          # <= 0
        if delta.max() > 0 or -delta.min() >= 1 << 14:
            raise ValueError("delta table outside the two 7-bit planes")
        neg = -delta
        # [w, a] rows: the delta of code a against weight code w
        self.hi = torch.as_tensor((neg >> 7).T.astype(np.int8)).to(device)
        self.lo = torch.as_tensor((neg & 127).T.astype(np.int8)).to(device)
        err = delta.astype(np.float64)
        self.mu_r = torch.as_tensor(err.mean(1)).to(device)   # by code a
        self.mu_c = torch.as_tensor(err.mean(0)).to(device)   # by code b
        self.mu = float(err.mean())

    def _int_mm(self, a, b):
        if a.is_cuda:
            return torch._int_mm(a, b)
        return (a.double() @ b.double()).to(torch.int32)

    def sums(self, qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
        """qa (M, K) codes 0-255 (any integer dtype), qw (K, N) uint8 ->
        (M, N) float64 holding the exact integer sums."""
        M = qa.shape[0]
        exact = qa.double() @ qw.double()
        idx = qa.long()
        if M < 16:                       # the int8 GEMM takes 17 rows up
            idx = torch.cat([idx, idx.new_zeros((16 - M, idx.shape[1]))])
        qwt = qw.t().contiguous()        # (N, K): K-major for both sides
        acc = None
        for w in range(256):
            onehot = torch.eq(qwt, w).view(torch.int8).t()
            a = torch.cat([self.hi[w][idx], self.lo[w][idx]])
            part = self._int_mm(a, onehot)
            acc = part if acc is None else acc.add_(part)
        Mp = idx.shape[0]
        delta = 128 * acc[:M].double() + acc[Mp:Mp + M].double()
        return exact - delta


def _round4(q: torch.Tensor) -> torch.Tensor:
    """An 8-bit code at 4-bit precision: the high nibble, the low nibble
    at its midpoint."""
    return (q.to(torch.int32) & 0xF0) | 8


class QWeight:
    """One weight matrix (K, N), quantized per tensor to uint8 codes."""

    def __init__(self, w: torch.Tensor, products: Products, bits: int):
        lo, hi = w.min(), w.max()
        scale = torch.clamp_min((hi - lo) / torch.tensor(255.0, device=w.device),
                                1e-8)
        zp = torch.clamp(torch.round(-lo / scale), 0, 255)
        q = torch.clamp(torch.round(w / scale) + zp, 0, 255).to(torch.int32)
        if bits == 4:
            q = _round4(q)
        self.q = q.to(torch.uint8)
        self.scale, self.zp = float(scale), float(zp)
        self.colsum = q.double().sum(0)
        self.comp_col = products.mu_c[q.long()].sum(0)


def quant_act(x: torch.Tensor, sx: torch.Tensor, zx: torch.Tensor,
              bits: int) -> torch.Tensor:
    """uint8 codes of x (R, K) under per-row scale and zero point (R, 1)."""
    q = torch.clamp(torch.round(x / sx) + zx, 0, 255).to(torch.int32)
    return _round4(q) if bits == 4 else q


def dynamic_scales(x: torch.Tensor, group: torch.Tensor, n_groups: int):
    """Per-call min/max quantizers: (scale, zp) per row, from the min and
    max over the rows of the row's group (call)."""
    lo = torch.full((n_groups,), float("inf"), device=x.device)
    hi = torch.full((n_groups,), float("-inf"), device=x.device)
    lo = lo.scatter_reduce(0, group, x.amin(1), "amin")
    hi = hi.scatter_reduce(0, group, x.amax(1), "amax")
    scale = torch.clamp_min((hi - lo) / torch.tensor(255.0, device=x.device),
                            1e-8)
    zp = torch.clamp(torch.round(-lo / scale), 0, 255)
    return scale[group][:, None], zp[group][:, None]


def static_scale(lo: float, hi: float) -> Tuple[float, float]:
    """The static quantizer fixed by a site's calibrated range."""
    scale = max((hi - lo) / 255.0, 1e-8)
    zp = float(np.clip(np.round(-lo / scale), 0, 255))
    return float(np.float32(scale)), zp


class Calls:
    """How the rows of a pass group into the program's calls: the rows of
    x (B, L, D) flattened call by call, each call's rows in the program's
    token order (request-major, then position)."""

    def __init__(self, B: int, L: int, spans: List[Tuple[int, int]],
                 device):
        order, group = [], []
        for g, (s, e) in enumerate(spans):
            for b in range(B):
                for p in range(s, e):
                    order.append(b * L + p)
                    group.append(g)
        self.B, self.L, self.n = B, L, len(spans)
        self.order = torch.tensor(order, device=device)
        self.group = torch.tensor(group, device=device)
        self.bounds = []
        at = 0
        for s, e in spans:
            self.bounds.append((at, at + B * (e - s)))
            at += B * (e - s)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.B * self.L, -1)[self.order]

    def unrows(self, r: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(r)
        out[self.order] = r
        return out.reshape(self.B, self.L, -1)


class Reference:
    """The model of one configuration on one set of weights."""

    def __init__(self, cfg: Dict, params: Dict, device, bits: int = 8):
        self.cfg, self.params, self.device = cfg, params, torch.device(device)
        self.bits = bits
        self.products = Products(device)
        self.qw: Dict[tuple, QWeight] = {}
        self.ranges: Dict[tuple, List[float]] = {}   # site -> [lo, hi]
        self.static: Optional[Dict[tuple, Tuple[float, float]]] = None

    # -- projections -------------------------------------------------------
    def _weight(self, key: tuple, w: torch.Tensor) -> QWeight:
        if key not in self.qw:
            self.qw[key] = QWeight(w, self.products, self.bits)
        return self.qw[key]

    def qdot(self, site: tuple, x: torch.Tensor, w: torch.Tensor,
             group: torch.Tensor, n_groups: int) -> torch.Tensor:
        """x (R, K) float32 through weight w (K, N), the quantization and
        epilogue of the program's asym_u8 qdot with compensation."""
        qw = self._weight(site, w)
        if self.static is None:                  # calibration: dynamic
            r = self.ranges.setdefault(site, [math.inf, -math.inf])
            r[0] = min(r[0], float(x.min()))
            r[1] = max(r[1], float(x.max()))
            sx, zx = dynamic_scales(x, group, n_groups)
        else:
            s, z = self.static[site]
            sx = torch.full((x.shape[0], 1), s, device=x.device)
            zx = torch.full((x.shape[0], 1), z, device=x.device)
        qa = quant_act(x, sx, zx, self.bits)
        K = qa.shape[1]
        acc = self.products.sums(qa, qw.q)
        rowc = self.products.mu_r[qa.long()].sum(1, keepdim=True)
        acc = acc - (rowc + qw.comp_col[None] - K * self.products.mu)
        sxd, zxd = sx.double(), zx.double()
        acc = acc - qw.zp * qa.double().sum(1, keepdim=True) \
            - zxd * qw.colsum[None] + K * zxd * qw.zp
        return (acc * sxd * qw.scale).float()

    def install_calibration(self) -> None:
        """Fix the static activation quantizers from the observed ranges."""
        self.static = {k: static_scale(lo, hi)
                       for k, (lo, hi) in self.ranges.items()}

    # -- layers ------------------------------------------------------------
    @staticmethod
    def rmsnorm(x, gamma, eps: float = 1e-6):
        return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
            * gamma

    def rope(self, x, positions):
        half = x.shape[-1] // 2
        theta = float(self.cfg.get("rope_theta", 10000.0))
        freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half)
        ang = (positions.double()[:, None] * freqs).float()     # (L, half)
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attention(self, l, h, calls, positions, cache):
        cfg, p = self.cfg, self.params["units"][0]["attn"]
        B, L, D = h.shape
        H, Kv, hd = cfg["n_heads"], cfg["n_kv"], head_dim(cfg)
        rows = calls.rows(h)
        q = self.qdot(("attn.wq", l), rows, p["wq"][l], calls.group, calls.n)
        k = self.qdot(("attn.wk", l), rows, p["wk"][l], calls.group, calls.n)
        v = self.qdot(("attn.wv", l), rows, p["wv"][l], calls.group, calls.n)
        q = self.rope(calls.unrows(q).reshape(B, L, H, hd), positions)
        k = self.rope(calls.unrows(k).reshape(B, L, Kv, hd), positions)
        v = calls.unrows(v).reshape(B, L, Kv, hd)
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        if cache is not None and l in cache:
            k = torch.cat([cache[l][0], k], 1)
            v = torch.cat([cache[l][1], v], 1)
        new_cache = (k, v)
        kpos = torch.arange(k.shape[1], device=h.device)
        qpos = positions
        mask = kpos[None, :] <= qpos[:, None]
        if cfg.get("window"):
            mask &= kpos[None, :] > qpos[:, None] - cfg["window"]
        G = H // Kv
        qg = q.reshape(B, L, Kv, G, hd)
        lg = torch.einsum("bsngd,btnd->bngst", qg, k.float()) / math.sqrt(hd)
        lg = torch.where(mask, lg, torch.full_like(lg, -1e30))
        pr = torch.softmax(lg, -1)
        out = torch.einsum("bngst,btnd->bsngd", pr, v.float())
        out = calls.rows(out.reshape(B, L, H * hd))
        o = self.qdot(("attn.wo", l), out, p["wo"][l], calls.group, calls.n)
        return calls.unrows(o), new_cache

    def mlp(self, l, h, calls):
        p = self.params["units"][0]["mlp"]
        rows = calls.rows(h)
        up = self.qdot(("mlp.w_up", l), rows, p["w_up"][l], calls.group,
                       calls.n)
        if self.cfg["mlp_kind"] != "relu2":
            raise ValueError(self.cfg["mlp_kind"])
        a = torch.square(torch.relu(up))
        y = self.qdot(("mlp.w_down", l), a, p["w_down"][l], calls.group,
                      calls.n)
        return calls.unrows(y)

    def forward(self, tokens: torch.Tensor, spans, start: int = 0,
                cache=None, head_at=None, keep=None):
        """tokens (B, L) at positions start.. start+L-1, grouped into the
        program's calls by ``spans`` (relative position ranges).  Returns
        (logits (B, n, V) float32 at the relative positions ``head_at``,
        or every position, and the per-layer bfloat16 k/v cache)."""
        cfg, P = self.cfg, self.params
        B, L = tokens.shape
        calls = Calls(B, L, spans, tokens.device)
        positions = torch.arange(start, start + L, device=tokens.device)
        x = P["embed"][tokens.long()]
        unit = P["units"][0]
        new_cache = {}
        for l in range(cfg["n_layers"]):
            h = self.rmsnorm(x, unit["norm1"][l])
            att, new_cache[l] = self.attention(l, h, calls, positions, cache)
            x = x + att
            x = x + self.mlp(l, self.rmsnorm(x, unit["norm2"][l]), calls)
            if keep is not None:
                keep.append(x)
        if head_at is not None:
            x = x[:, head_at]
        x = self.rmsnorm(x, P["final_norm"])
        self.hidden = x                  # the head's input (the TF32 control)
        return x @ P["embed"].T, new_cache

    # -- the program's two phases -----------------------------------------
    def calibrate(self, prompts: torch.Tensor, gen_len: int = 2) -> None:
        """The calibration pass: the prompts token by token, then
        ``gen_len`` greedy steps, every call quantized dynamically;
        installs the static quantizers."""
        B, Pn = prompts.shape
        logits, cache = self.forward(prompts, [(i, i + 1) for i in range(Pn)],
                                     head_at=[Pn - 1])
        for g in range(gen_len):
            tok = torch.argmax(logits[:, -1:], -1)
            logits, step = self.forward(tok, [(0, 1)], start=Pn + g,
                                        cache=cache)
            cache = {l: step[l] for l in step}
        self.install_calibration()

    def serve_round(self, prompts: torch.Tensor,
                    served: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits of one static round: the prefill of the
        prompts (B, P) as one call, then a call per decode step fed the
        served tokens (B, G).  Returns ((B, G, V) float32, the logits that
        chose each served token; {layer: (k, v)}, the bfloat16 KV cache
        of every position fed, (B, P + G - 1, n_kv, head_dim) each)."""
        B, Pn = prompts.shape
        G = served.shape[1]
        tokens = torch.cat([prompts, served[:, :G - 1]], 1)
        spans = [(0, Pn)] + [(Pn + j, Pn + j + 1) for j in range(G - 1)]
        return self.forward(tokens, spans,
                            head_at=list(range(Pn - 1, Pn + G - 1)))
