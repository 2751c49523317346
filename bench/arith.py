"""The benchmark's own arithmetic: the card's peaks, a configuration's
parameter counts, the projections a call makes, their least time, and
the model operations a step needs.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W limit,
dense rates: 1,979 TOP/s of int8, 67 TFLOP/s of float32 outside the
tensor cores, 3.35 TB/s of HBM.  A projection's least time is
max(bytes / 3.35 TB/s, 2 M K N / 1,979 TOP/s), the bytes counting the
int8 weight, the float32 activations in and the float32 outputs out,
each once.  The counts follow the layer equations of
``reference/decoder.py`` (a dense decoder: attention with wq, wk, wv,
wo; a relu2 or gated MLP; a tied head).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

INT8_OPS = 1979e12        # int8 tensor-core rate, dense
F32_FLOPS = 67e12         # float32 outside the tensor cores (TF32 off)
HBM_BYTES = 3.35e12       # bytes a second


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def attn_params(m: Dict) -> int:
    """wq, wk, wv and wo of one layer."""
    d, hd = m["d_model"], head_dim(m)
    return d * m["n_heads"] * hd + 2 * d * m["n_kv"] * hd \
        + m["n_heads"] * hd * d


def mlp_params(m: Dict) -> int:
    glu = m["mlp_kind"] in ("swiglu", "geglu")
    return m["d_model"] * m["d_ff"] * (3 if glu else 2)


def param_count(m: Dict) -> int:
    """Every parameter: the layers' projections and the tied embedding (the
    norms' gains are left out)."""
    return (attn_params(m) + mlp_params(m)) * m["n_layers"] \
        + m["vocab"] * m["d_model"]


@dataclass(frozen=True)
class Proj:
    """One projection call: M rows of K through a (K, N) weight."""
    name: str
    M: int
    K: int
    N: int

    @property
    def ops(self) -> float:
        return 2.0 * self.M * self.K * self.N

    @property
    def bytes(self) -> float:
        return self.K * self.N + 4.0 * self.M * (self.K + self.N)

    @property
    def least_s(self) -> float:
        return max(self.bytes / HBM_BYTES, self.ops / INT8_OPS)


def layer_projections(m: Dict, T: int, merged: bool = True) -> List[Proj]:
    """The projection calls of one decoder layer over a call of T tokens.
    ``merged``: wq|wk|wv as one call (serving)."""
    d, hd, H, Kv = m["d_model"], head_dim(m), m["n_heads"], m["n_kv"]
    out = []
    if merged:
        out.append(Proj("wqkv", T, d, (H + 2 * Kv) * hd))
    else:
        out += [Proj("wq", T, d, H * hd), Proj("wk", T, d, Kv * hd),
                Proj("wv", T, d, Kv * hd)]
    out.append(Proj("wo", T, H * hd, d))
    glu = m["mlp_kind"] in ("swiglu", "geglu")
    if glu and merged:
        out.append(Proj("w_gateup", T, d, 2 * m["d_ff"]))
    elif glu:
        out += [Proj("w_gate", T, d, m["d_ff"]),
                Proj("w_up", T, d, m["d_ff"])]
    else:
        out.append(Proj("w_up", T, d, m["d_ff"]))
    out.append(Proj("w_down", T, m["d_ff"], d))
    return out


def call_projections(m: Dict, T: int, merged: bool = True) -> List[Proj]:
    return layer_projections(m, T, merged) * m["n_layers"]


def attention_flops(m: Dict, B: int, q_pos: List[int]) -> float:
    """float32 flops of the attention of B requests whose queries sit at
    positions ``q_pos`` (causal: a query at p reads p + 1 keys):
    scores and the weighted sum, 2 flops a multiply-add each."""
    H, hd = m["n_heads"], head_dim(m)
    keys = sum(p + 1 for p in q_pos)
    return 4.0 * B * H * hd * keys * m["n_layers"]


def head_flops(m: Dict, rows: int) -> float:
    """float32 flops of the tied head over ``rows`` positions."""
    return 2.0 * rows * m["d_model"] * m["vocab"]


def serve_round_least_s(m: Dict, B: int, P: int, G: int) -> Dict[str, float]:
    """A static round's model work at the card's peaks: the prefill of B
    prompts of P tokens and G - 1 decode steps, the head at the positions
    that choose a token.  Returns the seconds of its products at the
    int8 rate ('proj_s'), of its float32 work ('f32_s'), and the sum of
    its projections' least times ('proj_least_s')."""
    projs = call_projections(m, B * P) + \
        call_projections(m, B) * (G - 1)
    proj_s = sum(p.ops for p in projs) / INT8_OPS
    att = attention_flops(m, B, list(range(P))) + sum(
        attention_flops(m, B, [P + j - 1]) for j in range(1, G))
    f32 = att + head_flops(m, B * G)
    return {"proj_s": proj_s, "f32_s": f32 / F32_FLOPS,
            "proj_least_s": sum(p.least_s for p in projs)}


def train_step_least_s(m: Dict, B: int, S: int) -> Dict[str, float]:
    """One QAT step's model work at the card's peaks: the forward's
    approximate products (int8 rate) twice (the forward and its remat
    recompute), the straight-through backward's two float32 products of
    each projection, attention forward (twice) and backward (twice its
    forward), the head forward and backward (3 products), float32."""
    T = B * S
    projs = call_projections(m, T, merged=False)
    fwd_ops = sum(p.ops for p in projs)
    att = attention_flops(m, B, list(range(S)))
    f32 = 2 * fwd_ops + 4 * att + 3 * head_flops(m, T)
    return {"proj_s": 2 * fwd_ops / INT8_OPS, "f32_s": f32 / F32_FLOPS,
            "proj_least_s": 2 * sum(p.least_s for p in projs)}
