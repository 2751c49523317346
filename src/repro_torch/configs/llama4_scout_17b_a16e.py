"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
16 experts top-1 + shared expert, early fusion (text-only backbone here)."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv=8, d_ff=8192, vocab=202048, mlp_kind="swiglu",
    n_experts=16, top_k=1, shared_expert_ff=8192, pattern=("moe",),
)
SMOKE = replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
                d_ff=128, vocab=512, n_experts=4, top_k=1,
                shared_expert_ff=128, max_seq=64)
