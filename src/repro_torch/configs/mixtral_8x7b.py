"""Mixtral-8x7B [arXiv:2401.04088; hf]: 8 experts top-2, SWA 4096."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=32000, mlp_kind="swiglu",
    n_experts=8, top_k=2, window=4096, pattern=("moe",),
)
SMOKE = replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
                d_ff=128, vocab=512, n_experts=4, top_k=2, window=32,
                max_seq=64)
