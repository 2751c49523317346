"""Qwen3-1.7B (Qwen/Qwen3 family): qk_norm, GQA kv=8."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv=8, d_ff=6144, vocab=151936, qk_norm=True,
    mlp_kind="swiglu",
)
SMOKE = replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
                d_ff=192, vocab=512, max_seq=64)
