"""Gemma-7B [arXiv:2403.08295; hf]: GeGLU, head_dim=256, GQA kv=16."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv=16, d_ff=24576, vocab=256000, head_dim=256,
    mlp_kind="geglu",
)
SMOKE = replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4,
                d_ff=256, vocab=512, head_dim=16, max_seq=64)
