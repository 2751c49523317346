"""InternVL2-76B: a stub vision frontend (256 patch embeddings of width
3,200, projected to d_model) prepended to an InternLM2-76B-like decoder."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv=8, d_ff=28672, vocab=128256, mlp_kind="swiglu",
    n_prefix=256, frontend_dim=3200,
)
SMOKE = replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
                d_ff=256, vocab=512, n_prefix=4, frontend_dim=48,
                max_seq=64)
