"""Minitron-8B [arXiv:2407.14679; hf]: pruned nemotron, GQA kv=8,
squared-ReLU."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=16384, vocab=256000, mlp_kind="relu2",
)
SMOKE = replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
                d_ff=256, vocab=512, max_seq=64)
