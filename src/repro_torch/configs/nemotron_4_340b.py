"""Nemotron-4-340B [arXiv:2402.16819; unverified]: dense, GQA kv=8,
squared-ReLU MLP."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
    n_heads=96, n_kv=8, d_ff=73728, vocab=256000, mlp_kind="relu2",
)
SMOKE = replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
                d_ff=256, vocab=512, max_seq=64)
