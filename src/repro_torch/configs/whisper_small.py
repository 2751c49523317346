"""Whisper-small: encoder-decoder; the conv frontend is a stub (the
encoder takes precomputed frame embeddings, 1,500 frames at full
length).  Decoder positional capacity 448."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv=12, d_ff=3072, vocab=51865, mlp_kind="gelu",
    enc_layers=12, enc_seq=1500, frontend_dim=768, max_seq=448,
)
SMOKE = replace(CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                n_kv=4, d_ff=256, vocab=512, frontend_dim=64, max_seq=64)
