"""RecurrentGemma-2B [arXiv:2402.19427; hf]: RG-LRU + local attn 1:2,
MQA kv=1. Sub-quadratic: runs long_500k. 26 layers: (rec,rec,attn) x 8
+ 2 rec -> we use 27 = 9 units of (rec,rec,attn) minus... faithful count:
26 layers with 1:2 pattern; we take 24 as (rec,rec,attn) x 8 plus a final
(rec, rec): encoded as pattern x n_units requires divisibility, so we use
n_layers=27 (9 units) and note the +1 layer deviation in DESIGN.md."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=27, d_model=2560,
    n_heads=10, n_kv=1, d_ff=7680, vocab=256000, mlp_kind="geglu",
    pattern=("rec", "rec", "attn"), d_rnn=2560, window=2048,
    sub_quadratic=True, max_seq=524288,
)
SMOKE = replace(CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv=1,
                d_ff=192, vocab=512, d_rnn=64, window=16, max_seq=64)
