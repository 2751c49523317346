"""xLSTM-125M [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks,
d_ff=0 (no separate MLP). Pattern unit (m,m,s) x 4 = 12 layers.
Sub-quadratic: runs long_500k."""
from dataclasses import replace

from . import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    pattern=("mlstm", "mlstm", "slstm"), sub_quadratic=True,
    max_seq=524288,
)
SMOKE = replace(CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv=2,
                vocab=512, max_seq=64)
