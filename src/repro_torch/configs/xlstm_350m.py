"""xlstm-350m [ssm] — 24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304;
alternating sLSTM + mLSTM blocks (the blocks carry their own projections —
d_ff=0 at the config level). [arXiv:2405.04517]"""
from .base import ArchConfig, mlstm_block, slstm_block

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    period=(mlstm_block(), slstm_block()),
    xlstm_proj_factor=2.0,
    source="arXiv:2405.04517",
)
