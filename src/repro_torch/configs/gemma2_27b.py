"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; alternating local (sliding-window 4096) / global attention,
attention + final logit soft-capping, post-block norms. [arXiv:2408.00118]"""
from .base import ArchConfig, attn_block

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16, d_ff=36864, vocab=256000,
    period=(attn_block(window=4096), attn_block()),   # local, global
    head_dim=128,
    attn_softcap=50.0, final_softcap=30.0,
    post_block_norm=True,
    act="gelu",
    source="arXiv:2408.00118",
)
