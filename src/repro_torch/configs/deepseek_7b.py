"""deepseek-7b [dense] — 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400; llama architecture. [arXiv:2401.02954]"""
from .base import ArchConfig, attn_block

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv=32, d_ff=11008, vocab=102400,
    period=(attn_block(),),
    rope_theta=10000.0,
    source="arXiv:2401.02954",
)
