"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152; GQA + RoPE, sliding-window 4096 (as published).
[arXiv:2402.19173]"""
from .base import ArchConfig, attn_block

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288, vocab=49152,
    period=(attn_block(window=4096),),
    rope_theta=100000.0,
    norm="layernorm", act="gelu",
    source="arXiv:2402.19173",
)
