"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064; 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]"""
from .base import ArchConfig, attn_block

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400, vocab=32064,
    period=(attn_block(moe=True),),
    n_experts=16, top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
