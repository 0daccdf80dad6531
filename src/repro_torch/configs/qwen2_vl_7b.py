"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064; M-RoPE + dynamic-resolution vision (stubbed: patch embeddings
are provided by input_specs, per the modality-frontend carve-out).
[arXiv:2409.12191]"""
from .base import ArchConfig, attn_block

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, d_ff=18944, vocab=152064,
    period=(attn_block(),),
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),   # over head_dim/2 = 64 frequencies
    n_patches=1024, d_vision=1280,
    source="arXiv:2409.12191",
)
