"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536; Mamba+attention 1:7 interleave (1 attention layer per
8-layer period), MoE 16 experts top-2 on every other layer.
[arXiv:2403.19887]

Optimizer moments are kept in bf16 (``optstate_dtype``) at 398B params."""
from .base import ArchConfig, attn_block, mamba_block

# 8-layer period: position 0 = attention, rest Mamba; MoE on odd positions.
_PERIOD = tuple(
    (attn_block(moe=(i % 2 == 1)) if i == 0 else mamba_block(moe=(i % 2 == 1)))
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576, vocab=65536,
    period=_PERIOD,
    n_experts=16, top_k=2,
    mamba_d_state=16, mamba_expand=2, mamba_conv=4,
    optstate_dtype="bfloat16",
    source="arXiv:2403.19887",
)
