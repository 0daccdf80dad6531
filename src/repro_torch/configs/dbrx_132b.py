"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352; 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]

Optimizer moments in bf16 (``optstate_dtype``) at 132B params."""
from .base import ArchConfig, attn_block

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10752, vocab=100352,
    period=(attn_block(moe=True),),
    n_experts=16, top_k=4,
    optstate_dtype="bfloat16",
    source="hf:databricks/dbrx-base",
)
