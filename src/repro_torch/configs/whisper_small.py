"""whisper-small [audio] — 12L(+12 enc) d_model=768 12H (kv=12) d_ff=3072
vocab=51865; encoder-decoder; mel-spectrogram + conv frontend STUBBED —
input_specs provides (B, 1500, d_model) frame embeddings (the carve-out in
the task spec).  Positions are sinusoidal (computed on the fly; whisper's
learned decoder table would not extend to the assigned 32k/524k decode
shapes — noted deviation). [arXiv:2212.04356]"""
from .base import ArchConfig, attn_block

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=51865,
    period=(attn_block(cross_attn=True),),
    n_enc_layers=12, n_enc_frames=1500,
    learned_pos=True,            # additive (sinusoidal) positions, no rope
    norm="layernorm", act="gelu",
    source="arXiv:2212.04356",
)
