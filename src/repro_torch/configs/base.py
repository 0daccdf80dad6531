"""Architecture configuration system (own copy of the reference's
``repro.configs.base``; pure data, so the port imports nothing of
``repro``).

Every assigned architecture is a declarative ``ArchConfig``; the model code in
``repro_torch/models`` interprets it.  Layers are grouped into a homogeneous
*period* (a short list of block specs) that repeats ``n_periods`` times — the
model stacks period parameters with a leading ``n_periods`` axis and walks
it, one period at a time.  Fields that steer only the reference's TPU
sharding and compilation (the O1-O6 levers, ``remat_policy``) are kept so a
configuration reads the same in both packages; the port's placement rules
read ``fsdp_min_elems`` (``repro_torch.sharding``) and its dry run counts
the recompute ``remat_policy`` implies (``repro_torch.launch.roofline``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["BlockSpec", "ArchConfig", "attn_block", "mamba_block",
           "mlstm_block", "slstm_block"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One sublayer position within the repeating period."""
    kind: str                   # "attn" | "mamba" | "mlstm" | "slstm"
    moe: bool = False           # MoE MLP instead of dense MLP
    window: Optional[int] = None  # sliding-window size for attn (None = full)
    cross_attn: bool = False    # decoder cross-attention (enc-dec only)
    mlp: bool = True            # xLSTM blocks carry their own projections


def attn_block(moe: bool = False, window: Optional[int] = None,
               cross_attn: bool = False) -> BlockSpec:
    return BlockSpec("attn", moe=moe, window=window, cross_attn=cross_attn)


def mamba_block(moe: bool = False) -> BlockSpec:
    return BlockSpec("mamba", moe=moe)


def mlstm_block() -> BlockSpec:
    return BlockSpec("mlstm", mlp=False)


def slstm_block() -> BlockSpec:
    return BlockSpec("slstm", mlp=False)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    period: Tuple[BlockSpec, ...]          # decoder period (repeats)
    head_dim: Optional[int] = None         # default d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- attention extras ---
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None   # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    # sliding-window size used when a long-context windowed variant is
    # requested (dense archs on long_500k; DESIGN §4 'long_500k policy')
    long_context_window: int = 4096
    # --- M-RoPE (qwen2-vl) ---
    mrope_sections: Optional[Tuple[int, int, int]] = None  # fractions of hd/2
    n_patches: int = 0                     # VLM stub patch embeds
    d_vision: int = 0                      # stub vision embedding width
    # --- Mamba ---
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_dt_rank: int = 0                 # 0 -> ceil(d_model/16)
    mamba_chunk: int = 128
    # --- xLSTM ---
    xlstm_proj_factor: float = 2.0         # mLSTM up-projection factor
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_enc_frames: int = 0                  # stub conv/mel frontend length
    causal_encoder: bool = False
    learned_pos: bool = False              # learned positional embeddings
    # --- norm / act ---
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    act: str = "silu"                      # silu | gelu
    post_block_norm: bool = False          # gemma2-style extra norms
    # --- numerics / distribution ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optstate_dtype: str = "float32"        # bf16 for the >=100B configs
    remat_policy: str = "full"             # full | dots | none  (hillclimb lever)
    attn_chunk: int = 1024                 # KV chunk for online-softmax attention
    # --- beyond-paper perf levers (§Perf; default off = paper baseline) ---
    banded_window: bool = False            # O1: skip out-of-window KV blocks
    seq_parallel_attn: bool = False        # O2: shard q-seq over `model` when
    #     heads % model_axis != 0 (keeps the MXU busy for 24/28/12-head archs)
    fsdp_min_elems: int = 0                # O3: replicate params smaller than
    #     this (stops per-scan-chunk FSDP all-gathers of tiny weights)
    moe_local_dispatch: bool = False       # O5: batch-local MoE gather/scatter
    slstm_shard_batch: bool = False        # O6: pin sLSTM scan inputs/carry to
    #     batch sharding (stops per-timestep SPMD reshards, 49k collectives)
    seq_parallel_mlp: bool = False         # O4: Megatron-SP style — keep the
    #     residual stream sequence-sharded over `model` through norms + MLP
    #     (turns TP partial-sum all-reduces into cheap boundary reshards)
    # --- coded data parallelism (the paper's technique; DESIGN §4) ---
    coded_dp_beta: int = 2                 # gradient-coding replication factor
    source: str = ""                       # citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by period {len(self.period)}"
        return self.n_layers // len(self.period)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke_variant(self) -> "ArchConfig":
        """Reduced config for CPU smoke tests: 1 period (>=1 layer... up to
        period length), d_model<=256, <=4 experts, small vocab."""
        hd = 32
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(self.n_kv, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        period = self.period[:2] if len(self.period) > 2 else self.period
        # Keep one of each block kind present so the smoke exercises them all.
        kinds = {b.kind for b in self.period}
        if {b.kind for b in period} != kinds:
            period = tuple(dict.fromkeys(
                [next(b for b in self.period if b.kind == k) for k in sorted(kinds)]))
        return dataclasses.replace(
            self,
            n_layers=2 * len(period), d_model=128, n_heads=n_heads, n_kv=n_kv,
            d_ff=256, vocab=512, head_dim=hd, period=tuple(period),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_enc_frames=16 if self.n_enc_frames else 0,
            n_patches=8 if self.n_patches else 0,
            d_vision=64 if self.d_vision else 0,
            mamba_chunk=16, attn_chunk=64,
            dtype="float32", param_dtype="float32",
            mrope_sections=(4, 6, 6) if self.mrope_sections else None,
        )
