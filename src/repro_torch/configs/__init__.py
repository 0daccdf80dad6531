"""Configuration registry of the port: the ten model-zoo architectures and
the paper-native problems (own copy of the reference's ``repro.configs``).

``get_config(name)`` returns the full ArchConfig; ``windowed_variant``
produces the sliding-window long-context variant dense archs use for the
``long_500k`` shape.
"""
from __future__ import annotations

import dataclasses

from .base import (ArchConfig, BlockSpec, attn_block, mamba_block,
                   mlstm_block, slstm_block)
from .dbrx_132b import CONFIG as _dbrx
from .deepseek_7b import CONFIG as _deepseek
from .gemma2_27b import CONFIG as _gemma2
from .jamba_1_5_large_398b import CONFIG as _jamba
from .paper_native import (PAPER_LASSO, PAPER_LOGISTIC, PAPER_MF,
                           PAPER_PROBLEMS, PAPER_RIDGE,
                           QuadraticProblemConfig)
from .phi3_5_moe_42b import CONFIG as _phi35
from .qwen2_vl_7b import CONFIG as _qwen2vl
from .stablelm_12b import CONFIG as _stablelm
from .starcoder2_3b import CONFIG as _starcoder2
from .whisper_small import CONFIG as _whisper
from .xlstm_350m import CONFIG as _xlstm

__all__ = ["ArchConfig", "BlockSpec", "attn_block", "mamba_block",
           "mlstm_block", "slstm_block", "ARCHS", "SHAPES", "get_config",
           "windowed_variant", "needs_window_for_long", "PAPER_RIDGE",
           "PAPER_MF", "PAPER_LOGISTIC", "PAPER_LASSO", "PAPER_PROBLEMS",
           "QuadraticProblemConfig"]

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        _stablelm, _qwen2vl, _jamba, _whisper, _starcoder2, _phi35,
        _deepseek, _dbrx, _xlstm, _gemma2,
    ]
}

# Input shapes assigned to this paper (seq_len, global_batch, kind).
SHAPES = {
    "train_4k":    dict(seq_len=4096,    global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,   global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,   global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288,  global_batch=1,   kind="decode"),
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def windowed_variant(cfg: ArchConfig) -> ArchConfig:
    """Replace full-attention blocks with sliding-window ones (long_500k)."""
    W = cfg.long_context_window
    period = tuple(
        dataclasses.replace(b, window=b.window or W) if b.kind == "attn" else b
        for b in cfg.period)
    return cfg.with_overrides(period=period)


def needs_window_for_long(cfg: ArchConfig) -> bool:
    """True if the arch has any full-attention block (quadratic at 524k)."""
    return any(b.kind == "attn" and b.window is None for b in cfg.period)
