"""Gated MLP (SwiGLU/GeGLU-style) used by all dense blocks (port of
``repro.models.mlp``)."""
from __future__ import annotations

import torch

from .common import act_fn, pdef

__all__ = ["mlp_defs", "mlp_apply"]


def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ffn_wi": pdef((d, f), ("embed", "ff")),
        "ffn_wg": pdef((d, f), ("embed", "ff")),
        "ffn_wo": pdef((f, d), ("ff", "embed")),
    }


def mlp_apply(p, x, cfg):
    act = act_fn(cfg.act)
    h = act(torch.matmul(x, p["ffn_wg"])) * torch.matmul(x, p["ffn_wi"])
    return torch.matmul(h, p["ffn_wo"])
