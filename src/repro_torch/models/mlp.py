"""Gated MLP (SwiGLU/GeGLU-style) used by all dense blocks (port of
``repro.models.mlp``).

On a ``model`` axis (``sharding.tp``) whose rank holds a shard of the ff
columns (``ffn_wi`` narrower than ``cfg.d_ff``), ``ffn_wi`` / ``ffn_wg``
are column-parallel and ``ffn_wo`` row-parallel: the input passes
``tp.copy_to`` and the partial output is all-reduced."""
from __future__ import annotations

import torch

from repro_torch.sharding import tp

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
    sharded = p["ffn_wi"].shape[1] < cfg.d_ff
    if sharded:
        x = tp.copy_to(x)
    act = act_fn(cfg.act)
    h = act(torch.matmul(x, p["ffn_wg"])) * torch.matmul(x, p["ffn_wi"])
    out = torch.matmul(h, p["ffn_wo"])
    return tp.reduce_from(out) if sharded else out
