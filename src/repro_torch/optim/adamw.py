"""AdamW with dtype-configurable moments (bf16 for the >=100B configs) and
global-norm gradient clipping (port of ``repro.optim.adamw``).  Functions
over parameter trees (nested dicts of tensors, walked in the reference's
sorted-key leaf order); the arithmetic is the reference's, in float32, and
nothing is updated in place: each call returns new parameters and state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor        # int32 scalar: the steps taken so far


def adamw_init(params, dtype=torch.float32) -> AdamWState:
    zeros = lambda t: tree_map(
        lambda x: torch.zeros_like(x, dtype=dtype), t)
    device = tree_leaves(params)[0].device
    return AdamWState(zeros(params), zeros(params),
                      torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        x = x.float().reshape(-1)
        total = total + torch.dot(x, x)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """Returns (new_params, new_state, metrics).  ``lr`` is a float or a
    float32 scalar tensor (``cosine_schedule``'s value at the step)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    cf = count.float()
    c1 = 1.0 - b1 ** cf
    c2 = 1.0 - b2 ** cf

    def upd(g, m, v, p):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        step = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        step = step + lr * weight_decay * p.float()
        return ((p.float() - step).to(p.dtype), m_new.to(m.dtype),
                v_new.to(v.dtype))

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(grads), tree_leaves(state.m), tree_leaves(state.v),
        tree_leaves(params))]
    pick = lambda i: tree_unflatten(params, [o[i] for o in out])
    return (pick(0), AdamWState(pick(1), pick(2), count),
            {"grad_norm": gnorm})


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up then cosine decay; the returned function maps a step
    (an int or an int tensor, such as ``AdamWState.count``) to a float32
    scalar tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * (step + 1.0) / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
