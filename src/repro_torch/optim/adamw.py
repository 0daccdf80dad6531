"""AdamW with dtype-configurable moments (bf16 for the >=100B configs) and
global-norm gradient clipping (port of ``repro.optim.adamw``).  Functions
over parameter trees (nested dicts of tensors, walked in the reference's
sorted-key leaf order); the arithmetic is the reference's, in float32.

A leaf may be a ``DTensor`` (``train.steps.place_train_state``): the
update then runs on each rank's local shard, and the norm is the whole
gradient's over the mesh.  By default nothing is updated in place and each
call returns new parameters and state; ``inplace=True`` (the partitioned
train step, the counterpart of the reference's ``donate_argnums``) writes
them into the tensors given, so a device holds one copy of its state.
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


def _local(x):
    """(the local tensor, the number of the mesh's ranks that hold it, the
    mesh) of a leaf; a plain tensor is its own, held by one rank."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x, 1, None
    mesh = x.device_mesh
    rep = math.prod(mesh.size(i) for i, pl in enumerate(x.placements)
                    if pl.is_replicate())
    return x.to_local(), rep, mesh


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """The 2-norm of every leaf together, float32.  The squares are summed
    in float64 (each leaf's in one reduction, which reads the leaf as it
    is), so the same gradient summed in another order (over a mesh's
    shards, a model axis's partial products) comes out within one float32
    rounding.  Over ``DTensor`` leaves it is the whole tensor's over the
    mesh: each local sum of squares is divided by the number of ranks that
    hold the same shard (a leaf replicated on a mesh axis of n ranks is
    summed once, not n times) and one all-reduce adds the ranks' sums."""
    total, mesh = 0, None
    for x in tree_leaves(tree):
        x, rep, m = _local(x)
        mesh = mesh or m
        sq = torch.linalg.vector_norm(x.reshape(-1),
                                      dtype=torch.float64) ** 2
        total = total + (sq / rep if rep > 1 else sq)
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Partial

        total = DTensor.from_local(total, mesh, [Partial("sum")] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total).float()


def _like(x, local):
    """``local`` as ``x``'s local shard: a ``DTensor`` of ``x``'s layout
    where ``x`` is one, else ``local`` itself."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return local
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                 inplace: bool = False):
    """Returns (new_params, new_state, metrics).  ``lr`` is a float or a
    float32 scalar tensor (``cosine_schedule``'s value at the step).
    ``DTensor`` leaves of one layout across the four trees update each
    rank's shard (module docstring).  ``inplace``: the new parameters,
    moments and count are written into ``params`` and ``state``, which are
    returned."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    cf = count.float()
    c1 = 1.0 - b1 ** cf
    c2 = 1.0 - b2 ** cf

    def upd(g, m, v, p):
        g, m, v, p = (_local(x)[0] for x in (g, m, v, p))
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        step = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        step = step + lr * weight_decay * p.float()
        p_new = p.float() - step
        if inplace:
            p.copy_(p_new)
            m.copy_(m_new)
            v.copy_(v_new)
            return None
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    trees = (grads, state.m, state.v, params)
    out = [upd(*leaves) for leaves in zip(*map(tree_leaves, trees))]
    if inplace:
        state.count.copy_(count)
        return params, state, {"grad_norm": gnorm}
    pick = lambda i, like: tree_unflatten(like, [  # noqa: E731
        _like(x, o[i]) for x, o in zip(tree_leaves(like), out)])
    return (pick(0, params), AdamWState(pick(1, state.m), pick(2, state.v),
                                        count), {"grad_norm": gnorm})


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
