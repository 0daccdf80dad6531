"""Mixture-of-Experts layer: top-k token-choice routing with sort-based
capacity dispatch (port of ``repro.models.moe``): gather/scatter only, no
one-hot dispatch products, so the expert products cost the ACTIVE
parameters.

The reference vmaps the dispatch over batch rows; the port writes the same
per-row dispatch in batched form (each row sorts its own S*k assignments)
from operations that ``torch.func.vmap`` batches, so the coded train step
vmaps it once more over the workers.  Counting uses a compare-and-sum (no
``bincount``, which has no batching rule), and the scatters are
``index_put(..., accumulate=True)``.

Aux losses: Switch-style load-balance + router z-loss, returned for logging
and added to the training objective with cfg.router_aux_weight.

On a ``model`` axis (``sharding.tp``) whose rank holds a shard of the
experts (``moe_wi`` holds fewer than ``cfg.n_experts``) the batch is the
same on every rank of the model group, so routing, the capacity ranks,
the dispatch buffer and the aux losses stay replicated; each rank runs
its experts on its slice of the buffer, combines their contributions into
a partial (B, S, d) and all-reduces it.  The tokens entering the dispatch
and the combine weights pass ``tp.copy_to``: a rank's gradient of them
covers its experts' slots only.
"""
from __future__ import annotations

import torch

from repro_torch.sharding import tp

from .common import act_fn, pdef

__all__ = ["moe_defs", "moe_apply", "moe_capacity", "capacity_drops"]


def moe_defs(cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": pdef((d, E), ("embed", None), scale=0.02),
        "moe_wi": pdef((E, d, f), ("expert", "embed", "ff"), fan_in=d),
        "moe_wg": pdef((E, d, f), ("expert", "embed", "ff"), fan_in=d),
        "moe_wo": pdef((E, f, d), ("expert", "ff", "embed"), fan_in=f),
    }


def moe_capacity(cfg, S: int) -> int:
    """Slots an expert holds for one batch row of S tokens."""
    return max(int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts), 1)


def _route(p, x, cfg):
    """Router logits (float32), probabilities and the normalized top-k."""
    logits = torch.matmul(x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # equal probabilities (common when the router runs in bfloat16) go to
    # the lower expert first, as ``lax.top_k``; ``torch.topk`` leaves the
    # order of ties unspecified
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :cfg.top_k], top_e[..., :cfg.top_k]  # (B,S,k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_e


def _ranks(top_e, E: int, C: int):
    """Group each row's S*k assignments by expert (a stable sort, as
    ``jnp.argsort``: the rank within an expert, and so which assignment a
    capacity drop removes, follows token order) -> (order, e_sorted,
    rank_c, keep), each (B, S*k)."""
    B = top_e.shape[0]
    flat_e = top_e.reshape(B, -1)
    n = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.gather(flat_e, -1, order)
    experts = torch.arange(E, device=top_e.device)
    counts = (flat_e[..., None] == experts).sum(-2)        # (B, E)
    offsets = torch.cumsum(counts, -1) - counts            # exclusive prefix
    rank = (torch.arange(n, device=top_e.device)
            - torch.gather(offsets, -1, e_sorted))
    keep = rank < C                                        # capacity drop
    rank_c = torch.where(keep, rank, 0)
    return order, e_sorted, rank_c, keep


def moe_apply(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_losses dict)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S)
    dev = x.device

    logits, probs, top_w, top_e = _route(p, x, cfg)

    # Aux losses (Switch): load balance over expert fractions x router probs.
    me = probs.mean(dim=(0, 1))                            # (E,)
    first = (top_e[..., 0, None] == torch.arange(E, device=dev)).float()
    ce = first.mean(dim=(0, 1))
    aux_lb = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    order, e_sorted, rank_c, keep = _ranks(top_e, E, C)
    # token t's k slots (t, t, ..., t): an expand, which no CUDA graph
    # capture refuses (``repeat_interleave`` may size its output on the host)
    flat_tok = torch.arange(S, device=dev)[:, None].expand(S, k).reshape(-1)
    t_sorted = flat_tok[order]                             # token of a slot
    w_sorted = torch.gather(top_w.to(x.dtype).reshape(B, -1), -1, order)
    rows = torch.arange(B, device=dev)[:, None].expand_as(order)
    El = p["moe_wi"].shape[0]          # the rank's experts [e0, e0 + El)
    sharded = El < E
    if sharded:
        x, w_sorted = tp.copy_to(x), tp.copy_to(w_sorted)

    # dispatch: the kept (expert, rank) pairs are unique; a dropped
    # assignment adds zero at its expert's rank 0, as the reference's does
    xs = torch.where(keep[..., None], x[rows, t_sorted], 0.0)
    buf = torch.zeros((B, E, C, d), dtype=x.dtype, device=dev).index_put(
        (rows, e_sorted, rank_c), xs, accumulate=True)     # (B, E, C, d)
    e_local, mine = e_sorted, keep
    if sharded:
        e0 = tp.rank() * El
        buf = buf[:, e0:e0 + El]
        e_local = (e_sorted - e0).clamp(0, El - 1)
        mine = keep & (e_sorted >= e0) & (e_sorted < e0 + El)

    act = act_fn(cfg.act)
    h = act(torch.einsum("becd,edf->becf", buf, p["moe_wg"])) * torch.einsum(
        "becd,edf->becf", buf, p["moe_wi"])
    y = torch.einsum("becf,efd->becd", h, p["moe_wo"])    # (B, El, C, d)

    # combine: k contributions a token, added in sorted-slot order
    gathered = y[rows, e_local, rank_c]                    # (B, S*k, d)
    gathered = torch.where(mine[..., None], gathered, 0.0) * w_sorted[..., None]
    out = torch.zeros((B, S, d), dtype=y.dtype, device=dev).index_put(
        (rows, t_sorted), gathered, accumulate=True)
    if sharded:
        out = tp.reduce_from(out)
    return out, {"load_balance": aux_lb, "router_z": z_loss}


def capacity_drops(p, x, cfg) -> torch.Tensor:
    """The number of assignments ``moe_apply(p, x, cfg)`` drops for
    capacity (an int64 scalar tensor on x's device)."""
    _, _, _, top_e = _route(p, x, cfg)
    _, _, _, keep = _ranks(top_e, cfg.n_experts, moe_capacity(cfg, x.shape[1]))
    return (~keep).sum()
