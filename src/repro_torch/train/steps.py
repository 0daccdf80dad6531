"""Step builders: plain train step, prefill step, decode step (port of
``repro.train.steps``).

The paper's technique enters ``train_step`` through the per-sample weight
vector: the host computes FRC decode weights from the straggler mask
(core.gradient_coding) and the weighted loss makes the gradient a masked,
rescaled sum over surviving workers' shards.  Everything is a function of
(params, opt_state, batch) that returns new values, with two exceptions:
the train step built with ``grad_specs`` (the partitioned program) writes
the new parameters and AdamW state into the shards it is given, as the
reference's ``donate_argnums=(0, 1)`` reuses the input buffers, and the
decode step writes into the caches it is given (``models.decode_step``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32_matmul
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_update
from repro_torch.tree import tree_map

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "batch_extras", "place_train_state", "gather"]


def batch_extras(cfg: ArchConfig, batch: dict) -> dict:
    kw = {}
    if cfg.n_patches:
        kw["patch_embeds"] = batch["patch_embeds"]
        kw["mrope_positions"] = batch["mrope_positions"]
    if cfg.n_enc_layers:
        kw["enc_embeds"] = batch["enc_embeds"]
    return kw


def _shard(t: torch.Tensor, sharding):
    """``t`` (every rank's whole copy) as a ``DTensor`` of ``sharding``'s
    layout holding only this rank's shard, in storage of its own."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    d = distribute_tensor(t, sharding.mesh, sharding.placements,
                          src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=d.shape, stride=d.stride())


def _by_spec(tree, specs, fn, rest=lambda t: t):
    """``fn(leaf, sharding)`` over the leaves of ``tree`` that ``specs``
    (a tree of ``NamedSharding``s or a prefix of one, as ``grad_specs``)
    covers; ``rest(part)`` for each part it does not."""
    from repro_torch.sharding import NamedSharding

    if isinstance(specs, NamedSharding):
        return tree_map(lambda t: fn(t, specs), tree)
    if isinstance(specs, dict) and isinstance(tree, dict):
        return {k: _by_spec(t, specs.get(k), fn, rest)
                for k, t in tree.items()}
    return rest(tree)


@torch.no_grad()
def place_train_state(params, opt_state, shardings):
    """(params, opt_state) on a mesh, the counterpart of the reference's
    ``in_shardings=(psh, osh, ...)``: every leaf of ``params`` and of the
    AdamW moments ``m`` / ``v`` becomes a ``DTensor`` of the matching
    ``NamedSharding`` of ``shardings`` (``sharding.make_shardings``; the
    moments take the parameters' layouts) holding this rank's shard; the
    step count stays a replicated plain tensor.  Each rank passes the
    same whole trees (a seeded draw) and keeps 1/n of each sharded leaf;
    the caller drops the whole trees."""
    return (_by_spec(params, shardings, _shard),
            type(opt_state)(_by_spec(opt_state.m, shardings, _shard),
                            _by_spec(opt_state.v, shardings, _shard),
                            opt_state.count))


def gather(tree):
    """Every ``DTensor`` leaf of ``tree`` as the whole tensor (its
    all-gather: the FSDP gather); plain leaves as they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


@torch.no_grad()
def _lay_out(g: torch.Tensor, sharding):
    """The mean of every rank's ``g``, reduce-scattered to ``sharding``'s
    placements (each rank's ``g`` a partial sum over the whole mesh): a
    ``DTensor`` holding this rank's shard of it."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = sharding.mesh
    d = DTensor.from_local(g, mesh, [Partial("sum")] * mesh.ndim,
                           run_check=False)
    d = d.redistribute(mesh, sharding.placements)
    return DTensor.from_local(d.to_local() / mesh.size(), mesh,
                              sharding.placements, run_check=False,
                              shape=d.shape, stride=d.stride())


def _constrain(grads, specs):
    """``grads`` laid out to the ``NamedSharding``s of ``specs``, a tree or
    a prefix of one (``build_train_step``'s ``grad_specs``)."""
    import torch.distributed as dist

    def rest(part):
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(
                f"grad_specs leaves a gradient without a NamedSharding on a "
                f"group of {dist.get_world_size()} ranks: it would stay each"
                f" rank's own, and the ranks' parameters would drift apart")
        return part

    return _by_spec(grads, specs, _lay_out, rest)


def build_train_step(cfg: ArchConfig, lr_fn: Callable,
                     weight_decay: float = 0.1,
                     z_loss_weight: float = 1e-3,
                     grad_specs=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    batch: tokens (B,S) int, labels (B,S) int, weights (B,) f32 coded
    decode weights, plus modality extras (patch/enc embeddings), all on the
    parameters' device.  Float32 products run in full float32 (TF32 off),
    as the reference computes.

    grad_specs: a ``sharding.make_shardings`` tree matching params, or a
    prefix of one (a ``NamedSharding`` stands for every leaf below it),
    as ``with_sharding_constraint`` takes.  The step is then the
    partitioned program: ``params`` and the AdamW moments come in as
    ``DTensor`` shards laid out by it (``place_train_state``), the step
    gathers the whole parameter tree at its top (each leaf's
    ``full_tensor()``, the FSDP all-gather), takes the gradient of the
    gathered tree, reduce-scatters each rank's gradient to its placements
    and divides it by the mesh's size (so every rank steps with its shard
    of the mean of all ranks' gradients: the gradient of the batch the
    ranks hold together where each rank's weights sum to the same), and
    runs AdamW on the shards, writing the new parameters, moments and
    count into the tensors given (the reference's ``donate_argnums``):
    a rank never holds its state twice, nor the whole moments.  The
    gradient norm is the whole gradient's (``optim.global_norm``).  On a
    1 x 1 mesh the step equals the step without it bit for bit.  A part
    of the tree whose spec is not a ``NamedSharding`` is left as it is on
    a group of one rank, and raises on a larger one.
    """

    def loss_fn(p, batch):
        logits, aux = T.forward(p, cfg, batch["tokens"],
                                **batch_extras(cfg, batch))
        w = batch["weights"][:, None] * torch.ones_like(
            batch["labels"], dtype=torch.float32)
        if cfg.n_patches:  # patch positions carry no next-token target
            w = torch.cat([torch.zeros_like(w[:, :cfg.n_patches]),
                           w[:, cfg.n_patches:]], dim=1)
        loss = T.lm_loss(logits, batch["labels"], w)
        total = (loss
                 + cfg.router_aux_weight * aux.get("load_balance", 0.0)
                 + z_loss_weight * aux.get("router_z", 0.0))
        return total, (loss, aux)

    grad_fn = grad(loss_fn, has_aux=True)

    @full_f32_matmul
    def step(params, opt_state, batch):
        laid = grad_specs is not None
        grads, (loss, aux) = grad_fn(gather(params) if laid else params,
                                     batch)
        if laid:
            grads = _constrain(grads, grad_specs)
        lr = lr_fn(opt_state.count)
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            inplace=laid)
        metrics = {"loss": loss.detach(), "lr": lr, **om,
                   **{k: v.detach() for k, v in aux.items()}}
        return params, opt_state, metrics

    return step


def build_prefill_step(cfg: ArchConfig,
                       cache_len: Optional[int] = None) -> Callable:
    """(params, batch) -> (last-position logits, caches)."""

    @torch.no_grad()
    def step(params, batch):
        return T.prefill(params, cfg, batch["tokens"], cache_len=cache_len,
                         **batch_extras(cfg, batch))

    return step


def build_decode_step(cfg: ArchConfig) -> Callable:
    """(params, token (B,1), caches, index) -> (logits, caches), ``index``
    a Python int; the caches are written in place and returned."""

    @torch.no_grad()
    def step(params, token, caches, index):
        return T.decode_step(params, cfg, token, caches, index)

    return step
