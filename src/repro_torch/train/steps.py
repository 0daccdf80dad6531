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

Given ``DTensor`` shards, each step runs the rank's program on its mesh:
it gathers the data (FSDP) axes, keeps each leaf that its layer computes
on a model shard (``transformer.model_shards``) as the rank's shard, and
runs the model with the mesh's ``model`` dim as the model axis
(``sharding.tp``).  The serve steps told a global batch that the mesh's
data axes do not take (``sharding.batch_on_data``; long_500k's batch of
1) also set the data axis: the attention caches whose sequence
``sharding.seq_on_data`` splits are each rank's slots (context-parallel
decode).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.func import grad

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32_matmul
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_update
from repro_torch.sharding import batch_on_data, tp
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "batch_extras", "place_params", "place_train_state", "gather",
           "mesh_of"]


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


def _by_spec(tree, specs, fn, rest=lambda t: t, flags=None):
    """``fn(leaf, sharding)`` over the leaves of ``tree`` that ``specs``
    (a tree of ``NamedSharding``s or a prefix of one, as ``grad_specs``)
    covers; ``rest(part)`` for each part it does not.  ``flags``: a tree
    like ``tree``'s, whose leaf goes to ``fn`` as a third argument."""
    from repro_torch.sharding import NamedSharding

    if isinstance(specs, NamedSharding):
        if flags is None:
            return tree_map(lambda t: fn(t, specs), tree)
        return tree_map(lambda t, f: fn(t, specs, f), tree, flags)
    if isinstance(specs, dict) and isinstance(tree, dict):
        return {k: _by_spec(t, specs.get(k), fn, rest,
                            None if flags is None else flags[k])
                for k, t in tree.items()}
    return rest(tree)


def mesh_of(tree):
    """The ``DeviceMesh`` of ``tree``'s ``DTensor`` leaves, or ``None``."""
    from torch.distributed.tensor import DTensor

    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


@torch.no_grad()
def place_params(params, shardings):
    """``params`` as ``DTensor``s of ``shardings``' layouts, each holding
    this rank's shard (``place_train_state``'s parameters; the serve
    steps take them)."""
    return _by_spec(params, shardings, _shard)


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
    return (place_params(params, shardings),
            type(opt_state)(_by_spec(opt_state.m, shardings, _shard),
                            _by_spec(opt_state.v, shardings, _shard),
                            opt_state.count))


def gather(tree, shards=None):
    """The tensors a rank computes on: every ``DTensor`` leaf of ``tree``
    gathered over its mesh's data axes (the FSDP all-gather), and over
    ``model`` too unless ``shards`` (a tree of bools like ``tree``'s,
    ``transformer.model_shards``) says its layer computes it on the rank's
    model shard; unset, every leaf whole.  Plain leaves as they are.  A
    gather over ``model`` is recorded for the dry run (``tp.record``); the
    data axes' gathers it counts from the placements."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t, shard=False):
        if not isinstance(t, DTensor):
            return t
        mesh, names = t.device_mesh, t.device_mesh.mesh_dim_names
        if not shard:
            out = t.full_tensor()
            if any(n == "model" and p.is_shard() and mesh.size(i) > 1
                   for i, (n, p) in enumerate(zip(names, t.placements))):
                tp.record("all-gather", out)
            return out
        keep = [p if n == "model" else Replicate()
                for n, p in zip(names, t.placements)]
        return t.redistribute(mesh, keep).to_local()

    if shards is None:
        return tree_map(one, tree)
    return tree_map(one, tree, shards)


def _data_size(mesh) -> int:
    """The ranks of ``mesh``'s data axes (every dim but ``model``)."""
    return math.prod(mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)
                     if n != "model")


@torch.no_grad()
def _lay_out(g: torch.Tensor, sharding, shard: bool = False):
    """The mean over the data axes of every rank's ``g``, reduce-scattered
    to ``sharding``'s placements: a ``DTensor`` holding this rank's shard
    of it.  Each rank's ``g`` is a partial sum over the data axes and, on
    ``model``, the gradient of the rank's model shard (``shard``: its layer
    computed it there) or of the whole leaf, the same on every rank of the
    model group."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = sharding.mesh
    src = [(p if shard else Replicate()) if n == "model" else Partial("sum")
           for n, p in zip(mesh.mesh_dim_names, sharding.placements)]
    d = DTensor.from_local(g, mesh, src, run_check=False)
    d = d.redistribute(mesh, sharding.placements)
    return DTensor.from_local(d.to_local() / _data_size(mesh), mesh,
                              sharding.placements, run_check=False,
                              shape=d.shape, stride=d.stride())


def _constrain(grads, specs, shards=None):
    """``grads`` laid out to the ``NamedSharding``s of ``specs``, a tree or
    a prefix of one (``build_train_step``'s ``grad_specs``); ``shards`` as
    ``gather``'s (unset: every gradient of a whole leaf)."""
    import torch.distributed as dist

    def rest(part):
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(
                f"grad_specs leaves a gradient without a NamedSharding on a "
                f"group of {dist.get_world_size()} ranks: it would stay each"
                f" rank's own, and the ranks' parameters would drift apart")
        return part

    return _by_spec(grads, specs, _lay_out, rest, shards)


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
    ``DTensor`` shards laid out by it (``place_train_state``).  The step
    gathers the parameters over the mesh's data axes at its top (the FSDP
    all-gather; ``gather``), so each leaf that its layer computes on a
    model shard (``transformer.model_shards``: attention heads, MLP ff
    columns, experts, vocabulary rows, Mamba d_inner channels, mLSTM and
    sLSTM heads) comes out as the rank's shard on
    ``model`` and the rest whole, and runs the forward and backward pass
    with the mesh's ``model`` dim as the model axis (``sharding.tp``: the
    activation all-reduces between the shards).  The batch is the rank's
    data shard: the ranks of one model group pass the same rows.  Each
    rank's gradient, a partial sum over the data axes, is
    reduce-scattered to its placements and divided by the data axes' size
    (so every rank steps with its shard of the mean of the data ranks'
    gradients: the gradient of the batch they hold together where each
    one's weights sum to the same), and AdamW runs on the shards, writing
    the new parameters, moments and count into the tensors given (the
    reference's ``donate_argnums``): a rank never holds its state twice,
    nor the whole moments.  The gradient norm is the whole gradient's
    (``optim.global_norm``).  On a 1 x 1 mesh the step equals the step
    without it bit for bit.  A part of the tree whose spec is not a
    ``NamedSharding`` is left as it is on a group of one rank, and raises
    on a larger one.
    """

    def loss_fn(p, batch):
        logits, aux = T.forward(p, cfg, batch["tokens"],
                                **batch_extras(cfg, batch))
        w = batch["weights"][:, None] * torch.ones_like(
            batch["labels"], dtype=torch.float32)
        if cfg.n_patches:  # patch positions carry no next-token target
            w = torch.cat([torch.zeros_like(w[:, :cfg.n_patches]),
                           w[:, cfg.n_patches:]], dim=1)
        loss = T.lm_loss(logits, batch["labels"], w, vocab=cfg.vocab)
        total = (loss
                 + cfg.router_aux_weight * aux.get("load_balance", 0.0)
                 + z_loss_weight * aux.get("router_z", 0.0))
        return total, (loss, aux)

    grad_fn = grad(loss_fn, has_aux=True)
    shards = T.model_shards(cfg)

    @full_f32_matmul
    def step(params, opt_state, batch):
        laid = grad_specs is not None
        if laid:
            with tp.model_axis(mesh_of(params)):
                grads, (loss, aux) = grad_fn(gather(params, shards), batch)
            grads = _constrain(grads, grad_specs, shards)
        else:
            grads, (loss, aux) = grad_fn(params, batch)
        lr = lr_fn(opt_state.count)
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay,
            inplace=laid)
        metrics = {"loss": loss.detach(), "lr": lr, **om,
                   **{k: v.detach() for k, v in aux.items()}}
        return params, opt_state, metrics

    return step


def _data_axis(params, B: Optional[int]):
    """``tp.data_axis`` of ``params``' mesh where its data axes do not take
    a global batch of ``B`` (context-parallel decode), else (``B`` unset
    too) no data axis."""
    mesh = mesh_of(params)
    return tp.data_axis(None if mesh is None or B is None
                        or batch_on_data(B, mesh) else mesh)


def build_prefill_step(cfg: ArchConfig, cache_len: Optional[int] = None, *,
                       global_batch: Optional[int] = None) -> Callable:
    """(params, batch) -> (last-position logits, caches).  ``params`` may
    be ``DTensor`` shards (``place_params``): the rank's program on their
    mesh (module docstring), the logits whole, the caches the rank's:
    its kv heads, Mamba channels or xLSTM heads on ``model`` and, where
    the data axes do not take the batch, its slots of each attention
    cache that ``sharding.seq_on_data`` splits (the sequence computed
    whole on every rank).  ``global_batch``: the batch that the data axes
    place, of which each rank is given its rows where they take it
    (``sharding.batch_on_data``) and the whole where they do not (batch
    1: every rank the same rows); unset, the batch's placement is not
    known, and every cache stays whole on every rank."""
    shards = T.model_shards(cfg)

    @torch.no_grad()
    def step(params, batch):
        with tp.model_axis(mesh_of(params)), \
                _data_axis(params, global_batch):
            return T.prefill(gather(params, shards), cfg, batch["tokens"],
                             cache_len=cache_len, **batch_extras(cfg, batch))

    return step


def build_decode_step(cfg: ArchConfig, cache_len: Optional[int] = None, *,
                      global_batch: Optional[int] = None) -> Callable:
    """(params, token (B,1), caches, index) -> (logits, caches), ``index``
    a Python int; the caches are written in place and returned.
    ``params`` and ``global_batch`` as ``build_prefill_step``'s, the
    caches then the rank's, as its prefill step returns them: on a data
    axis each attention cache that ``sharding.seq_on_data`` splits is the
    rank's slots, the new key is written by the rank that owns its slot
    and attention is merged over the data group.  ``cache_len``: the
    caches' global length (prefill's), required there."""
    shards = T.model_shards(cfg)

    @torch.no_grad()
    def step(params, token, caches, index):
        with tp.model_axis(mesh_of(params)), \
                _data_axis(params, global_batch):
            return T.decode_step(gather(params, shards), cfg, token, caches,
                                 index, cache_len=cache_len)

    return step
