"""Step builders: plain train step, prefill step, decode step (port of
``repro.train.steps``).

The paper's technique enters ``train_step`` through the per-sample weight
vector: the host computes FRC decode weights from the straggler mask
(core.gradient_coding) and the weighted loss makes the gradient a masked,
rescaled sum over surviving workers' shards.  Everything is a function of
(params, opt_state, batch) that returns new values: nothing passed in is
updated in place, but the decode step writes into the caches it is given
(``models.decode_step``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32_matmul
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_update

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "batch_extras"]


def batch_extras(cfg: ArchConfig, batch: dict) -> dict:
    kw = {}
    if cfg.n_patches:
        kw["patch_embeds"] = batch["patch_embeds"]
        kw["mrope_positions"] = batch["mrope_positions"]
    if cfg.n_enc_layers:
        kw["enc_embeds"] = batch["enc_embeds"]
    return kw


def build_train_step(cfg: ArchConfig, lr_fn: Callable,
                     weight_decay: float = 0.1,
                     z_loss_weight: float = 1e-3,
                     grad_specs=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    batch: tokens (B,S) int, labels (B,S) int, weights (B,) f32 coded
    decode weights, plus modality extras (patch/enc embeddings), all on the
    parameters' device.  ``grad_specs`` constrains the gradients to a mesh
    sharding in the reference; on one device it has no meaning, and the
    port accepts it and ignores it.  Float32 products run in full float32
    (TF32 off), as the reference computes.
    """
    del grad_specs

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
        grads, (loss, aux) = grad_fn(params, batch)
        lr = lr_fn(opt_state.count)
        params, opt_state, om = adamw_update(
            grads, opt_state, params, lr=lr, weight_decay=weight_decay)
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
