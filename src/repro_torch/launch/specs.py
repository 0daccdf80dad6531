"""Meta-device input stand-ins and their placements for the dry run (port of
``repro.launch.specs``).

``input_specs(cfg, shape_name)`` returns ``(kind, inputs)`` with meta
tensors (shape and dtype, no storage) in place of the reference's
``ShapeDtypeStruct``s, for each execution kind:

  train   -> {tokens, labels, weights, <modality extras>}
  prefill -> {tokens, <modality extras>}
  decode  -> (token, caches, index): ONE new token + caches of seq_len

``input_shardings(cfg, shape_name, mesh)`` mirrors that structure with
``sharding.NamedSharding`` leaves.  Placements: the batch over the data
axes (``("pod", "data")``) when their size divides it
(``sharding.batch_on_data``); where it does not (long_500k's batch of 1)
an attention cache's SEQUENCE dim goes over the data axes instead when
they divide its length (``sharding.seq_on_data``, which the serve steps
ask too: context-parallel decode, each rank its slots, the softmax merged
over the data group); `kv` goes on `model` only when ``n_kv`` divides,
and Mamba's ``d_inner`` and the xLSTM heads likewise.

``param_structs(cfg)`` gives the parameters as meta tensors, straight
from ``param_defs`` (the reference's ``jax.eval_shape(init_params)``):
nothing is drawn or allocated, so the largest configuration costs
nothing.
"""
from __future__ import annotations


import torch

from repro_torch.configs import SHAPES, needs_window_for_long, windowed_variant
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import Dtype
from repro_torch.sharding import (NamedSharding, axis_size, batch_axes,
                                  batch_on_data, placements_for,
                                  seq_on_data)

__all__ = ["shape_config", "input_specs", "input_shardings",
           "output_shardings", "cache_struct", "param_structs"]

META = torch.device("meta")


def shape_config(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """The architecture variant run for this input shape: the windowed one
    where long_500k meets a full-attention block."""
    if shape_name == "long_500k" and needs_window_for_long(cfg):
        return windowed_variant(cfg)
    return cfg


def param_structs(cfg: ArchConfig) -> dict:
    """Meta-tensor parameters with ``init_params``' tree and dtype."""
    from repro_torch.models.common import _is_def

    dt = Dtype.of(cfg.param_dtype)

    def walk(d):
        if _is_def(d):
            return torch.empty(d["shape"], dtype=dt, device=META)
        return {k: walk(v) for k, v in sorted(d.items())
                if k != "__pdef__"}

    return walk(T.param_defs(cfg))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _extras_struct(cfg: ArchConfig, B: int, S: int) -> dict:
    dt = Dtype.of(cfg.dtype)
    out = {}
    if cfg.n_patches:
        out["patch_embeds"] = _meta((B, cfg.n_patches, cfg.d_vision), dt)
        out["mrope_positions"] = _meta((3, B, S), torch.int32)
    if cfg.n_enc_layers:
        out["enc_embeds"] = _meta((B, cfg.n_enc_frames, cfg.d_model), dt)
    return out


def cache_struct(cfg: ArchConfig, B: int, cache_len: int):
    """Meta-tensor decode caches (``init_caches``' tree, no storage)."""
    return T.init_caches(cfg, B, cache_len, device=META)


def input_specs(cfg: ArchConfig, shape_name: str):
    """``(kind, inputs)`` with meta-tensor leaves."""
    shp = SHAPES[shape_name]
    B, S, kind = shp["global_batch"], shp["seq_len"], shp["kind"]
    if kind == "train":
        inputs = {"tokens": _meta((B, S), torch.int32),
                  "labels": _meta((B, S), torch.int32),
                  "weights": _meta((B,), torch.float32)}
        inputs.update(_extras_struct(cfg, B, S))
        return kind, inputs
    if kind == "prefill":
        inputs = {"tokens": _meta((B, S), torch.int32)}
        inputs.update(_extras_struct(cfg, B, S))
        return kind, inputs
    # decode: one token, cache of length S (position S-1 being generated)
    token = _meta((B, 1), torch.int32)
    index = _meta((), torch.int32)
    return kind, (token, cache_struct(cfg, B, S), index)


# ------------------------------------------------------------- shardings ---

def _named(mesh, spec: tuple) -> NamedSharding:
    return NamedSharding(mesh, spec, placements_for(mesh, spec))


def _batch_spec(mesh, B: int, rest_ndim: int) -> tuple:
    first = batch_axes(mesh) if batch_on_data(B, mesh) else None
    return (first,) + (None,) * rest_ndim


def _cache_specs(cfg: ArchConfig, B: int, cache_len: int, mesh,
                 place=lambda spec: spec) -> tuple:
    """Spec tree mirroring ``init_caches``' structure, each spec passed
    through ``place``."""
    ba = batch_axes(mesh)
    msz = axis_size(mesh, "model")
    bspec = ba if batch_on_data(B, mesh) else None

    def attn_spec(C):
        # context-parallel decode for a batch the data axes do not take
        seq = ba if seq_on_data(B, C, mesh) else None
        kv = "model" if cfg.n_kv % msz == 0 else None
        s = place((None, bspec, seq, kv, None))
        return T.attn.AttnCache(s, s)

    di = cfg.mamba_expand * cfg.d_model
    specs = []
    for spec in cfg.period:
        if spec.kind == "attn":
            C = min(cache_len, spec.window) if spec.window else cache_len
            s = attn_spec(C)
            if spec.cross_attn:
                s = (s, attn_spec(max(cfg.n_enc_frames, 1)))
        elif spec.kind == "mamba":
            dim = "model" if di % msz == 0 else None
            s = T.mb.MambaCache(place((None, bspec, None, dim)),
                                place((None, bspec, dim, None)))
        elif spec.kind == "mlstm":
            hdim = "model" if cfg.n_heads % msz == 0 else None
            s = T.xl.MLSTMCache(place((None, bspec, hdim, None, None)),
                                place((None, bspec, hdim, None)),
                                place((None, bspec, hdim)))
        elif spec.kind == "slstm":
            hdim = "model" if cfg.n_heads % msz == 0 else None
            sp = place((None, bspec, hdim, None))
            s = T.xl.SLSTMCache(sp, sp, sp, sp)
        else:
            raise ValueError(spec.kind)
        specs.append(s)
    return tuple(specs)


def input_shardings(cfg: ArchConfig, shape_name: str, mesh):
    """``NamedSharding`` tree matching ``input_specs``' structure."""
    shp = SHAPES[shape_name]
    B, S, kind = shp["global_batch"], shp["seq_len"], shp["kind"]
    ns = lambda spec: _named(mesh, spec)  # noqa: E731

    def extras():
        out = {}
        if cfg.n_patches:
            out["patch_embeds"] = ns(_batch_spec(mesh, B, 2))
            out["mrope_positions"] = ns((None,) + _batch_spec(mesh, B, 1))
        if cfg.n_enc_layers:
            out["enc_embeds"] = ns(_batch_spec(mesh, B, 2))
        return out

    tok = ns(_batch_spec(mesh, B, 1))
    if kind == "train":
        sh = {"tokens": tok, "labels": tok,
              "weights": ns(_batch_spec(mesh, B, 0))}
        sh.update(extras())
        return sh
    if kind == "prefill":
        sh = {"tokens": tok}
        sh.update(extras())
        return sh
    return (tok, _cache_specs(cfg, B, S, mesh, place=ns), ns(()))


def output_shardings(cfg: ArchConfig, shape_name: str, mesh):
    """``NamedSharding`` tree of a prefill or decode step's outputs, (last
    logits (B, 1, V), caches of seq_len): the batch as the inputs place
    it, the caches as ``input_shardings`` places decode's."""
    shp = SHAPES[shape_name]
    B, S = shp["global_batch"], shp["seq_len"]
    return (_named(mesh, _batch_spec(mesh, B, 2)),
            _cache_specs(cfg, B, S, mesh,
                         place=lambda spec: _named(mesh, spec)))
