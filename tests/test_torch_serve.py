"""Every architecture of the zoo through the port's three execution paths
(``repro_torch.models``: ``forward``, ``prefill``, ``decode_step``)
against the JAX package's ``repro.models``, at ``smoke_variant()``, on
the CPU.

Parameters are the reference's ``init_params``, carried across with
``params_from_numpy``; inputs (tokens, patch embeddings with M-RoPE
positions, encoder frames) come from a numpy seed; caches cross with
``caches_from_numpy`` / ``caches_to_numpy``.  Decode is teacher-forced
with the reference's tokens (no argmax, so no near-tie can flip a
token).  Tolerances, of the reference's largest magnitude:
  * rel 1e-5: logits of every path, the router aux terms, every cache
    leaf — float32 sums in another order;
  * rel 1e-4 for the caches of jamba (Mamba) and xlstm (mLSTM): the
    port's log-step scan and the mLSTM's chunk contractions round in
    another order, carried through the chunk's products.

The port's own prefill + decode against its own forward, ``init_caches``
and the train step are in ``test_torch_serve_steps.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.transformer as JT
import repro_torch.configs as PC
import repro_torch.models.transformer as PT
from repro_torch.models import (caches_from_numpy, caches_to_numpy,
                                params_from_numpy)
from repro_torch.tree import tree_leaves

ARCHS = sorted(JC.ARCHS)
RTOL, SCAN_RTOL = 1e-5, 1e-4
B, S, NEW = 2, 64, 4


def _close(out, ref, rtol=RTOL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), err


def _cache_rtol(arch):
    kinds = {b.kind for b in JC.get_config(arch).period}
    return SCAN_RTOL if kinds & {"mamba", "mlstm"} else RTOL


def _same_structure(port, ref):
    """Equal nesting, NamedTuple class names and fields, and leaf shapes."""
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref)
        assert type(port).__name__ == type(ref).__name__
        assert getattr(port, "_fields", None) == getattr(ref, "_fields", None)
        for a, b in zip(port, ref):
            _same_structure(a, b)
    else:
        assert tuple(port.shape) == tuple(ref.shape)


@functools.lru_cache(maxsize=None)
def _setup(arch, capacity_factor=None):
    over = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    jcfg = JC.get_config(arch).smoke_variant().with_overrides(**over)
    pcfg = PC.get_config(arch).smoke_variant().with_overrides(**over)
    jp = JT.init_params(jcfg, jax.random.key(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S + NEW)).astype(np.int32)
    kw = {}
    if jcfg.n_patches:
        kw["patch_embeds"] = (rng.standard_normal(
            (B, jcfg.n_patches, jcfg.d_vision)) * 0.02).astype(np.float32)
        kw["mrope_positions"] = np.broadcast_to(
            np.arange(S + NEW)[None, None], (3, B, S + NEW)).astype(np.int32)
    if jcfg.n_enc_layers:
        kw["enc_embeds"] = (rng.standard_normal(
            (B, jcfg.n_enc_frames, jcfg.d_model)) * 0.02).astype(np.float32)
    return jcfg, pcfg, jp, pp, toks, kw


def _inputs(kw, n):
    """Reference and port keyword inputs for the first n positions."""
    kw = dict(kw)
    if "mrope_positions" in kw:
        kw["mrope_positions"] = kw["mrope_positions"][:, :, :n]
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in kw.items()})


def _ref_prefill(jp, jcfg, toks, jkw):
    return jax.jit(functools.partial(JT.prefill, cfg=jcfg,
                                     cache_len=S + 8))(jp, tokens=toks, **jkw)


_ref_decode = jax.jit(JT.decode_step, static_argnums=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, pcfg, jp, pp, toks, kw = _setup(arch)
    jkw, pkw = _inputs(kw, S + NEW)
    jl, jaux = jax.jit(JT.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks), **jkw)
    pl, paux = PT.forward(pp, pcfg, torch.from_numpy(toks), **pkw)
    assert pl.dtype == torch.float32
    _close(pl, jl)
    assert sorted(paux) == sorted(jaux)
    for name in jaux:
        _close(paux[name], jaux[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    """Last-position logits and every cache leaf, with the reference's
    structure: per period position, stacked over n_periods; KV caches
    padded to cache_len (capped at the window), cross-attention pairs."""
    jcfg, pcfg, jp, pp, toks, kw = _setup(arch)
    jkw, pkw = _inputs(kw, S)
    jl, jc = _ref_prefill(jp, jcfg, jnp.asarray(toks[:, :S]), jkw)
    pl, pc = PT.prefill(pp, pcfg, torch.from_numpy(toks[:, :S]),
                        cache_len=S + 8, **pkw)
    _close(pl, jl)
    _same_structure(pc, jc)
    for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(jc)):
        assert a.dtype == torch.float32
        _close(a, b, _cache_rtol(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_reference_caches(arch):
    """The port's ``decode_step`` fed the reference's prefill caches,
    teacher-forced with the reference's tokens for four steps: logits and
    caches step by step; then the reference's ``decode_step`` fed the
    port's own prefill caches (``caches_to_numpy``) for one step."""
    jcfg, pcfg, jp, pp, toks, kw = _setup(arch)
    jkw, pkw = _inputs(kw, S)
    _, jc = _ref_prefill(jp, jcfg, jnp.asarray(toks[:, :S]), jkw)
    pc = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for i in range(NEW):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = _ref_decode(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(S + i))
        pl, pc2 = PT.decode_step(pp, pcfg, torch.from_numpy(tok), pc, S + i)
        assert pc2 is pc                      # written in place, returned
        _close(pl, jl)
        for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(jc)):
            _close(a, b, _cache_rtol(arch))
    _, own = PT.prefill(pp, pcfg, torch.from_numpy(toks[:, :S]),
                        cache_len=S + 8, **pkw)
    tok = toks[:, S:S + 1]
    jl, _ = _ref_decode(jp, jcfg, jnp.asarray(tok),
                        caches_to_numpy(own), jnp.int32(S))
    pl, _ = PT.decode_step(pp, pcfg, torch.from_numpy(tok), own, S)
    _close(pl, jl)
