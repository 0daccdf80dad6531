"""Every architecture's serve path in bfloat16 (the configs' own dtypes),
at ``smoke_variant()``, against the JAX package's, on the CPU: forward,
prefill and one decode step from the reference's caches, within rel 1e-2
of the reference's largest logit, a few bfloat16 ulps (2^-8 each): the
two frameworks round activations to bfloat16 at different points of each
sublayer.  Parameters are the reference's ``init_params`` in bfloat16,
carried across bit for bit; inputs are ``test_torch_serve``'s.
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
from repro_torch.models import caches_from_numpy, params_from_numpy
from repro_torch.tree import tree_leaves
from test_torch_serve import ARCHS, _close, _inputs, _setup

BF16_RTOL = 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_paths_match_reference(arch):
    """bfloat16 parameters and activations (module docstring).  An MoE
    layer routes every token to every expert
    here (top_k = n_experts, capacity factor 4.0): a router input one
    bfloat16 ulp apart can switch a token's expert at a near-tie (seen at
    one token of 64), a different result, not a rounding; with every
    expert chosen no choice can switch, and the dispatch, expert products
    and weighted combine still run in bfloat16.  The choices themselves
    are held in float32 by the other tests."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16",
                capacity_factor=4.0)
    n_experts = JC.get_config(arch).smoke_variant().n_experts
    if n_experts:
        over["top_k"] = n_experts
    jcfg = JC.get_config(arch).smoke_variant().with_overrides(**over)
    pcfg = PC.get_config(arch).smoke_variant().with_overrides(**over)
    jp = JT.init_params(jcfg, jax.random.key(1))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(pp))
    toks = _setup(arch)[4]
    n = 32
    jkw, pkw = _inputs(_setup(arch)[5], n)
    jl = jax.jit(JT.forward, static_argnums=1)(
        jp, jcfg, jnp.asarray(toks[:, :n]), **jkw)[0]
    pl = PT.forward(pp, pcfg, torch.from_numpy(toks[:, :n]), **pkw)[0]
    assert pl.dtype == torch.float32
    _close(pl, jl, BF16_RTOL)
    jl, jc = jax.jit(functools.partial(JT.prefill, cfg=jcfg,
                                       cache_len=n + 1))(
        jp, tokens=jnp.asarray(toks[:, :n]), **jkw)
    pl, _ = PT.prefill(pp, pcfg, torch.from_numpy(toks[:, :n]),
                       cache_len=n + 1, **pkw)
    _close(pl, jl, BF16_RTOL)
    tok = toks[:, n:n + 1]
    jl, _ = jax.jit(JT.decode_step, static_argnums=1)(
        jp, jcfg, jnp.asarray(tok), jc, jnp.int32(n))
    pl, _ = PT.decode_step(pp, pcfg, torch.from_numpy(tok), caches_from_numpy(
        jax.tree.map(np.asarray, jc), "cpu"), n)
    _close(pl, jl, BF16_RTOL)
