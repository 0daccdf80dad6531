"""The port's configs, model utilities and dense transformer
(``repro_torch.models``) against the JAX package's ``repro.models``, on
the CPU; descriptor trees and parameter counts for all ten architectures
(the serve path and the other block kinds: ``test_torch_serve*.py``).

Inputs come from a numpy seed and go through both packages; parameters are
made by the reference's ``init_params`` and carried across by
``repro_torch.models.params_from_numpy``.  Tolerances (of the reference's
largest magnitude):
  * float32: rel 1e-5 for norms, activations, rotary tables, attention, the
    MLP and the logits of ``forward`` — float32 sums taken in another order
    and transcendental functions that differ in the last bit;
  * bfloat16 (``forward`` with bfloat16 parameters and activations): rel
    1e-2, a few bfloat16 ulps (2^-8 each): the two frameworks round the
    activations to bfloat16 at different points of each sublayer.
Integers, shapes, descriptor trees and parameter counts are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.attention as JA
import repro.models.common as JM
import repro.models.mlp as JMLP
import repro.models.rope as JR
import repro.models.transformer as JT
import repro_torch.configs as PC
import repro_torch.models.attention as PA
import repro_torch.models.common as PM
import repro_torch.models.mlp as PMLP
import repro_torch.models.rope as PR
import repro_torch.models.transformer as PT
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.tree import tree_leaves, tree_paths

RTOL, BF16_RTOL = 1e-5, 1e-2
SMOKE_ARCHS = ("deepseek-7b", "starcoder2-3b")


def _np(x):
    return np.random.default_rng(x[0]).standard_normal(x[1]).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=RTOL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), err


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _cfgs(arch, **over):
    return (JC.get_config(arch).smoke_variant().with_overrides(**over),
            PC.get_config(arch).smoke_variant().with_overrides(**over))


def _params(jcfg, seed=0):
    jp = JT.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_and_shapes_equal_reference():
    assert list(PC.ARCHS) == list(JC.ARCHS)
    assert PC.SHAPES == JC.SHAPES
    for name in JC.ARCHS:
        j, p = JC.get_config(name), PC.get_config(name)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert dataclasses.asdict(p.smoke_variant()) == \
            dataclasses.asdict(j.smoke_variant())
        assert dataclasses.asdict(PC.windowed_variant(p)) == \
            dataclasses.asdict(JC.windowed_variant(j))
        assert PC.needs_window_for_long(p) == JC.needs_window_for_long(j)
        assert (p.hd, p.n_periods) == (j.hd, j.n_periods)
    with pytest.raises(KeyError, match="unknown arch"):
        PC.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# norms, activations, rotary tables
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    x, s, b = _np((0, (2, 5, 64))), _np((1, (64,))), _np((2, (64,)))
    _close(PM.rmsnorm(_t(x), _t(s)), JM.rmsnorm(jnp.asarray(x),
                                                 jnp.asarray(s)))
    _close(PM.layernorm(_t(x), _t(s), _t(b)),
           JM.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_act_fn_matches_reference(name):
    x = 3 * _np((3, (4, 257)))
    _close(PM.act_fn(name)(_t(x)), JM.act_fn(name)(jnp.asarray(x)))


def test_softcap_matches_reference():
    x = 40 * _np((4, (3, 50)))
    _close(PM.softcap(_t(x), 30.0), JM.softcap(jnp.asarray(x), 30.0))
    assert torch.equal(PM.softcap(_t(x), None), _t(x))


@pytest.mark.parametrize("theta", [10000.0, 100000.0])
def test_rope_matches_reference(theta):
    pos = np.arange(37, dtype=np.int32)
    jc, js = JR.rope_angles(jnp.asarray(pos), 32, theta)
    pc, ps = PR.rope_angles(_t(pos), 32, theta)
    _close(pc, jc)
    _close(ps, js)
    x = _np((5, (2, 37, 4, 32)))
    _close(PR.apply_rope(_t(x), pc[None], ps[None]),
           JR.apply_rope(jnp.asarray(x), jc[None], js[None]))


def test_mrope_and_sinusoidal_match_reference():
    pos = np.random.default_rng(6).integers(0, 50, (3, 2, 9)).astype(np.int32)
    jc, js = JR.mrope_angles(jnp.asarray(pos), 32, (4, 6, 6))
    pc, ps = PR.mrope_angles(_t(pos), 32, (4, 6, 6))
    _close(pc, jc)
    _close(ps, js)
    p1 = np.arange(11, dtype=np.int32)
    _close(PR.sinusoidal_positions(_t(p1), 64),
           JR.sinusoidal_positions(jnp.asarray(p1), 64))


# ---------------------------------------------------------------------------
# attention and the MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(24, 64), (128, 32), (96, 40)])
@pytest.mark.parametrize("causal,window,cap",
                         [(True, None, None), (False, None, None),
                          (True, 16, None), (True, None, 20.0),
                          (True, 8, 30.0)])
def test_attention_matches_reference(S, chunk, causal, window, cap):
    """Direct path (S <= chunk, and a ragged S % chunk) and the chunked
    online softmax (S a multiple of chunk), GQA with 2 query heads a KV
    head, and a window narrower than one chunk (fully masked chunks)."""
    B, H, K, hd = 2, 4, 2, 16
    q, k, v = (_np((7 + i, (B, S, n, hd))) for i, n in
               enumerate((H, K, K)))
    pos = np.arange(S, dtype=np.int32)
    valid = np.ones(S, bool)
    valid[-3:] = False
    kw = dict(causal=causal, window=window, cap=cap, chunk=chunk)
    ref = JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       qpos=jnp.asarray(pos), kpos=jnp.asarray(pos),
                       kvalid=jnp.asarray(valid), **kw)
    out = PA.attention(_t(q), _t(k), _t(v), qpos=_t(pos), kpos=_t(pos),
                       kvalid=_t(valid), **kw)
    _close(out, ref)


def test_projections_and_mlp_match_reference():
    jcfg, pcfg = _cfgs("starcoder2-3b")
    jp, pp = _params(jcfg, seed=3)
    jb = jax.tree.map(lambda a: a[0], jp["blocks"]["0"])
    pb = {k: v[0] for k, v in pp["blocks"]["0"].items()}
    x = _np((11, (2, 9, jcfg.d_model)))
    for a, b in zip(JA.qkv_proj(jb, jnp.asarray(x)),
                    PA.qkv_proj(pb, _t(x))):
        _close(b, a)
    o = _np((12, (2, 9, jcfg.n_heads, jcfg.hd)))
    _close(PA.out_proj(pb, _t(o)), JA.out_proj(jb, jnp.asarray(o)))
    _close(PMLP.mlp_apply(pb, _t(x), pcfg),
           JMLP.mlp_apply(jb, jnp.asarray(x), jcfg))


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_param_defs_axes_and_counts_equal_reference(arch):
    jcfg, pcfg = _cfgs(arch)
    assert PT.param_defs(pcfg) == JT.param_defs(jcfg)
    assert PT.param_axes(pcfg) == JT.param_axes(jcfg)
    assert PT.count_params(pcfg) == JT.count_params(jcfg)
    full = PC.get_config(arch)
    assert PT.count_params(full) == JT.count_params(JC.get_config(arch))


@pytest.mark.parametrize("S", [16, 128])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_forward_matches_reference(arch, S):
    """deepseek-7b (rmsnorm, silu, MHA) and starcoder2-3b (layernorm, gelu,
    GQA 4:1, window 4096) smoke variants; S = 128 takes the chunked path
    (attn_chunk 64)."""
    jcfg, pcfg = _cfgs(arch)
    jp, pp = _params(jcfg)
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S)).astype(
        np.int32)
    jl, jaux = JT.forward(jp, jcfg, jnp.asarray(toks))
    pl, paux = PT.forward(pp, pcfg, _t(toks))
    assert pl.dtype == torch.float32
    _close(pl, jl)
    assert sorted(paux) == sorted(jaux)
    labels = np.roll(toks, -1, axis=1)
    w = np.random.default_rng(1).random((2, S)).astype(np.float32)
    _close(PT.lm_loss(pl, _t(labels), _t(w)),
           JT.lm_loss(jl, jnp.asarray(labels), jnp.asarray(w)))


def test_forward_gemma_features_match_reference():
    """gemma2's softcaps, post-block norms, embedding scale, local/global
    period and gelu, narrowed to a short window so it masks."""
    jcfg, pcfg = _cfgs("gemma2-27b")
    period = tuple(dataclasses.replace(b, window=8 if b.window else None)
                   for b in jcfg.period)
    jcfg = jcfg.with_overrides(period=period)
    pcfg = pcfg.with_overrides(period=tuple(
        PC.BlockSpec(**dataclasses.asdict(b)) for b in period))
    jp, pp = _params(jcfg, seed=2)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (1, 40)).astype(
        np.int32)
    _close(PT.forward(pp, pcfg, _t(toks))[0],
           JT.forward(jp, jcfg, jnp.asarray(toks))[0])


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_forward_bfloat16_matches_reference(arch):
    jcfg, pcfg = _cfgs(arch, dtype="bfloat16", param_dtype="bfloat16")
    jp, pp = _params(jcfg, seed=1)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(pp))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 32)).astype(
        np.int32)
    pl = PT.forward(pp, pcfg, _t(toks))[0]
    assert pl.dtype == torch.float32
    _close(pl, JT.forward(jp, jcfg, jnp.asarray(toks))[0], BF16_RTOL)


def test_converter_round_trip_keeps_values_and_dtypes():
    for dt in ("float32", "bfloat16"):
        jcfg, _ = _cfgs("deepseek-7b", param_dtype=dt)
        jp = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(4)))
        pp = params_from_numpy(jp, "cpu")
        back = params_to_numpy(pp)
        for (path, a), b in zip(tree_paths(jp), tree_leaves(back)):
            assert str(_leaf(pp, path).dtype) == f"torch.{dt}"
            assert b.dtype == np.float32
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)
        again = params_from_numpy(back, "cpu")
        for a, b in zip(tree_leaves(again), tree_leaves(pp)):
            assert torch.equal(a, b.float())


def test_init_params_distributions_and_order():
    """Same shapes, dtypes and leaf order as the reference; zeros where it
    has zeros; normals with its scale (1/sqrt(fan_in), embed 1.0); one
    seed gives the same tree, another seed another."""
    jcfg, pcfg = _cfgs("deepseek-7b")
    jp = JT.init_params(jcfg, jax.random.key(0))
    a = PT.init_params(pcfg, 0, device="cpu")
    assert [p for p, _ in tree_paths(a)] == \
        [tuple(getattr(k, "key", k) for k in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    for (path, t), r in zip(tree_paths(a), jax.tree_util.tree_leaves(jp)):
        r = np.asarray(r)
        assert tuple(t.shape) == r.shape and t.dtype == torch.float32
        if not r.any():
            assert not t.any()
        else:
            assert float(t.std()) == pytest.approx(float(r.std()), rel=0.1)
    b = PT.init_params(pcfg, 0, device="cpu")
    c = PT.init_params(pcfg, 1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])


def test_init_params_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_params(PC.get_config("deepseek-7b").smoke_variant(), 0)
