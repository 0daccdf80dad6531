"""The port's serve-path blocks (``repro_torch.models``: KV caches and
``decode_attend``, the banded window, MoE, Mamba, mLSTM / sLSTM) against
the JAX package's ``repro.models``, module by module, on the CPU.

Inputs come from a numpy seed; block parameters are the reference's
``tree_init`` of the block's descriptor tree, carried across with
``params_from_numpy``, and caches cross with ``caches_from_numpy``.
Tolerances (of the reference's largest magnitude):
  * rel 1e-5 where the port sums in the reference's order: attention and
    its caches, the MoE dispatch and combine (top-2 and top-4: the combine
    adds k contributions a token in sorted-slot order, as the reference's
    scatter-add), both aux losses, the sLSTM recurrence;
  * rel 1e-4 for the Mamba scan and the mLSTM chunk sums: the port's
    Hillis-Steele scan multiplies the (a, b) pairs in another tree than
    ``lax.associative_scan``, and the mLSTM's three-operand einsums
    contract in another order, each an extra float32 rounding a step
    carried through the chunk's products.
Integers, positions, validity masks and capacity decisions are equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.attention as JA
import repro.models.common as JM
import repro.models.mamba as JMB
import repro.models.moe as JMOE
import repro.models.xlstm as JX
import repro_torch.configs as PC
import repro_torch.models.attention as PA
import repro_torch.models.mamba as PMB
import repro_torch.models.moe as PMOE
import repro_torch.models.xlstm as PX
from repro_torch.models import (caches_from_numpy, caches_to_numpy,
                                params_from_numpy)
from repro_torch.tree import tree_leaves

RTOL, SCAN_RTOL = 1e-5, 1e-4


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=RTOL):
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), err


def _trees_close(out, ref, rtol=RTOL):
    a, b = tree_leaves(out), jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _close(x, y, rtol)


def _cfgs(arch, **over):
    return (JC.get_config(arch).smoke_variant().with_overrides(**over),
            PC.get_config(arch).smoke_variant().with_overrides(**over))


def _jit(fn, **static):
    """The reference function compiled once with its config arguments
    bound (one XLA compile, where op-by-op dispatch compiles each op)."""
    return jax.jit(functools.partial(fn, **static))


def _block(defs, seed):
    """(reference params, port params) of one block's descriptor tree."""
    jp = JM.tree_init(defs, jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# KV caches, ring positions, decode_attend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [1, 5, 8, 64])
@pytest.mark.parametrize("index", [0, 1, 3, 7, 8, 9, 63, 64, 200])
def test_ring_slot_positions_match_reference(cache_len, index):
    jp, jv = JA.ring_slot_positions(cache_len, jnp.int32(index))
    pp, pv = PA.ring_slot_positions(cache_len, index, device="cpu")
    assert pp.dtype == torch.int32
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch,make", [
    ("jamba-1.5-large-398b",
     lambda cfg: PA.init_kv_cache(2, 12, 3, 16, torch.float32)),
    ("jamba-1.5-large-398b", lambda cfg: PA.ring_slot_positions(8, 3)),
    ("jamba-1.5-large-398b",
     lambda cfg: PMB.init_mamba_cache(cfg, 2, torch.float32)),
    ("xlstm-350m", lambda cfg: PX.init_mlstm_cache(cfg, 2, torch.float32)),
    ("xlstm-350m", lambda cfg: PX.init_slstm_cache(cfg, 2, torch.float32)),
], ids=["kv", "ring", "mamba", "mlstm", "slstm"])
def test_cache_constructors_without_device_raise_when_no_card(arch, make,
                                                              monkeypatch):
    """An unset device means the card, never a silent CPU tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PC.get_config(arch).smoke_variant()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(cfg)


def test_init_kv_cache_matches_reference():
    j = JA.init_kv_cache(2, 12, 3, 16, jnp.bfloat16)
    p = PA.init_kv_cache(2, 12, 3, 16, torch.bfloat16, device="cpu")
    assert type(p).__name__ == type(j).__name__ and p._fields == j._fields
    for a, b in zip(p, j):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
        assert not a.any()


@pytest.mark.parametrize("C,window,chunk,cap", [
    (24, None, 64, None),     # direct softmax, full cache
    (256, None, 64, 50.0),    # a long cache: the chunked online softmax
    (8, 8, 64, 50.0),         # a ring buffer narrower than the sequence
    (128, 128, 32, None),     # a windowed ring through the chunked path
])
def test_decode_attend_matches_reference(C, window, chunk, cap):
    """Six tokens decoded into a cache that is first filled at random: the
    port writes each key and value in place at slot index % C, and the
    outputs and caches follow the reference's step by step, the slot
    positions wrapping past the ring's length."""
    jcfg, pcfg = _cfgs("starcoder2-3b", attn_chunk=chunk)
    jp, pp = _block(JA.attn_defs(jcfg), 1)
    B, K, hd = 2, jcfg.n_kv, jcfg.hd
    k0, v0 = _np(2, (B, C, K, hd)), _np(3, (B, C, K, hd))
    jc = JA.AttnCache(jnp.asarray(k0), jnp.asarray(v0))
    pc = caches_from_numpy(JA.AttnCache(k0, v0), "cpu")
    rope = lambda t, pos=None: t  # noqa: E731
    ref = _jit(JA.decode_attend, cfg=jcfg, window=window, cap=cap,
               rope_fn=rope)
    start = C + 3 if window else C - 6
    for i in range(6):
        x = _np(10 + i, (B, 1, jcfg.d_model))
        jo, jc = ref(jp, jnp.asarray(x), jc, jnp.int32(start + i))
        ptr = pc.k.data_ptr()
        po, pc = PA.decode_attend(pp, _t(x), pc, start + i, cfg=pcfg,
                                  window=window, cap=cap, rope_fn=rope)
        assert pc.k.data_ptr() == ptr         # written in place
        _close(po, jo)
        _trees_close(pc, jc)


@pytest.mark.parametrize("S,window,chunk,cap", [(256, 64, 32, None),
                                                (512, 128, 64, 30.0),
                                                (256, 32, 32, 30.0)])
def test_banded_attention_matches_reference(S, window, chunk, cap):
    """``attention(..., banded=True)``: q blocks visit only the KV blocks
    inside the window, against the reference's banded path and against
    the port's own chunked path."""
    B, H, K, hd = 1, 4, 2, 16
    q, k, v = (_np(20 + i, (B, S, n, hd)) for i, n in enumerate((H, K, K)))
    pos = np.arange(S, dtype=np.int32)
    valid = np.ones(S, bool)
    kw = dict(causal=True, window=window, cap=cap, chunk=chunk)
    ref = JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       qpos=jnp.asarray(pos), kpos=jnp.asarray(pos),
                       kvalid=jnp.asarray(valid), banded=True, **kw)
    args = (_t(q), _t(k), _t(v))
    pkw = dict(qpos=_t(pos), kpos=_t(pos), kvalid=_t(valid), **kw)
    _close(PA.attention(*args, banded=True, **pkw), ref)
    _close(PA.attention(*args, banded=False, **pkw), ref)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k,E,cf", [(2, 4, 1.25), (2, 4, 4.0),
                                        (4, 16, 1.25), (4, 16, 4.0),
                                        (1, 8, 0.5)])
def test_moe_apply_matches_reference(cf, top_k, E):
    """Output and both aux losses; at capacity factor 1.25 (and 0.5) the
    capacity drops some assignments, and the stable sort must drop the
    same ones as the reference's."""
    jcfg, pcfg = _cfgs("phi3.5-moe-42b-a6.6b", capacity_factor=cf,
                       top_k=top_k, n_experts=E)
    jp, pp = _block(JMOE.moe_defs(jcfg), 5)
    # tokens that share a direction, and a router that sees it, make some
    # experts popular, so capacity binds
    jp["router"] = jp["router"] * 40
    pp["router"] = pp["router"] * 40
    x = _np(6, (2, 48, jcfg.d_model)) + 2 * _np(7, (jcfg.d_model,))
    jo, ja = _jit(JMOE.moe_apply, cfg=jcfg)(jp, jnp.asarray(x))
    po, pa = PMOE.moe_apply(pp, _t(x), pcfg)
    _close(po, jo)
    assert sorted(pa) == sorted(ja)
    for name in ja:
        _close(pa[name], ja[name])
    drops = int(PMOE.capacity_drops(pp, _t(x), pcfg))
    assert (drops > 0) == (cf < 4.0)
    # the reference's own count of assignments past capacity
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, jp["router"]), -1)
    _, top_e = jax.lax.top_k(probs, top_k)
    C = PMOE.moe_capacity(pcfg, 48)
    counts = np.stack([np.bincount(np.asarray(r).reshape(-1), minlength=E)
                       for r in top_e])
    assert drops == int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("top_k,cf", [(1, 4.0), (2, 4.0), (2, 1.25)])
def test_moe_apply_with_tied_router_matches_reference(top_k, cf):
    """Exactly tied router probabilities (each odd router column a copy of
    the even one before it): ``lax.top_k`` takes the lower expert first,
    so the port must too; the choice decides the expert a token goes to,
    its rank in the capacity sort and the load-balance loss."""
    jcfg, pcfg = _cfgs("phi3.5-moe-42b-a6.6b", capacity_factor=cf,
                       top_k=top_k, n_experts=8)
    jp, pp = _block(JMOE.moe_defs(jcfg), 9)
    router = np.repeat(np.asarray(jp["router"])[:, ::2], 2, axis=1) * 40
    jp["router"], pp["router"] = jnp.asarray(router), _t(router)
    x = _np(10, (2, 48, jcfg.d_model)) + 2 * _np(11, (jcfg.d_model,))
    logits = torch.matmul(_t(x), pp["router"])
    assert torch.equal(logits[..., 0::2], logits[..., 1::2])  # exact ties
    jo, ja = _jit(JMOE.moe_apply, cfg=jcfg)(jp, jnp.asarray(x))
    po, pa = PMOE.moe_apply(pp, _t(x), pcfg)
    _close(po, jo)
    for name in ja:
        _close(pa[name], ja[name])


def test_moe_under_vmap_equals_a_loop():
    """The dispatch batches under ``torch.func.vmap`` (the coded step vmaps
    the workers): a vmapped call equals a loop of single calls."""
    _, pcfg = _cfgs("phi3.5-moe-42b-a6.6b", capacity_factor=1.0)
    _, pp = _block(JMOE.moe_defs(_cfgs("phi3.5-moe-42b-a6.6b")[0]), 7)
    xs = _t(_np(8, (3, 2, 16, pcfg.d_model)))
    out, aux = torch.func.vmap(lambda x: PMOE.moe_apply(pp, x, pcfg))(xs)
    for w in range(3):
        o, a = PMOE.moe_apply(pp, xs[w], pcfg)
        torch.testing.assert_close(out[w], o, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(aux["router_z"][w], a["router_z"])


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 48, 21])
def test_mamba_apply_and_decode_match_reference(S):
    """The chunked scan (chunk 16: one chunk, three, and a ragged tail (21 = 16 + 5) with
    no cache), then four decode steps from the reference's cache."""
    jcfg, pcfg = _cfgs("jamba-1.5-large-398b")
    jp, pp = _block(JMB.mamba_defs(jcfg), 9)
    x = _np(10, (2, S, jcfg.d_model), 0.5)
    if S % jcfg.mamba_chunk:
        _close(PMB.mamba_apply(pp, _t(x), pcfg),
               _jit(JMB.mamba_apply, cfg=jcfg)(jp, jnp.asarray(x)),
               SCAN_RTOL)
        with pytest.raises(ValueError, match="multiple of the mamba chunk"):
            PMB.mamba_apply(pp, _t(x), pcfg, return_cache=True)
        return
    jo, jc = _jit(JMB.mamba_apply, cfg=jcfg, return_cache=True)(
        jp, jnp.asarray(x))
    po, pc = PMB.mamba_apply(pp, _t(x), pcfg, return_cache=True)
    _close(po, jo, SCAN_RTOL)
    _trees_close(pc, jc, SCAN_RTOL)
    pc = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    ref = _jit(JMB.mamba_decode, cfg=jcfg)
    for i in range(4):
        xt = _np(30 + i, (2, 1, jcfg.d_model), 0.5)
        jo, jc = ref(jp, jnp.asarray(xt), jc)
        po, pc = PMB.mamba_decode(pp, _t(xt), pc, pcfg)
        _close(po, jo)
        _trees_close(pc, jc)


def test_mamba_cache_init_matches_reference():
    jcfg, pcfg = _cfgs("jamba-1.5-large-398b")
    j = JMB.init_mamba_cache(jcfg, 3, jnp.float32)
    p = PMB.init_mamba_cache(pcfg, 3, torch.float32, device="cpu")
    _trees_close(p, j)
    assert p.ssm.dtype == torch.float32


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 32, 20])
def test_mlstm_apply_and_decode_match_reference(S):
    jcfg, pcfg = _cfgs("xlstm-350m")
    jp, pp = _block(JX.mlstm_defs(jcfg), 11)
    x = _np(12, (2, S, jcfg.d_model))
    if S % jcfg.mamba_chunk:
        _close(PX.mlstm_apply(pp, _t(x), pcfg),
               _jit(JX.mlstm_apply, cfg=jcfg)(jp, jnp.asarray(x)), SCAN_RTOL)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            PX.mlstm_apply(pp, _t(x), pcfg, return_cache=True)
        return
    jo, jc = _jit(JX.mlstm_apply, cfg=jcfg, return_cache=True)(
        jp, jnp.asarray(x))
    po, pc = PX.mlstm_apply(pp, _t(x), pcfg, return_cache=True)
    _close(po, jo, SCAN_RTOL)
    _trees_close(pc, jc, SCAN_RTOL)
    pc = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    ref = _jit(JX.mlstm_decode, cfg=jcfg)
    for i in range(4):
        xt = _np(40 + i, (2, 1, jcfg.d_model))
        jo, jc = ref(jp, jnp.asarray(xt), jc)
        po, pc = PX.mlstm_decode(pp, _t(xt), pc, pcfg)
        _close(po, jo)
        _trees_close(pc, jc)


@pytest.mark.parametrize("S", [1, 9, 32])
def test_slstm_apply_and_decode_match_reference(S):
    jcfg, pcfg = _cfgs("xlstm-350m")
    jp, pp = _block(JX.slstm_defs(jcfg), 13)
    x = _np(14, (2, S, jcfg.d_model))
    jo, jc = _jit(JX.slstm_apply, cfg=jcfg, return_cache=True)(
        jp, jnp.asarray(x))
    po, pc = PX.slstm_apply(pp, _t(x), pcfg, return_cache=True)
    _close(po, jo)
    _trees_close(pc, jc)
    ref = _jit(JX.slstm_decode, cfg=jcfg)
    for i in range(4):
        xt = _np(50 + i, (2, 1, jcfg.d_model))
        jo, jc = ref(jp, jnp.asarray(xt), jc)
        po, pc = PX.slstm_decode(pp, _t(xt), pc, pcfg)
        _close(po, jo)
        _trees_close(pc, jc)


def test_xlstm_cache_inits_match_reference():
    jcfg, pcfg = _cfgs("xlstm-350m")
    for jf, pf in ((JX.init_mlstm_cache, PX.init_mlstm_cache),
                   (JX.init_slstm_cache, PX.init_slstm_cache)):
        j, p = jf(jcfg, 2, jnp.float32), pf(pcfg, 2, torch.float32,
                                            device="cpu")
        assert p._fields == j._fields
        _trees_close(p, j)


# ---------------------------------------------------------------------------
# the cache converter
# ---------------------------------------------------------------------------

def test_cache_converter_round_trip_and_refusal():
    k = _np(60, (2, 3, 4, 8))
    tree = ((JA.AttnCache(k, k + 1), JA.AttnCache(k[:, :1], k[:, :1])),
            JMB.MambaCache(k[..., 0], k[0]))
    port = caches_from_numpy(tree, "cpu")
    assert isinstance(port[0][0], PA.AttnCache)
    assert isinstance(port[1], PMB.MambaCache)
    back = caches_to_numpy(port)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bf = caches_from_numpy(JA.AttnCache(
        np.asarray(jnp.asarray(k, jnp.bfloat16)), k), "cpu")
    assert bf.k.dtype == torch.bfloat16 and bf.v.dtype == torch.float32
    from collections import namedtuple
    with pytest.raises(TypeError, match="not a serve cache"):
        caches_from_numpy(namedtuple("Other", "a b")(k, k), "cpu")
