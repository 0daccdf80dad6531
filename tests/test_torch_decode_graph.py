"""Serving as device programs, on the CPU: the decode step with its
position in a device buffer and captured as one CUDA graph
(``repro_torch.models.Decoder``), and the attention's KV chunk loop
through ``repro_torch.graphs.scan``.

  * ``decode_step`` with a 0-d int32 ``index`` equals the Python-int call
    bit for bit, and matches the reference's ``jax.jit(decode_step)``
    called with ``jnp.int32(S + i)`` step by step, at every architecture's
    smoke variant (``test_torch_serve``'s parameters, inputs and
    tolerances: rel 1e-5 of the largest magnitude, 1e-4 for the caches of
    the Mamba and mLSTM architectures);
  * the decoder on a stand-in card: CPU tensors taken for a card's, and a
    capture that records the step and reruns it at each replay with a
    stand-in capture in force (so a scan inside it runs eagerly, as it
    does inside a real capture).  At gemma2's smoke variant with the
    local window cut to 16 and a cache of 128 (two KV chunks of 64: the
    decode takes the chunked path and wraps the local ring), the greedy
    tokens, the last logits and the caches equal the eager ``decode_step``
    loop bit for bit; one capture serves every token, and ``load`` of a
    second prefill reuses it.  Parameters that require grad,
    ``torch.func``, flop counting on the meta device and
    ``capturing(False)`` never capture; a failing capture raises, naming
    the architecture, the batch and the cache length; ``graphs.clear()``
    drops the graph;
  * the KV chunk loop as ``graphs.scan`` blocks equals a kept copy of the
    Python loop bit for bit (causal and not, windowed, soft-capped,
    invalid keys, one query) and the reference's ``attention`` to rel
    1e-5; on a stand-in card a local and a global layer of equal shapes
    take a capture each (the graph cache's key holds the block's window,
    cap and causality), and a scan reached inside an outer capture runs
    eagerly.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.models.attention as JA
import repro_torch.models.attention as PA
import repro_torch.models.transformer as PT
from repro_torch import graphs
from repro_torch.configs import ARCHS as P_ARCHS
from repro_torch.models import (Decoder, caches_from_numpy, init_params,
                                prefill)
from repro_torch.tree import tree_leaves, tree_map
from test_torch_serve import (ARCHS, NEW, RTOL, S, _cache_rtol, _close,
                              _inputs, _ref_decode, _ref_prefill, _setup)


@pytest.fixture(autouse=True)
def one_thread():
    """Many small operations: one intra-op thread keeps them fast where
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b):
    a, b = tree_leaves(a), tree_leaves(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y), float((x.float() - y.float()).abs().max())


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# -- decode_step with its position on the device ------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_index_equals_int_index(arch):
    """Four decode steps from the port's own prefill, the position a 0-d
    int32 tensor against a Python int: logits and every cache leaf bit for
    bit."""
    _, pcfg, _, pp, toks, kw = _setup(arch)
    _, pkw = _inputs(kw, S)
    _, caches = prefill(pp, pcfg, torch.from_numpy(toks[:, :S]),
                        cache_len=S + 8, **pkw)
    by_int, by_tensor = caches, _clone(caches)
    for i in range(NEW):
        tok = torch.from_numpy(toks[:, S + i:S + i + 1])
        li, _ = PT.decode_step(pp, pcfg, tok, by_int, S + i)
        lt, out = PT.decode_step(pp, pcfg, tok, by_tensor,
                                 torch.tensor(S + i, dtype=torch.int32))
        assert out is by_tensor
        _equal(lt, li)
        _equal(by_tensor, by_int)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_index_matches_reference(arch):
    """The port's ``decode_step`` with a 0-d int32 position, fed the
    reference's prefill caches and teacher-forced with its tokens, against
    ``jax.jit(decode_step)`` called with ``jnp.int32(S + i)``: logits and
    caches step by step."""
    jcfg, pcfg, jp, pp, toks, kw = _setup(arch)
    jkw, _ = _inputs(kw, S)
    _, jc = _ref_prefill(jp, jcfg, jnp.asarray(toks[:, :S]), jkw)
    pc = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for i in range(NEW):
        tok = toks[:, S + i:S + i + 1]
        jl, jc = _ref_decode(jp, jcfg, jnp.asarray(tok), jc,
                             jnp.int32(S + i))
        pl, pc = PT.decode_step(pp, pcfg, torch.from_numpy(tok), pc,
                                torch.tensor(S + i, dtype=torch.int32))
        _close(pl, jl)
        for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(jc)):
            _close(a, b, _cache_rtol(arch))


@pytest.mark.parametrize("cache_len", [1, 5, 64])
@pytest.mark.parametrize("index", [0, 3, 64, 200])
def test_ring_slot_positions_from_a_device_index(cache_len, index):
    want = PA.ring_slot_positions(cache_len, index, device="cpu")
    for t in (torch.tensor(index, dtype=torch.int32),
              torch.tensor([index], dtype=torch.int32)):
        _equal(PA.ring_slot_positions(cache_len, t), want)


# -- the decoder on a stand-in card -------------------------------------------

# gemma2's smoke variant with its local window cut to 16: a prompt of 64
# leaves the ring's last 16 keys, and the global layer's cache of 128 is
# two KV chunks of 64, so decoding takes the chunked path
DEC_S, DEC_LEN, DEC_NEW = 64, 128, 40


def _gemma_case(seed=0):
    cfg = P_ARCHS["gemma2-27b"].smoke_variant()
    cfg = cfg.with_overrides(period=tuple(
        dataclasses.replace(b, window=16) if b.window else b
        for b in cfg.period))
    assert cfg.attn_chunk == 64 and DEC_LEN % cfg.attn_chunk == 0
    params = init_params(cfg, 0, device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, DEC_S)), dtype=torch.int32)
    return cfg, params, prompts


def _prefill(cfg, params, prompts):
    with torch.no_grad():
        lg, caches = prefill(params, cfg, prompts, cache_len=DEC_LEN)
    return torch.argmax(lg[:, -1], dim=-1)[:, None], caches


def _eager(cfg, params, prompts, n=DEC_NEW):
    """The eager greedy loop (``decode_step``, Python-int positions) ->
    (tokens (2, n), last logits, caches)."""
    tok, caches = _prefill(cfg, params, prompts)
    out = []
    with torch.no_grad(), graphs.capturing(False):
        for i in range(n):
            lg, caches = PT.decode_step(params, cfg, tok, caches, DEC_S + i)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            out.append(tok)
    return torch.cat(out, dim=1).int(), lg, caches


class _StandIn:
    """What the stand-in card captured and replayed, and whether a
    stand-in capture is in force."""

    def __init__(self):
        self.wheres, self.spans, self.replays = [], [], 0
        self.capturing = False


class _Rerun:
    """Stands in for a captured step: a replay reruns it on the buffers
    its capture closed over, with the stand-in capture in force, as a real
    replay repeats what was recorded inside the capture."""

    def __init__(self, body, card):
        self.body, self.card = body, card
        self.pool_bytes = 0

    def replay(self):
        self.card.replays += 1
        self.card.capturing = True
        try:
            self.body()
        finally:
            self.card.capturing = False


@pytest.fixture
def stand_in_card(monkeypatch):
    card = _StandIn()

    def capture(body, where, device, span="runner:capture"):
        card.wheres.append(where)
        card.spans.append(span)
        return _Rerun(body, card)

    graphs.clear()
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_stream_capturing", lambda: card.capturing)
    yield card
    graphs.clear()


def test_decoder_equals_the_eager_loop_with_one_capture(stand_in_card):
    """Greedy tokens, the last logits and every cache leaf bit for bit
    against the eager loop, through the ring's wrap and the chunked KV
    path; the first step is the warm-up, the second captures, and every
    step from the second is one replay.  ``load`` of a second prefill
    reuses the capture."""
    cfg, params, prompts = _gemma_case()
    _, params2, prompts2 = _gemma_case(seed=1)
    want = _eager(cfg, params, prompts)
    want2 = _eager(cfg, params, prompts2)
    assert not torch.equal(want[0], want2[0])
    graphs.clear()

    dec = Decoder(params, cfg, 2, DEC_LEN)
    for prm, (toks, lg, caches) in ((prompts, want), (prompts2, want2)):
        tok, pc = _prefill(cfg, params, prm)
        dec.load(pc, DEC_S)
        _equal(dec.generate(DEC_NEW, token=tok), toks)
        _equal(dec.logits, lg)
        _equal(dec.caches, caches)
        assert int(dec.index) == DEC_S + DEC_NEW
    assert stand_in_card.wheres == [
        f"decode {cfg.name}, batch 2, cache length {DEC_LEN}"]
    assert stand_in_card.spans == ["decode:capture"]
    assert dec.captures == 1
    assert stand_in_card.replays == 2 * DEC_NEW - 1
    assert graphs._CACHE == {}      # the KV loop ran inline, never its own


def test_decoder_teacher_forced_steps(stand_in_card):
    """``step(token)`` feeds the given token: the logits of each step equal
    ``decode_step``'s on the same tokens, bit for bit."""
    cfg, params, prompts = _gemma_case()
    forced = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 6)), dtype=torch.int32)
    _, caches = _prefill(cfg, params, prompts)
    dec = Decoder(params, cfg, 2, DEC_LEN)
    dec.load(caches, DEC_S)
    for i in range(6):
        with torch.no_grad(), graphs.capturing(False):
            want, caches = PT.decode_step(params, cfg, forced[:, i:i + 1],
                                          caches, DEC_S + i)
        _equal(dec.step(forced[:, i:i + 1]), want)
    assert dec.captures == 1 and stand_in_card.replays == 5
    _equal(dec.caches, caches)


def test_decoder_binds_its_parameters():
    """The decoder reads the tensors it was built with: replacing a leaf
    in the caller's tree afterwards changes nothing."""
    cfg, params, prompts = _gemma_case()
    toks, lg, _ = _eager(cfg, params, prompts, n=4)
    tok, caches = _prefill(cfg, params, prompts)
    dec = Decoder(params, cfg, 2, DEC_LEN)
    params["embed"] = torch.zeros_like(params["embed"])
    dec.load(caches, DEC_S)
    _equal(dec.generate(4, token=tok), toks)
    _equal(dec.logits, lg)


def test_decoder_load_refuses_other_layouts():
    cfg, params, prompts = _gemma_case()
    _, caches = _prefill(cfg, params, prompts)
    dec = Decoder(params, cfg, 2, DEC_LEN + 64)
    with pytest.raises(ValueError, match=f"decode {cfg.name}, batch 2, "
                                         f"cache length {DEC_LEN + 64}"):
        dec.load(caches, DEC_S)


def _refusing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("captured")
    graphs.clear()
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(graphs, "_capture", refuse)


@pytest.mark.parametrize("case", ["requires_grad", "func", "meta_flops",
                                  "capturing_off"])
def test_decoder_never_captures_here(monkeypatch, case):
    """Parameters that require grad, a ``torch.func`` transform
    (``vmap``: a grad transform refuses the in-place writes), flop
    counting on the meta device and ``capturing(False)`` step eagerly,
    with the KV loop inline, even where the tensors pass for a card's, and
    equal the eager loop."""
    cfg, params, prompts = _gemma_case()
    toks, lg, _ = _eager(cfg, params, prompts, n=3)
    tok, caches = _prefill(cfg, params, prompts)
    _refusing(monkeypatch)
    if case == "meta_flops":
        meta = tree_map(lambda t: t.to("meta"), params)
        dec = Decoder(meta, cfg, 2, DEC_LEN)
        with FlopCounterMode(display=False) as fc:
            dec.generate(3, token=tok.to("meta"))
        assert fc.get_total_flops() > 0 and dec.captures == 0
        return
    if case == "requires_grad":
        params = tree_map(lambda t: t.clone().requires_grad_(), params)
    dec = Decoder(params, cfg, 2, DEC_LEN)
    dec.load(caches, DEC_S)
    dec.token.copy_(tok)
    if case == "func":
        def f(x):
            for _ in range(3):
                dec.step()
            return x * dec.logits[0, 0, 0]
        torch.func.vmap(f)(torch.ones(2))
    else:
        with (graphs.capturing(False) if case == "capturing_off"
              else contextlib.nullcontext()):
            dec.generate(3)
    assert dec.captures == 0
    _equal(dec.logits, lg)
    _equal(dec.token, toks[:, -1:])


class _FailingGraph:
    def capture_begin(self, **kw):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    def capture_end(self):
        pass


def test_a_failed_decode_capture_raises_naming_the_step(monkeypatch):
    """No eager fallback: the second step (the capture) raises with the
    architecture, the batch and the cache length."""
    cfg, params, prompts = _gemma_case()
    tok, caches = _prefill(cfg, params, prompts)
    graphs.clear()
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FailingGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: device)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    dec = Decoder(params, cfg, 2, DEC_LEN)
    dec.load(caches, DEC_S)
    dec.step(tok)
    with pytest.raises(RuntimeError, match=f"decode {cfg.name}, batch 2, "
                       f"cache length {DEC_LEN}: capturing .*not permitted"):
        dec.step()
    graphs.clear()


def test_clear_drops_the_decoder_graph(stand_in_card):
    cfg, params, prompts = _gemma_case()
    toks, _, _ = _eager(cfg, params, prompts, n=6)
    tok, caches = _prefill(cfg, params, prompts)
    dec = Decoder(params, cfg, 2, DEC_LEN)
    dec.load(caches, DEC_S)
    first = dec.generate(3, token=tok)
    assert dec.captures == 1 and dec._graph is not None
    graphs.clear()
    assert dec._graph is None
    second = dec.generate(3)            # captures anew, no second warm-up
    assert dec.captures == 2 and len(stand_in_card.wheres) == 2
    _equal(torch.cat([first, second], dim=1), toks)


# -- the KV chunk loop ---------------------------------------------------------

def _old_attention(q, k, v, *, causal, window, cap, qpos, kpos, kvalid,
                   chunk):
    """The chunked path as it ran before: a Python loop over the chunks."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qh = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)
    m_run = torch.full((B, K, G, Sq), PA._NEG, dtype=torch.float32)
    l_run = torch.zeros((B, K, G, Sq), dtype=torch.float32)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32)
    for lo in range(0, Skv, chunk):
        kb, vb = k[:, lo:lo + chunk], v[:, lo:lo + chunk]
        s = PA._scores(qh, kb, scale, cap)
        msk = PA._mask(qpos, kpos[lo:lo + chunk], kvalid[lo:lo + chunk],
                       causal, window)
        s = torch.where(msk[None, None, None], s, PA._NEG)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        r = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None]) * msk[None, None, None]
        l_run = l_run * r + p.sum(dim=-1)
        acc = acc * r[..., None] + torch.einsum("bkgsc,bckh->bkgsh", p,
                                                vb.float())
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


CHUNK = 16

# (causal, window, cap, Sq, Skv, invalid keys)
KV_CASES = {
    "causal": (True, None, None, 64, 64, False),
    "not_causal": (False, None, None, 24, 64, False),
    "windowed": (True, 20, None, 64, 64, False),
    "soft_capped": (True, None, 30.0, 64, 64, False),
    "invalid_keys": (False, None, 50.0, 24, 80, True),
    "one_query": (True, 32, 50.0, 1, 48, True),
}


def _kv_case(name, seed=0):
    causal, window, cap, Sq, Skv, invalid = KV_CASES[name]
    rng = np.random.default_rng(seed)
    B, H, K, hd = 2, 4, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    kpos = torch.arange(Skv, dtype=torch.int32)
    qpos = (torch.full((1,), Skv - 5, dtype=torch.int32) if Sq == 1
            else torch.arange(Skv - Sq, Skv, dtype=torch.int32))
    kvalid = torch.ones(Skv, dtype=torch.bool)
    if invalid:
        kvalid[CHUNK:2 * CHUNK] = False        # a whole chunk
        kvalid[2 * CHUNK + 3::5] = False
    return q, k, v, dict(causal=causal, window=window, cap=cap, qpos=qpos,
                         kpos=kpos, kvalid=kvalid, chunk=CHUNK)


@pytest.mark.parametrize("name", sorted(KV_CASES))
def test_kv_blocks_equal_the_python_loop(name):
    q, k, v, kw = _kv_case(name)
    assert k.shape[1] > CHUNK and k.shape[1] % CHUNK == 0
    _equal(PA.attention(q, k, v, **kw), _old_attention(q, k, v, **kw))


@pytest.mark.parametrize("name", sorted(KV_CASES))
def test_kv_blocks_match_reference(name):
    q, k, v, kw = _kv_case(name)
    jkw = {n: (jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor)
               else x) for n, x in kw.items()}
    ref = JA.attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), **jkw)
    _close(PA.attention(q, k, v, **kw), ref, RTOL)


def test_a_local_and_a_global_layer_take_a_capture_each(stand_in_card):
    """Equal shapes, other masks: two graphs, each layer's output its own
    eager output bit for bit; a second call of each is replays only."""
    q, k, v, kw = _kv_case("causal")
    with graphs.capturing(False):
        want = {w: PA.attention(q, k, v, **dict(kw, window=w))
                for w in (None, 20)}
    assert not torch.equal(want[None], want[20])
    for _ in range(2):
        for w in (None, 20):
            _equal(PA.attention(q, k, v, **dict(kw, window=w)), want[w])
    keys = graphs.cached()
    assert len(keys) == 2 and len(stand_in_card.wheres) == 2
    assert sorted(key[-1][1] or 0 for key in keys) == [0, 20]
    assert all(w.startswith("attention, block 1 ")
               for w in stand_in_card.wheres)


def test_scan_inside_an_outer_capture_runs_eagerly(monkeypatch):
    q, k, v, kw = _kv_case("windowed")
    want = PA.attention(q, k, v, **kw)
    _refusing(monkeypatch)
    monkeypatch.setattr(graphs, "_stream_capturing", lambda: True)
    _equal(PA.attention(q, k, v, **kw), want)
    assert graphs._CACHE == {}
