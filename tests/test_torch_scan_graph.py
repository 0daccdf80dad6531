"""The model zoo's recurrences as blocks over static buffers
(``repro_torch.graphs.scan``): the sLSTM token loop, the mLSTM and the
Mamba chunk loops, on the CPU.

  * against a kept copy of each loop as it ran before (a Python loop of
    one step a token or a chunk), bit for bit: the same operations on the
    same values, block by block;
  * against the reference's ``slstm_apply`` / ``mlstm_apply`` /
    ``mamba_apply`` at the smoke variants, as ``test_torch_serve_blocks``
    holds them, to rel 1e-5 of the largest magnitude (outputs and every
    cache leaf; that file allows the Mamba scan and the mLSTM chunk sums
    1e-4, which round in another order than the reference's, and these
    inputs stay within 1e-5);
  * the cache of captured block shapes on a stand-in card: CPU tensors
    taken for a card's, and a capture that records the block and reruns
    it on its static buffers at each replay, so a weight baked into the
    block instead of copied in would show.  One capture serves two layers
    with other weights and two calls, equal to the eager blocks bit for
    bit; grad, ``torch.func.grad``, flop counting on the meta device and
    ``capturing(False)`` never capture; a failing capture raises, naming
    the loop and the block; ``clear()`` releases the cache.
"""
import contextlib
import gc
import math
import weakref

import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

import repro.models.mamba as JMB
import repro.models.xlstm as JX
import repro_torch.models.mamba as PMB
import repro_torch.models.xlstm as PX
from repro_torch import graphs
from repro_torch.tree import tree_leaves, tree_map
from test_torch_serve_blocks import (RTOL, _block, _cfgs, _close, _jit, _np,
                                     _t, _trees_close)

C = PX._SLSTM_BLOCK
# the sLSTM block length in the graph-cache tests: three full blocks and a
# short one in 29 steps (the cache does not depend on the length)
SHORT = 8


@pytest.fixture(autouse=True)
def one_thread():
    """The loops are many small operations: one intra-op thread keeps them
    fast where several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short_slstm_blocks(monkeypatch):
    monkeypatch.setattr(PX, "_SLSTM_BLOCK", SHORT)


# -- the loops as they ran before: kept copies --------------------------------

def _old_slstm_apply(p, x, cfg):
    B, S, d = x.shape
    xz, xi, xf, xo = PX._slstm_inputs(p, x, cfg)
    R = PX._recurrent(p)
    state = PX.init_slstm_cache(cfg, B, x.dtype, device=x.device)
    hs = []
    for t in range(xz.shape[1]):
        state = PX._slstm_cell(p, R, xz[:, t], xi[:, t], xf[:, t], xo[:, t],
                               state)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(B, S, d)
    return PX._slstm_post(p, h, x, cfg), state


def _old_mlstm_apply(p, x, cfg, return_cache=False):
    B, S, d = x.shape
    dp, H, dk = PX._mdims(cfg)
    q, k, v, li, lf, z = PX._mlstm_qkvg(p, x, cfg)
    Q = min(cfg.mamba_chunk, S)
    Sp = ((S + Q - 1) // Q) * Q
    if Sp != S:
        if return_cache:
            raise ValueError(f"prefill length {S} must be a multiple of the "
                             f"chunk {Q} to build a cache")
        pad = Sp - S
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li, lf = (F.pad(t, (0, 0, 0, pad)) for t in (li, lf))
        z = F.pad(z, (0, 0, 0, pad))
    C_, n, m = PX.init_mlstm_cache(cfg, B, x.dtype, device=x.device)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    hs = []
    for lo in range(0, Sp, Q):
        qc, kc, vc, lic, lfc = (t[:, lo:lo + Q] for t in (q, k, v, li, lf))
        Fc = torch.cumsum(lfc, dim=1)
        wl = (Fc[:, :, None] - Fc[:, None, :] + lic[:, None, :, :])
        wl = torch.where(tri[None, :, :, None], wl, -math.inf)
        inter_l = Fc + m[:, None]
        mstar = torch.maximum(wl.amax(dim=2), inter_l)
        wts = torch.exp(wl - mstar[:, :, None])
        scores = torch.einsum("bthk,bshk->btsh", qc, kc) * wts
        num = torch.einsum("btsh,bshv->bthv", scores, vc)
        den = scores.sum(dim=2)
        w_int = torch.exp(inter_l - mstar)
        num = num + w_int[..., None] * torch.einsum("bthk,bhkv->bthv", qc, C_)
        den = den + w_int * torch.einsum("bthk,bhk->bth", qc, n)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-mstar))[..., None])
        total = Fc[:, -1]
        upd_l = total[:, None] - Fc + lic
        m_new = torch.maximum(total + m, upd_l.amax(dim=1))
        wu = torch.exp(upd_l - m_new[:, None])
        carryw = torch.exp(total + m - m_new)
        C_ = carryw[..., None, None] * C_ + torch.einsum(
            "bshk,bsh,bshv->bhkv", kc, wu, vc)
        n = carryw[..., None] * n + torch.einsum("bshk,bsh->bhk", kc, wu)
        m = m_new
    h = torch.cat(hs, dim=1).reshape(B, Sp, dp)[:, :S]
    h = PX.rmsnorm(h, p["gn"])
    h = h * F.silu(z[:, :S])
    out = torch.matmul(h.to(x.dtype), p["down"])
    if return_cache:
        return out, PX.MLSTMCache(C_, n, m)
    return out


def _old_mamba_apply(p, x, cfg, return_cache=False):
    B, S, d = x.shape
    di, ds, _, k = PMB._dims(cfg)
    xz = torch.matmul(x, p["in_proj"])
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_conv = F.silu(PMB._causal_conv(x_in, p["conv_w"], p["conv_b"]))
    Q = min(cfg.mamba_chunk, S)
    Sp = ((S + Q - 1) // Q) * Q
    if Sp != S:
        if return_cache:
            raise ValueError(f"prefill length {S} must be a multiple of the "
                             f"mamba chunk {Q} to build a cache")
        x_conv = F.pad(x_conv, (0, 0, 0, Sp - S))
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, Sp, Q):
        a, b, Cm = PMB._ssm_inputs(p, x_conv[:, lo:lo + Q])
        Ac, Bc = PMB._chunk_scan(a, b)
        hs = Ac * h[:, None] + Bc
        ys.append(torch.einsum("bqds,bqs->bqd", hs, Cm))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    x_conv = x_conv[:, :S]
    y = y + p["D"].float() * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = torch.matmul(y, p["out_proj"])
    if return_cache:
        conv_state = x_in[:, S - (k - 1):, :] if S >= k - 1 else F.pad(
            x_in, (0, 0, k - 1 - S, 0))
        return out, PMB.MambaCache(conv_state, h)
    return out


def _equal(a, b):
    a, b = tree_leaves(a), tree_leaves(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y), float((x - y).abs().max())


# -- blocks against the kept loops, bit for bit -------------------------------

@pytest.mark.parametrize("S", [1, C - 1, C, 3 * C + 5])
def test_slstm_blocks_equal_the_python_loop(S):
    jcfg, pcfg = _cfgs("xlstm-350m")
    _, pp = _block(JX.slstm_defs(jcfg), 13)
    x = _t(_np(14, (2, S, pcfg.d_model)))
    out, cache = PX.slstm_apply(pp, x, pcfg, return_cache=True)
    _equal((out, cache), _old_slstm_apply(pp, x, pcfg))
    _equal(PX.slstm_apply(pp, x, pcfg), out)


# chunk 16 at the smoke variants: one chunk, three, and ragged tails
@pytest.mark.parametrize("S", [16, 48, 21, 37])
@pytest.mark.parametrize("return_cache", [True, False])
@pytest.mark.parametrize("kind", ["mlstm", "mamba"])
def test_chunk_blocks_equal_the_python_loop(kind, S, return_cache):
    arch, defs, new, old = {
        "mlstm": ("xlstm-350m", JX.mlstm_defs, PX.mlstm_apply,
                  _old_mlstm_apply),
        "mamba": ("jamba-1.5-large-398b", JMB.mamba_defs, PMB.mamba_apply,
                  _old_mamba_apply)}[kind]
    jcfg, pcfg = _cfgs(arch)
    _, pp = _block(defs(jcfg), 11)
    x = _t(_np(12, (2, S, pcfg.d_model), 0.5))
    if return_cache and S % pcfg.mamba_chunk:
        for fn in (new, old):
            with pytest.raises(ValueError, match="multiple of the"):
                fn(pp, x, pcfg, return_cache=True)
        return
    _equal(new(pp, x, pcfg, return_cache=return_cache),
           old(pp, x, pcfg, return_cache=return_cache))


# -- blocks against the reference ---------------------------------------------

def test_slstm_blocks_match_reference():
    jcfg, pcfg = _cfgs("xlstm-350m")
    jp, pp = _block(JX.slstm_defs(jcfg), 13)
    x = _np(15, (2, 3 * C + 5, pcfg.d_model))
    jo, jc = _jit(JX.slstm_apply, cfg=jcfg, return_cache=True)(
        jp, jnp.asarray(x))
    po, pc = PX.slstm_apply(pp, _t(x), pcfg, return_cache=True)
    _close(po, jo, RTOL)
    _trees_close(pc, jc, RTOL)


@pytest.mark.parametrize("S", [64, 37])
@pytest.mark.parametrize("kind", ["mlstm", "mamba"])
def test_chunk_blocks_match_reference(kind, S):
    arch, jdefs, japply, papply = {
        "mlstm": ("xlstm-350m", JX.mlstm_defs, JX.mlstm_apply,
                  PX.mlstm_apply),
        "mamba": ("jamba-1.5-large-398b", JMB.mamba_defs, JMB.mamba_apply,
                  PMB.mamba_apply)}[kind]
    jcfg, pcfg = _cfgs(arch)
    jp, pp = _block(jdefs(jcfg), 9)
    x = _np(10, (2, S, pcfg.d_model), 0.5)
    if S % pcfg.mamba_chunk:
        _close(papply(pp, _t(x), pcfg),
               _jit(japply, cfg=jcfg)(jp, jnp.asarray(x)), RTOL)
        return
    jo, jc = _jit(japply, cfg=jcfg, return_cache=True)(jp, jnp.asarray(x))
    po, pc = papply(pp, _t(x), pcfg, return_cache=True)
    _close(po, jo, RTOL)
    _trees_close(pc, jc, RTOL)


# -- the cache of captured block shapes, on a stand-in card -------------------

# loop -> (architecture, block defs, apply, sequence length, full blocks)
LOOPS = {
    "slstm": ("xlstm-350m", JX.slstm_defs, PX.slstm_apply, 3 * SHORT + 5,
              3),
    "mlstm": ("xlstm-350m", JX.mlstm_defs, PX.mlstm_apply, 64, 4),
    "mamba": ("jamba-1.5-large-398b", JMB.mamba_defs, PMB.mamba_apply, 64,
              4),
}


def _loop_case(kind, seeds=(21,)):
    arch, defs, apply, S, _ = LOOPS[kind]
    jcfg, pcfg = _cfgs(arch)
    layers = [_block(defs(jcfg), s)[1] for s in seeds]
    x = _t(_np(22, (2, S, pcfg.d_model), 0.5))
    return pcfg, layers, x, apply


class _StandIn:
    """What the stand-in card captured: each capture's ``where`` and the
    replays of all of them."""

    def __init__(self):
        self.wheres, self.replays = [], 0


class _Rerun:
    """Stands in for a captured block: a replay runs the block again, on
    the static buffers its capture closed over."""

    def __init__(self, body, card):
        self.body, self.card = body, card

    def replay(self):
        self.card.replays += 1
        self.body()


@pytest.fixture
def stand_in_card(monkeypatch):
    """CPU tensors taken for a card's; a capture records its block."""
    card = _StandIn()

    def capture(body, where, device, span="runner:capture"):
        assert span == "scan:capture"
        card.wheres.append(where)
        return _Rerun(body, card)

    graphs.clear()
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    yield card
    graphs.clear()


@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_one_capture_serves_two_layers_and_two_calls(stand_in_card, kind,
                                                     short_slstm_blocks):
    """Two layers with other weights, each called twice: one capture of
    the block shape (at block 1 of the first call, after block 0's
    warm-up), every later full block a replay, every output and cache
    equal to the eager blocks' bit for bit."""
    pcfg, layers, x, apply = _loop_case(kind, seeds=(21, 22))
    with graphs.capturing(False):
        want = [apply(p, x, pcfg, return_cache=True) for p in layers]
    assert not torch.equal(want[0][0], want[1][0])
    assert graphs._CACHE == {}
    for _ in range(2):
        for p, w in zip(layers, want):
            _equal(apply(p, x, pcfg, return_cache=True), w)
    (where,) = stand_in_card.wheres
    assert where.startswith(f"{kind}, block 1 (positions ")
    full = LOOPS[kind][4]
    assert stand_in_card.replays == 4 * full - 1
    assert len(graphs.cached()) == 1


def _no_capture(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("captured")
    graphs.clear()
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(graphs, "_capture", refuse)


@pytest.mark.parametrize("case", ["requires_grad", "func_grad", "meta_flops",
                                  "capturing_off"])
@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_these_loops_never_capture(monkeypatch, kind, case,
                                  short_slstm_blocks):
    """Training (an input that requires grad, ``torch.func.grad``), the
    dry run's flop count on the meta device and ``capturing(False)`` run
    the blocks eagerly, even where the tensors pass for a card's; the
    gradients equal the kept loop's bit for bit."""
    pcfg, (p,), x, apply = _loop_case(kind)
    old = {"slstm": lambda p, x, c: _old_slstm_apply(p, x, c)[0],
           "mlstm": _old_mlstm_apply, "mamba": _old_mamba_apply}[kind]
    _no_capture(monkeypatch)
    if case == "requires_grad":
        xg = x.clone().requires_grad_()
        apply(p, xg, pcfg).square().sum().backward()
        xo = x.clone().requires_grad_()
        old(p, xo, pcfg).square().sum().backward()
        _equal(xg.grad, xo.grad)
    elif case == "func_grad":
        def loss(fn):
            return lambda q: fn(q, x, pcfg).square().sum()
        _equal(torch.func.grad(loss(apply))(p),
               torch.func.grad(loss(old))(p))
    elif case == "meta_flops":
        pm = tree_map(lambda t: t.to("meta"), p)
        with FlopCounterMode(display=False) as fc:
            apply(pm, x.to("meta"), pcfg)
        assert fc.get_total_flops() > 0
    else:
        with graphs.capturing(False):
            _equal(apply(p, x, pcfg), old(p, x, pcfg))
    assert graphs._CACHE == {}


class _FailingGraph:
    def capture_begin(self, **kw):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    def capture_end(self):
        pass


@pytest.mark.parametrize("kind", sorted(LOOPS))
def test_a_failed_capture_raises_naming_the_loop_and_block(
        monkeypatch, kind, short_slstm_blocks):
    """No eager fallback: the capture's failure reaches the caller with
    the loop, the block and its positions."""
    pcfg, (p,), x, apply = _loop_case(kind)
    graphs.clear()
    monkeypatch.setattr(graphs, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FailingGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: device)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    c = SHORT if kind == "slstm" else pcfg.mamba_chunk
    S = x.shape[1]
    where = rf"{kind}, block 1 \(positions {c}-{2 * c - 1} of {S}\)"
    with pytest.raises(RuntimeError, match=where + ".*not permitted"):
        apply(p, x, pcfg)
    graphs.clear()


def test_clear_releases_the_cache(stand_in_card, short_slstm_blocks):
    pcfg, (p,), x, apply = _loop_case("slstm")
    want = apply(p, x, pcfg)
    (loop,) = graphs._CACHE.values()
    assert loop.graph is not None and len(graphs.cached()) == 1
    ref = weakref.ref(loop)
    del loop
    graphs.clear()
    gc.collect()
    assert ref() is None and graphs._CACHE == {} and graphs.cached() == []
    _equal(apply(p, x, pcfg), want)         # warms up and captures anew
    assert len(stand_in_card.wheres) == 2
