"""The runners' step loops as blocks of steps (``repro_torch.runtime.runners``:
``_steps``, ``_scan_bcd``, ``_batched_bcd``, ``_blocks``), on the CPU.

On a card a block is captured once into a CUDA graph and replayed; on the
CPU the same block function runs eagerly, block by block, so these tests
run the code the card captures.  Each case:
  * equals the per-step loop the runners ran before they were split into
    blocks (kept here as ``_per_step_*``, op for op) bit for bit: a block
    does the same float32 arithmetic in the same order, the iterate
    updated in place (``W.sub_(step * g)`` rounds as ``W - step * g``);
  * and equals the reference's runner (``repro.runtime.runners``) to rel
    1e-5 of its magnitude on objectives and iterates (float32 sums in
    another order, as ``tests/test_torch_runtime.py`` holds them).
Schedules of 40 steps are four whole blocks of 10, of 45 a short last
block.  The capture's own bookkeeping (which blocks are captured, replayed
or run eagerly; the launch counts a replay adds; a failed capture raising;
its seconds and obs span) runs with stand-ins for ``torch.cuda``'s graph
and stream, so it needs no card.
"""
import contextlib
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime as jrt
import repro_torch.core as tcore
from repro_torch.core.data_parallel import prox_l1
from repro_torch.kernels import _build
from repro_torch.kernels.fused_step import fused_enabled
from repro_torch.obs import CompileWatch
from repro_torch.obs.trace import TraceRecorder
from repro_torch.runtime import runners

M, K, P, N = 8, 6, 24, 96
RTOL = 1e-5


def _rel_close(out, ref, rtol=RTOL):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


@pytest.fixture(scope="module")
def probs():
    spec = jrt.ProblemSpec.synthetic(N, P, noise=0.5, lam=0.05, seed=0)
    jp = jcore.make_encoded_problem(spec.X, spec.y,
                                    jcore.hadamard_encoder(N, 2.0), M,
                                    lam=spec.lam)
    tp = tcore.EncodedProblem.from_numpy(
        np.asarray(jp.SX), np.asarray(jp.Sy), np.asarray(jp.X),
        np.asarray(jp.y), lam=jp.lam, beta=jp.beta, n=jp.n, device="cpu")
    return jp, tp


def _masks(R, T, seed, sub_k=False):
    """(R, T, M) fastest-K masks; with ``sub_k`` every third step keeps
    fewer than K workers (the hold-mode carry's rounds)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((R, T, M), np.float32)
    for q in range(R):
        for t in range(T):
            out[q, t, rng.permutation(M)[:K - 2 if sub_k and t % 3 == 0
                                         else K]] = 1.0
    return out


# -- the per-step loops the runners ran before blocks -------------------------

def _per_step(prob, masks, step_size, w0, *, kind, h, eval_every, degrade):
    dev = prob.device
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    W = torch.as_tensor(w0, dtype=torch.float32, device=dev)
    R, T, _ = masks.shape
    step = runners._step_vector(step_size, R, dev)[:, None]
    masks_t = masks.transpose(0, 1).contiguous()
    trace = torch.empty((R, T // eval_every), dtype=torch.float32,
                        device=dev)
    h_obj = "l1" if kind == "prox" else h
    thresh = step * prob.lam
    g_prev = torch.zeros_like(W) if degrade is not None else None
    fused = fused_enabled()
    for t in range(T):
        mask = masks_t[t]
        g = runners._masked_grad(prob, W, mask, fused)
        if kind == "gd" and h == "l2":
            g = g + prob.lam * W
        if degrade is not None:
            _, k_min, shrink = degrade
            subk = mask.sum(-1, keepdim=True) < k_min
            g = torch.where(subk, shrink * g_prev, g)
            g_prev = g
        if kind == "gd":
            W = W - step * g
        else:
            W = prox_l1(W - step * g, thresh)
        if (t + 1) % eval_every == 0:
            trace[:, (t + 1) // eval_every - 1] = runners._objectives(
                prob, W, h_obj)
    return W, trace


def _per_step_bcd(prob, masks, step_size, v0):
    masks = torch.as_tensor(masks, dtype=torch.float32)
    v = torch.as_tensor(v0, dtype=torch.float32)
    T = masks.shape[0]
    trace = torch.empty(T + 1, dtype=torch.float32)
    for t in range(T):
        v, z = runners._bcd_step(prob.XS, v, masks[t], step_size,
                                 prob.phi_grad)
        trace[t] = prob.phi_val(z)
    trace[T] = prob.phi_val(runners._activations(prob.XS, v))
    return v, trace


def _per_step_batched_bcd(prob, masks, step_size, v0, eval_every):
    masks = torch.as_tensor(masks, dtype=torch.float32)
    V = torch.as_tensor(v0, dtype=torch.float32).clone()
    R, T, _ = masks.shape
    trace = torch.empty((R, T // eval_every), dtype=torch.float32)
    for t in range(T):
        for q in range(R):
            V[q] = runners._bcd_step(prob.XS, V[q], masks[q, t], step_size,
                                     prob.phi_grad)[0]
        if (t + 1) % eval_every == 0:
            for q in range(R):
                trace[q, (t + 1) // eval_every - 1] = prob.phi_val(
                    runners._activations(prob.XS, V[q]))
    return V, trace


def _reference(jp, kind, masks, step, R, eval_every, degrade=None):
    """The reference's batched runner on the same problem and masks."""
    fn = jrt.batched_scan_gd if kind == "gd" else jrt.batched_scan_prox
    return fn(jp, jnp.asarray(masks), step, jnp.zeros((R, P)),
              eval_every=eval_every, degrade=degrade)


def _check(tp, jp, kind, R, T, eval_every, degrade=None, seed=0):
    """The block run against the per-step loop (bit for bit) and the
    reference (rel 1e-5)."""
    masks = _masks(R, T, seed, sub_k=degrade is not None)
    kw = dict(kind=kind, h="l1" if kind == "prox" else "l2",
              eval_every=eval_every, degrade=degrade)
    w0 = torch.zeros((R, P))
    w, tr = runners._run(tp, masks, 0.05, w0, **kw)
    assert not w0.any()                      # the caller's start is kept
    wl, trl = _per_step(tp, masks, 0.05, w0, **kw)
    assert torch.equal(w, wl) and torch.equal(tr, trl)
    jw, jtr = _reference(jp, kind, masks, 0.05, R, eval_every, degrade)
    assert tr.shape == (R, T // eval_every)
    for q in range(R):
        _rel_close(tr[q], jtr[q])
        _rel_close(w[q], jw[q])


@pytest.mark.parametrize("T", [40, 45])
@pytest.mark.parametrize("eval_every", [1, 5])
@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("kind", ["gd", "prox"])
def test_blocks_equal_per_step_and_reference(probs, kind, R, eval_every, T):
    jp, tp = probs
    assert runners._block_steps(eval_every) == 10
    _check(tp, jp, kind, R, T, eval_every)


@pytest.mark.parametrize("kind", ["gd", "prox"])
def test_blocks_with_hold_degrade(probs, kind):
    jp, tp = probs
    _check(tp, jp, kind, 3, 45, 1, degrade=("hold", K, 0.5), seed=1)


@pytest.mark.parametrize("kind", ["gd", "prox"])
def test_blocks_under_repro_fused_0(probs, kind, monkeypatch):
    """The combine branch (``REPRO_FUSED=0``): one ``masked_gradient`` a
    realization inside each block."""
    monkeypatch.setenv("REPRO_FUSED", "0")
    assert not fused_enabled()
    jp, tp = probs
    _check(tp, jp, kind, 2, 45, 5, seed=2)


def test_public_runners_take_the_blocks(probs):
    """``scan_gd`` / ``scan_prox`` and ``batched_scan_*`` run ``_run``'s
    blocks: a single run is the batched loop at R = 1."""
    _, tp = probs
    masks = _masks(2, 45, 3)
    for single, batched, kind in ((runners.scan_gd, runners.batched_scan_gd,
                                   "gd"),
                                  (runners.scan_prox,
                                   runners.batched_scan_prox, "prox")):
        w, tr = single(tp, masks[0], 0.05, torch.zeros(P), eval_every=5)
        wb, tb = batched(tp, masks, 0.05, torch.zeros((2, P)), eval_every=5)
        wl, trl = _per_step(tp, masks, 0.05, torch.zeros((2, P)), kind=kind,
                            h="l1" if kind == "prox" else "l2", eval_every=5,
                            degrade=None)
        assert torch.equal(w, wl[0]) and torch.equal(tr, trl[0])
        assert torch.equal(wb, wl) and torch.equal(tb, trl)


# -- BCD ----------------------------------------------------------------------

def _lifted(seed=1, n=128, p=32):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    y = X @ rng.standard_normal(p)
    jl = jcore.make_lifted_problem(X, jcore.hadamard_encoder(p, 2.0), M,
                                   *jcore.phi_quadratic(y))
    tl = tcore.LiftedProblem.from_numpy(
        np.asarray(jl.XS), *tcore.phi_quadratic(y, device="cpu"),
        beta=jl.beta, device="cpu")
    step = 0.9 / (np.linalg.eigvalsh(X.T @ X / n).max() * 2.0)
    return jl, tl, step


@pytest.mark.parametrize("T", [40, 45])
def test_bcd_blocks_equal_per_step_and_reference(T):
    jl, tl, step = _lifted()
    masks = _masks(1, T, 4)[0]
    v0 = torch.zeros((M, tl.XS.shape[-1]))
    v, tr = runners.scan_bcd(tl, masks, step, v0)
    assert not v0.any()
    vl, trl = _per_step_bcd(tl, masks, step, v0)
    assert tr.shape == (T + 1,)              # pre-commit trace + final
    assert torch.equal(v, vl) and torch.equal(tr, trl)
    jv, jtr = jrt.scan_bcd(jl, jnp.asarray(masks), step,
                           jnp.zeros((M, jl.XS.shape[-1])))
    _rel_close(tr, jtr)
    _rel_close(v, jv)


@pytest.mark.parametrize("R,eval_every", [(1, 1), (3, 5)])
def test_batched_bcd_blocks_equal_per_step_and_reference(R, eval_every):
    jl, tl, step = _lifted()
    T = 45
    masks = _masks(R, T, 5)
    b = tl.XS.shape[-1]
    v, tr = runners.batched_scan_bcd(tl, masks, step, torch.zeros((R, M, b)),
                                     eval_every=eval_every)
    vl, trl = _per_step_batched_bcd(tl, masks, step, torch.zeros((R, M, b)),
                                    eval_every)
    assert tr.shape == (R, T // eval_every)  # post-commit trace
    assert torch.equal(v, vl) and torch.equal(tr, trl)
    jv, jtr = jrt.batched_scan_bcd(jl, jnp.asarray(masks), step,
                                   jnp.zeros((R, M, b)),
                                   eval_every=eval_every)
    for q in range(R):
        _rel_close(tr[q], jtr[q])
        _rel_close(v[q], jv[q])


# -- the sharded placement ----------------------------------------------------

@pytest.mark.parametrize("kind", ["gd", "prox"])
def test_sharded_run_over_four_cpus_takes_the_blocks(probs, kind):
    """Four ``cpu`` chunks of 2, each advanced a block at a time: bit for
    bit the per-step loop over all 8, and the reference's sharded runner
    (the batched run on this one-device host) to rel 1e-5."""
    jp, tp = probs
    R, T = 8, 45
    masks = _masks(R, T, 6)
    kw = dict(h="l1" if kind == "prox" else "l2", eval_every=5,
              degrade=None)
    w, tr = runners._sharded_run(["cpu"] * 4, kind, tp, masks, 0.05,
                                 torch.zeros((R, P)), **kw)
    wl, trl = _per_step(tp, masks, 0.05, torch.zeros((R, P)), kind=kind,
                        **kw)
    assert torch.equal(w, wl) and torch.equal(tr, trl)
    fn = jrt.sharded_scan_gd if kind == "gd" else jrt.sharded_scan_prox
    extra = dict(h="l2") if kind == "gd" else {}
    jw, jtr, _ = fn(jp, jnp.asarray(masks), 0.05, jnp.zeros((R, P)),
                    eval_every=5, **extra)
    for q in range(R):
        _rel_close(tr[q], jtr[q])
        _rel_close(w[q], jw[q])


# -- the capture's bookkeeping, with stand-ins for the card -------------------

class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: ``capture_begin`` /
    ``capture_end`` record, ``replay`` counts (and runs ``on_replay``)."""

    def __init__(self, fail=False, on_replay=None):
        self.fail, self.on_replay = fail, on_replay
        self.calls = []

    def capture_begin(self, **kw):
        self.calls.append(("begin", kw))
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    def capture_end(self):
        self.calls.append(("end", {}))

    def replay(self):
        self.calls.append(("replay", {}))
        if self.on_replay:
            self.on_replay()


class _Card:
    """The stand-in graphs made, and the keywords the next one takes."""

    def __init__(self):
        self.graphs, self.graph_kw = [], {}


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda``'s graph and stream replaced by stand-ins."""
    card = _Card()

    def make_graph():
        card.graphs.append(_FakeGraph(**card.graph_kw))
        return card.graphs[-1]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", make_graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: device)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    return card


def test_counted_takes_a_capture_s_launches_back():
    _build.launches.clear()
    _build.launches["coded_combine"] = 2
    counted = runners._counted(lambda: _build.launches.update(
        fused_masked_gradient=20, coded_combine=3))
    assert counted == {"fused_masked_gradient": 20, "coded_combine": 3}
    assert dict(_build.launches) == {"coded_combine": 2}
    _build.launches.clear()


def test_a_replay_adds_its_capture_s_launches_once():
    _build.launches.clear()
    graph = _FakeGraph()
    rep = runners._Replay(graph, {"fused_masked_gradient": 20})
    for _ in range(3):
        rep.replay()
    assert [c for c, _ in graph.calls] == ["replay"] * 3
    assert _build.launches["fused_masked_gradient"] == 60
    _build.launches.clear()


@pytest.mark.parametrize("capture", [True, False])
def test_blocks_capture_once_and_replay_on_a_card(fake_card, capture):
    """On a card: block 0 eager, the next full block captured once and
    replayed with every later full block, a shorter last block eager; the
    launches read as an uncaptured run's.  ``capture=False`` runs every
    block eagerly."""
    _build.launches.clear()
    ran = []

    def block(n):
        ran.append(n)
        _build.launches["fused_masked_gradient"] += n

    loads, stores = [], []
    gen = runners._blocks("runner:gd", torch.device("cuda", 0), 90, 20,
                          lambda t0, n: loads.append((t0, n)), block,
                          lambda t0, n: stores.append((t0, n)), capture)
    assert sum(1 for _ in gen) == 5          # a yield a block
    assert loads == stores == [(0, 20), (20, 20), (40, 20), (60, 20),
                               (80, 10)]
    if capture:
        (graph,) = fake_card.graphs
        assert [c for c, _ in graph.calls] == ["begin", "end"] + \
            ["replay"] * 3
        assert graph.calls[0][1] == {"capture_error_mode": "thread_local"}
        # block 0 and the last run eagerly, the capture once (no replay)
        assert ran == [20, 20, 10]
    else:
        assert not fake_card.graphs and ran == [20] * 4 + [10]
    assert _build.launches["fused_masked_gradient"] == 90
    _build.launches.clear()


def test_blocks_on_the_cpu_never_capture(probs, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(runners, "_capture", refuse)
    _, tp = probs
    runners.scan_gd(tp, _masks(1, 45, 7)[0], 0.05, torch.zeros(P))


def test_a_failed_capture_raises_naming_the_runner_and_block(fake_card):
    """No eager fallback: the block that failed to capture never runs, and
    the launch counts keep only block 0's."""
    _build.launches.clear()
    ran = []

    def block(n):
        ran.append(n)
        _build.launches["fused_masked_gradient"] += n

    fake_card.graph_kw = dict(fail=True)
    gen = runners._blocks("runner:prox", torch.device("cuda", 0), 60, 20,
                          lambda t0, n: None, block, lambda t0, n: None,
                          True)
    with pytest.raises(RuntimeError, match=r"runner:prox, block 1 \(steps "
                                           r"20-39 of 60\).*cuda:0"):
        list(gen)
    assert ran == [20]
    assert [c for c, _ in fake_card.graphs[0].calls] == ["begin"]
    assert dict(_build.launches) == {"fused_masked_gradient": 20}
    _build.launches.clear()


def test_capture_seconds_count_as_compile_time_in_their_span(fake_card):
    rec = TraceRecorder()
    s0, n0 = _build.capture_seconds, _build.captures
    with rec.activate(), CompileWatch() as cw:
        runners._capture(lambda: time.sleep(0.05), "runner:gd, block 1",
                         torch.device("cuda", 0))
    assert _build.captures == n0 + 1
    spent = _build.capture_seconds - s0
    assert 0.05 <= spent <= cw.total_s
    assert cw.compile_s == pytest.approx(spent) and cw.compiles == 0
    assert [e.name for e in rec.spans()] == ["runner:capture"]
