"""The async runner as blocks of updates (``repro_torch.runtime.runners``:
``_async_updates``, ``_batched_async``, ``_blocks``), on the CPU.

On a card a block of updates is captured once into a CUDA graph and
replayed; the stale iterate's ring slot, the write slot and the arriving
worker (a one-hot mask for the fused kernel, a device index for the
``REPRO_FUSED=0`` products) come from device buffers that ``load`` fills
before each block.  On the CPU the same block function runs eagerly, so
these tests run the code the card captures.  Each case:
  * equals the per-update loop the runner ran before it was split into
    blocks (kept here as ``_per_update``, op for op): bit for bit on the
    ``REPRO_FUSED=0`` branch, which does the same float32 arithmetic in
    the same order, and to rel 1e-6 of its magnitude on the fused branch,
    whose plain version sums a worker's products in another order;
  * and equals the reference's ``scan_async`` / ``batched_scan_async`` to
    rel 1e-5 of its magnitude on objectives and iterates.
Streams of 40 and 45 updates at ``eval_every`` 1 are four whole blocks of
10 and a short last one; at ``eval_every`` 8 (blocks of 16), 40 updates
end on a short block and 48 on a whole one.  Ring sizes 7 and 9 divide no
block length, so each block's slots differ from the last; a ring of 1
holds staleness 0.  The capture's bookkeeping runs with stand-ins for
``torch.cuda``'s graph and stream, so it needs no card.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime as jrt
import repro_torch.core as tcore
from repro_torch.core.data_parallel import original_objective
from repro_torch.kernels import _build
from repro_torch.kernels.fused_step import fused_masked_gradient
from repro_torch.runtime import runners

M, P, N = 8, 32, 128
STEP = 0.002
RTOL, FUSED_RTOL = 1e-5, 1e-6


def _rel_close(out, ref, rtol=RTOL):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


@pytest.fixture(scope="module")
def probs():
    """The async strategy's problem: the uncoded encoder, beta 1."""
    spec = jrt.ProblemSpec.synthetic(N, P, noise=0.5, lam=0.05, seed=0)
    jp = jcore.make_encoded_problem(spec.X, spec.y,
                                    jcore.identity_encoder(N), M,
                                    lam=spec.lam)
    tp = tcore.EncodedProblem.from_numpy(
        np.asarray(jp.SX), np.asarray(jp.Sy), np.asarray(jp.X),
        np.asarray(jp.y), lam=jp.lam, beta=jp.beta, n=jp.n, device="cpu")
    return jp, tp


def _events(R, U, B, seed=0):
    """(R, U) workers and staleness from the engine, bounded by B - 1."""
    batch = jrt.ClusterEngine(jcore.bimodal_delays(), M, seed=seed
                              ).sample_asyncs(U, B - 1, R)
    if B > 2:
        assert batch.staleness.max() > 0
    else:
        assert not batch.staleness.any()
    return batch.workers, batch.staleness


# -- the per-update loop the runner ran before blocks -------------------------

def _per_update(prob, workers, staleness, step_size, w0, B, h, eval_every):
    """One realization's event stream, one update at a time, the slots
    host integers."""
    workers = np.asarray(workers, dtype=np.int64)
    staleness = np.asarray(staleness, dtype=np.int64)
    U = workers.shape[0]
    scale = M / (prob.n * prob.beta)
    w = torch.as_tensor(w0, dtype=torch.float32)
    buf = w[None].repeat(B, 1)
    trace = torch.empty(U // eval_every, dtype=torch.float32)
    for u in range(U):
        i = int(workers[u])
        w_stale = buf[(u - int(staleness[u])) % B]
        SXi = prob.SX[i]
        r = torch.matmul(SXi, w_stale) - prob.Sy[i]
        g = torch.matmul(SXi.T, r) * scale
        if h == "l2":
            g = g + prob.lam * w_stale
        w = w - step_size * g
        buf[(u + 1) % B] = w
        if (u + 1) % eval_every == 0:
            trace[(u + 1) // eval_every - 1] = original_objective(prob, w,
                                                                  h=h)
    return w, trace


def _per_update_batched(prob, workers, staleness, step_size, w0, B, h,
                        eval_every):
    runs = [_per_update(prob, workers[q], staleness[q], step_size, w0[q], B,
                        h, eval_every) for q in range(len(workers))]
    return (torch.stack([w for w, _ in runs]),
            torch.stack([tr for _, tr in runs]))


# -- the blocks against the per-update loop and the reference -----------------

@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("U,eval_every", [(40, 1), (45, 1), (40, 8)])
@pytest.mark.parametrize("R", [1, 3])
def test_blocks_equal_per_update_loop(probs, monkeypatch, fused, U,
                                      eval_every, R):
    monkeypatch.setenv("REPRO_FUSED", fused)
    _, tp = probs
    B = 7
    workers, staleness = _events(R, U, B, seed=1)
    w0 = torch.zeros((R, P))
    w, tr = runners._batched_async(tp, workers, staleness, STEP, w0, B, "l2",
                                   eval_every)
    assert not w0.any()                      # the caller's start is kept
    wl, trl = _per_update_batched(tp, workers, staleness, STEP, w0, B, "l2",
                                  eval_every)
    assert tr.shape == (R, U // eval_every)
    if fused == "0":
        assert torch.equal(w, wl) and torch.equal(tr, trl)
    else:
        _rel_close(w, wl, FUSED_RTOL)
        _rel_close(tr, trl, FUSED_RTOL)


@pytest.mark.parametrize("B", [1, 7, 9])
@pytest.mark.parametrize("U,eval_every", [(40, 1), (45, 1), (40, 8),
                                          (48, 8)])
@pytest.mark.parametrize("h", ["l2", "none"])
def test_scan_async_blocks_match_reference(probs, h, U, eval_every, B):
    jp, tp = probs
    workers, staleness = _events(1, U, B, seed=2)
    w, tr = runners.scan_async(tp, workers[0], staleness[0], STEP,
                               torch.zeros(P), buffer_size=B, h=h,
                               eval_every=eval_every)
    jw, jtr = jrt.scan_async(jp, jnp.asarray(workers[0]),
                             jnp.asarray(staleness[0]), STEP, jnp.zeros(P),
                             buffer_size=B, h=h, eval_every=eval_every)
    assert tr.shape == (U // eval_every,)
    _rel_close(tr, jtr)
    _rel_close(w, jw)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("B,eval_every", [(1, 1), (9, 5)])
def test_batched_blocks_match_reference(probs, monkeypatch, fused, B,
                                        eval_every):
    monkeypatch.setenv("REPRO_FUSED", fused)
    jp, tp = probs
    R, U = 4, 45
    workers, staleness = _events(R, U, B, seed=3)
    w, tr = runners.batched_scan_async(tp, workers, staleness, STEP,
                                       torch.zeros((R, P)), buffer_size=B,
                                       eval_every=eval_every)
    jw, jtr = jrt.batched_scan_async(jp, jnp.asarray(workers),
                                     jnp.asarray(staleness), STEP,
                                     jnp.zeros((R, P)), buffer_size=B,
                                     eval_every=eval_every)
    for q in range(R):
        _rel_close(tr[q], jtr[q])
        _rel_close(w[q], jw[q])


@pytest.mark.parametrize("fused", ["1", "0"])
def test_batched_rows_equal_single_runs(probs, monkeypatch, fused):
    """Realization r of a batched run equals its stream run alone, and
    ``batched_scan_async`` at R = 1 equals ``scan_async``, bit for bit."""
    monkeypatch.setenv("REPRO_FUSED", fused)
    _, tp = probs
    R, U, B = 4, 45, 9
    workers, staleness = _events(R, U, B, seed=4)
    w0 = torch.randn((R, P), generator=torch.Generator().manual_seed(0))
    w, tr = runners.batched_scan_async(tp, workers, staleness, STEP, w0,
                                       buffer_size=B, eval_every=5)
    for q in range(R):
        w1, tr1 = runners.scan_async(tp, workers[q], staleness[q], STEP,
                                     w0[q], buffer_size=B, eval_every=5)
        assert torch.equal(w[q], w1) and torch.equal(tr[q], tr1)
        wb, tb = runners.batched_scan_async(tp, workers[q:q + 1],
                                            staleness[q:q + 1], STEP,
                                            w0[q:q + 1], buffer_size=B,
                                            eval_every=5)
        assert torch.equal(wb[0], w1) and torch.equal(tb[0], tr1)


def test_zero_staleness_reads_the_current_iterate(probs):
    """B = 1: every update reads the ring's one slot before it is
    overwritten, so the run is sequential SGD."""
    jp, tp = probs
    U = 45
    workers = np.random.default_rng(5).integers(0, M, size=U)
    w, _ = runners.scan_async(tp, workers, np.zeros(U, np.int32), STEP,
                              torch.zeros(P), buffer_size=1)
    ref = np.zeros(P)
    SX, Sy = np.asarray(jp.SX, np.float64), np.asarray(jp.Sy, np.float64)
    for i in workers:
        g = SX[i].T @ (SX[i] @ ref - Sy[i]) * (M / (jp.n * jp.beta))
        ref = ref - STEP * (g + jp.lam * ref)
    _rel_close(w, ref)


def test_sharded_run_over_four_cpus_takes_the_blocks(probs):
    """Four ``cpu`` chunks of 2, each advanced a block at a time: bit for
    bit the batched run and the per-update loop's rows to rel 1e-6."""
    _, tp = probs
    R, U, B = 8, 45, 7
    workers, staleness = _events(R, U, B, seed=6)
    w0 = torch.zeros((R, P))
    args = (workers, staleness, STEP, w0, B, "l2", 1)
    w, tr = runners._sharded_run(["cpu"] * 4, "async", tp, *args)
    wb, tb = runners._batched_async(tp, *args)
    assert torch.equal(w, wb) and torch.equal(tr, tb)
    wl, trl = _per_update_batched(tp, *args)
    _rel_close(w, wl, FUSED_RTOL)
    _rel_close(tr, trl, FUSED_RTOL)


def test_async_refuses_bad_streams(probs):
    _, tp = probs
    workers, staleness = _events(1, 40, 7)
    with pytest.raises(ValueError, match="divisor of the 40-update"):
        runners.scan_async(tp, workers[0], staleness[0], STEP,
                           torch.zeros(P), buffer_size=7, eval_every=3)
    bad = workers[0].copy()
    bad[3] = M
    with pytest.raises(ValueError, match=r"worker ids must lie in \[0, 8\)"):
        runners.scan_async(tp, bad, staleness[0], STEP, torch.zeros(P),
                           buffer_size=7)


# -- the capture's bookkeeping, with stand-ins for the card -------------------

class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records its calls; a replay
    runs nothing."""

    def __init__(self):
        self.calls = []

    def capture_begin(self, **kw):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        self.calls.append("replay")


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda``'s graph and stream replaced by stand-ins, the blocks
    told they run on card 0, and the fused wrapper counting a launch a
    call as it does on a card."""
    graphs = []

    def make_graph():
        graphs.append(_FakeGraph())
        return graphs[-1]

    def counted(*a, **kw):
        _build.launches["fused_masked_gradient"] += 1
        return fused_masked_gradient(*a, **kw)

    blocks = runners._blocks
    monkeypatch.setattr(torch.cuda, "CUDAGraph", make_graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: device)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(runners, "_blocks", lambda name, device, *a:
                        blocks(name, torch.device("cuda", 0), *a))
    monkeypatch.setattr(runners, "fused_masked_gradient", counted)
    return graphs


@pytest.mark.parametrize("U,eval_every", [(45, 1), (64, 8)])
def test_async_captures_once_and_counts_as_uncaptured(probs, fake_card, U,
                                                      eval_every):
    """On a card: one capture a run, a replay for every full block after
    it, and the launches (one fused a update) equal an uncaptured run's."""
    _, tp = probs
    R, B = 3, 9
    workers, staleness = _events(R, U, B, seed=7)
    c = runners._block_steps(eval_every)
    counts = {}
    for cap in (True, False):
        _build.launches.clear()
        n0 = _build.captures
        runners._batched_async(tp, workers, staleness, STEP,
                               torch.zeros((R, P)), B, "l2", eval_every, cap)
        counts[cap] = (dict(_build.launches), _build.captures - n0)
    _build.launches.clear()
    assert counts[True] == ({"fused_masked_gradient": U}, 1)
    assert counts[False] == ({"fused_masked_gradient": U}, 0)
    (graph,) = fake_card
    assert graph.calls == ["begin", "end"] + ["replay"] * (U // c - 1)
