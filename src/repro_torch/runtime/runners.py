"""Device-resident iteration loops: encoded GD and ISTA, encoded BCD and
asynchronous stale-gradient SGD.

Port of ``src/repro/runtime/runners.py``, whose runners are each one
jitted ``lax.scan``.  Here every loop runs in **blocks** of c steps
(``_block_steps``: the least multiple of ``eval_every`` at or above 10;
a schedule's last block may be shorter); an async update counts as a
step.  A block reads and writes only tensors allocated before it: the
iterate, updated in place, the hold-mode gradient carry or the async ring
of stale iterates, index blocks that ``load`` fills from the schedule or
the event stream before the block (masks; for async the one-hot worker
masks and the ring's read and write slots), and an objective block that
one copy moves into the trace after it.  On a card, block 0 runs eagerly
(it is also the warm-up: the kernel library's build and per-card
attributes, cuBLAS's handle); the next full block is **captured** once
into a CUDA graph on a side stream, which executes nothing (the port's
capture tool, ``repro_torch.graphs``, which the model zoo's recurrences
share); and that block and every later full block is a **replay** of the
graph, so the host enqueues a few calls every c steps, not every op of
every step.  A shorter last block runs eagerly.  A run captures its own
graph.  The capture takes the place of the reference's trace and compile
of its scan: its host seconds add to ``kernels._build.capture_seconds``
(``obs.timing.CompileWatch`` counts them as compile time) and it is the
obs span ``runner:capture``.  A capture that fails raises, naming the
runner and the block; nothing falls back to the eager loop.  On the CPU nothing is captured: the same block
function runs eagerly, block by block, so the CPU tests run the code that
the card captures.  The kernels' wrappers count launches on the host when
they are called (``kernels._build.launches``), so a capture's counts are
taken back and every replay adds them once: the counts read as an
uncaptured run's.  Nothing inside a run reads a value back to the host;
callers copy the results once, at the end.

Every GD / ISTA step takes the masked gradient as the reference's
``_masked_grad`` does: one call of the fused kernel
(``kernels/fused_step.py``) when ``fused_enabled()`` (on unless
``REPRO_FUSED`` turns it off), else ``core.data_parallel.masked_gradient``
for each realization, whose combine is the coded-combine kernel.  Every
async update is the same kernel with the arriving worker as a one-hot
mask (k = 1, so its weight m / (n beta) is the reference's scale), one
launch for all R realizations, which reads only that worker's rows; with
``REPRO_FUSED=0`` it is the reference's own form, the worker's block
gathered by its device index and two plain products a realization.
Either way the problem's device decides between the CUDA kernel and its
plain PyTorch version.

One implementation serves the single and the batched runners: a single
run is the batched loop at R = 1, so ``batched_scan_*`` at R = 1 equals
``scan_*`` bit for bit, and since neither the kernel's sums nor the
per-realization objective depend on the batch, realization r of a
batched (or cell-batched) run equals the same realization run alone.
``eval_every=s`` records f after steps s, 2s, ... (every s-th entry of the
dense trace), as the reference does.

The BCD runners make plain products (``torch.einsum`` / ``torch.matmul``
in full float32), as the reference leaves them to XLA; no kernel of the
port is on their path.  Their batched form runs each realization's
products on its own, one realization after the other within a step, so a
realization never depends on the batch around it.

The sharded runners split the realization axis over every visible card,
as the reference's ``shard_map`` over a ``trials`` mesh axis does: each
card runs the batched loop over its contiguous chunk of realizations on
its own copy of the problem, with no collective, and the results are
gathered back in order, so realization r equals the batched run's bit for
bit.  The loops are generators that yield once a block (``_steps``,
``_async_updates``), so one host thread advances every card's chunk in
turn: a replay a card every c steps.  Each chunk captures its own graph
with its card current, and each kernel launches with its operands' card
current (``kernels/_build.launch``).
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from repro_torch.core.data_parallel import (EncodedProblem, masked_gradient,
                                            original_objective, prox_l1)
from repro_torch.core.model_parallel import LiftedProblem
from repro_torch.device import full_f32_matmul
from repro_torch.graphs import _capture, _counted, _Replay  # noqa: F401
from repro_torch.kernels import _build
from repro_torch.kernels.fused_step import (fused_enabled,
                                            fused_masked_gradient)
from repro_torch.obs.trace import current_recorder as _obs_recorder

__all__ = [
    "scan_gd", "scan_prox", "scan_bcd", "scan_async",
    "batched_scan_gd", "batched_scan_prox", "batched_scan_bcd",
    "batched_scan_async",
    "sharded_scan_gd", "sharded_scan_prox", "sharded_scan_async",
    "trials_device_count",
]


def _traced_call(name: str, fn, *args, **kw):
    """Run a runner; under an active obs ``TraceRecorder`` the call is
    wrapped in a host-clock span that waits for the device, so the span
    covers the real execute time.  With tracing off this is one
    module-global check and nothing waits."""
    rec = _obs_recorder()
    if rec is None:
        return fn(*args, **kw)
    with rec.span(name):
        out = fn(*args, **kw)
        if out[0].is_cuda:
            torch.cuda.synchronize(out[0].device)
    return out


def _masked_grad(prob: EncodedProblem, W: torch.Tensor, masks: torch.Tensor,
                 fused: bool) -> torch.Tensor:
    """The (R, p) masked gradients of one step: the fused kernel over all R
    realizations when ``fused`` (``fused_enabled()``, read once a run),
    else the unfused ``masked_gradient`` (one coded-combine launch a
    realization)."""
    if fused:
        return fused_masked_gradient(prob.SX, prob.Sy, W, masks, n=prob.n,
                                     beta=prob.beta)
    return torch.stack([masked_gradient(prob, W[q], masks[q])
                        for q in range(W.shape[0])])


def _runner_name(base: str) -> str:
    """Obs span name; the fused path says so, as the reference's does."""
    return base + ":fused" if fused_enabled() else base


# -- sub-k degradation (runtime.faults) --------------------------------------
#
# ``degrade`` reaches the runners as a hashable tuple ("hold", k_min,
# shrink) or None; only hold-mode needs runner support (a gradient carry),
# renormalize is the default masked-mean math and backoff lives in the
# engine.

def _degrade_tuple(degrade):
    """Normalize DegradePolicy | tuple | None to the runner arg."""
    if degrade is None or isinstance(degrade, tuple):
        return degrade
    if getattr(degrade, "mode", None) == "hold":
        return ("hold", int(degrade.k_min or 1), float(degrade.shrink))
    return None


def _step_vector(step_size, R: int, device) -> torch.Tensor:
    """Per-realization float32 step sizes: a scalar broadcasts to all R, a
    (R,) vector (the cell-batching path) passes through."""
    return torch.broadcast_to(
        torch.as_tensor(step_size, dtype=torch.float32, device=device),
        (R,)).contiguous()


def _objectives(prob: EncodedProblem, W: torch.Tensor, h: str):
    """f of each realization's iterate, one matrix-vector product each, so
    a realization's value never depends on the batch around it."""
    return torch.stack([original_objective(prob, W[q], h=h)
                        for q in range(W.shape[0])])


# -- blocks of steps, captured once and replayed ------------------------------

# steps a block holds at least.  A capture costs 1.4-3.2 times an eager
# block's host time and the replays start after it (PAPER_RIDGE on an
# H100, chip_smoke.py's "graph" lines), so the block is short; a replay's
# three host calls stay far below ten steps of device work.  Async updates
# take the same length: 10 ran faster than 20 and 40 at 320 and 3200
# updates
_BLOCK_STEPS = 10


def _block_steps(eval_every: int) -> int:
    """Steps c of a block: the least multiple of ``eval_every`` at or above
    ``_BLOCK_STEPS``, so every block records whole objective strides."""
    return eval_every * -(-_BLOCK_STEPS // eval_every)


def _blocks(name: str, device: torch.device, T: int, c: int, load, block,
            store, capture: bool):
    """The T steps as blocks of c, a generator that yields after each
    block.  ``load(t0, n)`` copies block [t0, t0 + n)'s masks into the mask
    block, ``block(n)`` enqueues n steps on the static buffers,
    ``store(t0, n)`` copies its objectives out.  On a card (``capture``)
    the first full block after block 0 is captured and every full block
    from it on replayed; block 0 and a shorter last block run eagerly, as
    every block does on the CPU or without ``capture``."""
    capture = capture and device.type == "cuda"
    graph = None
    for b, t0 in enumerate(range(0, T, c)):
        n = min(c, T - t0)
        load(t0, n)
        if capture and b > 0 and n == c:
            if graph is None:
                graph = _capture(
                    lambda: block(c),
                    f"{name}, block {b} (steps {t0}-{t0 + c - 1} of {T})",
                    device)
            graph.replay()
        else:
            block(n)
        store(t0, n)
        yield


def _steps(prob: EncodedProblem, masks, step_size, w0, *, kind: str,
           h: str, eval_every: int, degrade, capture: bool = True):
    """The T-step loop over R realizations as blocks (module docstring),
    a generator: masks (R, T, m), w0 (R, p).  It yields once a block,
    after the block's work is enqueued, and returns (W (R, p), trace
    (R, T // eval_every)) on the problem's device.  ``_run`` drains it; a
    sharded run drains one a card.  ``capture=False`` runs every block
    eagerly on a card too (the A/B checks)."""
    dev = prob.device
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    # the iterate is updated in place: W.sub_(step * g) rounds as
    # W - step * g does, one subtraction an element
    W = torch.as_tensor(w0, dtype=torch.float32, device=dev).clone()
    R, T, m = masks.shape
    if eval_every < 1 or T % eval_every:
        raise ValueError(f"eval_every={eval_every} must be a positive "
                         f"divisor of the {T}-step schedule")
    c = _block_steps(eval_every)
    step = _step_vector(step_size, R, dev)[:, None]
    trace = torch.empty((R, T // eval_every), dtype=torch.float32,
                        device=dev)
    # step-major mask block: mblk[i] is one contiguous (R, m) kernel operand
    mblk = torch.empty((min(c, T), R, m), dtype=torch.float32, device=dev)
    oblk = torch.empty((R, min(c, T) // eval_every), dtype=torch.float32,
                       device=dev)
    h_obj = "l1" if kind == "prox" else h
    thresh = step * prob.lam
    g_prev = torch.zeros_like(W) if degrade is not None else None
    fused = fused_enabled()

    def block(n: int) -> None:
        for i in range(n):
            mask = mblk[i]
            g = _masked_grad(prob, W, mask, fused)
            if kind == "gd" and h == "l2":
                g = g + prob.lam * W
            if degrade is not None:
                # below k_min survivors reuse the last gradient at shrink x
                # its scale; the shrunk gradient re-enters the carry, so
                # consecutive sub-k rounds decay geometrically
                _, k_min, shrink = degrade
                subk = mask.sum(-1, keepdim=True) < k_min
                g = torch.where(subk, shrink * g_prev, g)
                g_prev.copy_(g)
            if kind == "gd":
                W.sub_(step * g)
            else:
                W.copy_(prox_l1(W - step * g, thresh))
            if (i + 1) % eval_every == 0:
                oblk[:, (i + 1) // eval_every - 1] = _objectives(prob, W,
                                                                 h_obj)

    def load(t0: int, n: int) -> None:
        mblk[:n].copy_(masks[:, t0:t0 + n].transpose(0, 1))

    def store(t0: int, n: int) -> None:
        trace[:, t0 // eval_every:(t0 + n) // eval_every].copy_(
            oblk[:, :n // eval_every])

    yield from _blocks(f"runner:{kind}", dev, T, c, load, block, store,
                       capture)
    return W, trace


def _drain(steps):
    """Run a step generator to its end; its return value."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _run(prob: EncodedProblem, masks, step_size, w0, *, kind: str, h: str,
         eval_every: int, degrade, capture: bool = True):
    """The T-step loop over R realizations (see ``_steps``)."""
    return _drain(_steps(prob, masks, step_size, w0, kind=kind, h=h,
                         eval_every=eval_every, degrade=degrade,
                         capture=capture))


def _single(kind: str, prob, masks, step_size, w0, **kw):
    masks = torch.as_tensor(masks, dtype=torch.float32, device=prob.device)
    w0 = torch.as_tensor(w0, dtype=torch.float32, device=prob.device)
    W, tr = _run(prob, masks[None], step_size, w0[None], kind=kind, **kw)
    return W[0], tr[0]


def scan_gd(prob: EncodedProblem, masks, step_size, w0, h: str = "l2",
            eval_every: int = 1, degrade=None):
    """Encoded GD over a (T, m) mask schedule.

    Returns (w_T, trace) with trace[t] = f(w_{t+1}) on the original problem
    (``eval_every=s`` strides it).  ``degrade`` selects the sub-k behavior
    (hold-mode gradient carry); None is the default renormalized math.
    """
    return _traced_call(_runner_name("runner:gd"), _single, "gd", prob,
                        masks, step_size, w0, h=h, eval_every=eval_every,
                        degrade=_degrade_tuple(degrade))


def scan_prox(prob: EncodedProblem, masks, step_size, w0,
              eval_every: int = 1, degrade=None):
    """Encoded proximal gradient (ISTA, l1) over a mask schedule."""
    return _traced_call(_runner_name("runner:prox"), _single, "prox",
                        prob, masks, step_size, w0, h="l1",
                        eval_every=eval_every,
                        degrade=_degrade_tuple(degrade))


def batched_scan_gd(prob: EncodedProblem, masks, step_size, w0,
                    h: str = "l2", eval_every: int = 1, degrade=None):
    """R realizations of encoded GD in one device loop.

    masks: (R, T, m) stacked schedules; w0: (R, p) per-realization starts.
    ``step_size`` may be a scalar or a per-realization (R,) vector.  Returns
    (w (R, p), trace (R, T // eval_every)) with trace[r, j] = f(w after
    step (j+1)*eval_every) of realization r.
    """
    R = len(masks)
    name = "runner:gd" if R == 1 else "runner:batched_gd"
    return _traced_call(_runner_name(name), _run, prob, masks,
                        step_size, w0, kind="gd", h=h, eval_every=eval_every,
                        degrade=_degrade_tuple(degrade))


def batched_scan_prox(prob: EncodedProblem, masks, step_size, w0,
                      eval_every: int = 1, degrade=None):
    """R realizations of encoded ISTA in one device loop (see
    ``batched_scan_gd`` for the axis and eval_every conventions)."""
    R = len(masks)
    name = "runner:prox" if R == 1 else "runner:batched_prox"
    return _traced_call(_runner_name(name), _run, prob, masks,
                        step_size, w0, kind="prox", h="l1",
                        eval_every=eval_every,
                        degrade=_degrade_tuple(degrade))


# ---------------------------------------------------------------------------
# Encoded BCD (model parallelism)
# ---------------------------------------------------------------------------

def _activations(XS, v):
    """z = sum_i u_i, u_i = X S_i^T v_i: one product batched over the
    workers, then the sum over them in order."""
    return torch.einsum("mnb,mb->mn", XS, v).sum(dim=0)


def _bcd_step(XS, v, mask, step_size, phi_grad):
    """Every worker's step from the current activations z; only the workers
    in the mask commit it.  Returns (v_next, z)."""
    z = _activations(XS, v)
    # (n,) @ (m, n, b) is batched over the workers and reads XS where it
    # lies; einsum("mnb,n->mb") would first copy XS into (m, b, n) order
    d = -step_size * torch.matmul(phi_grad(z), XS)
    return v + mask[:, None] * d, z


@full_f32_matmul
def _scan_bcd(prob: LiftedProblem, masks, step_size, v0,
              capture: bool = True):
    """The T-step BCD loop as blocks of ``_block_steps(1)`` (module
    docstring); ``capture=False`` runs every block eagerly on a card
    too."""
    dev = prob.device
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    v = torch.as_tensor(v0, dtype=torch.float32, device=dev).clone()
    T, m = masks.shape
    c = _block_steps(1)
    trace = torch.empty(T + 1, dtype=torch.float32, device=dev)
    mblk = torch.empty((min(c, T), m), dtype=torch.float32, device=dev)
    oblk = torch.empty(min(c, T), dtype=torch.float32, device=dev)

    def block(n: int) -> None:
        for i in range(n):
            v_next, z = _bcd_step(prob.XS, v, mblk[i], step_size,
                                  prob.phi_grad)
            v.copy_(v_next)
            oblk[i] = prob.phi_val(z)

    _drain(_blocks("runner:bcd", dev, T, c,
                   lambda t0, n: mblk[:n].copy_(masks[t0:t0 + n]), block,
                   lambda t0, n: trace[t0:t0 + n].copy_(oblk[:n]), capture))
    trace[T] = prob.phi_val(_activations(prob.XS, v))
    return v, trace


def scan_bcd(prob: LiftedProblem, masks, step_size, v0):
    """Encoded BCD (model parallelism) over a (T, m) mask schedule.

    Trace convention of the reference's legacy loop: trace[t] = phi(z_t)
    BEFORE the t-th commit, with the final objective appended (length
    T + 1).
    """
    return _traced_call("runner:bcd", _scan_bcd, prob, masks, step_size, v0)


@full_f32_matmul
def _batched_bcd(prob: LiftedProblem, masks, step_size, v0, eval_every,
                 capture: bool = True):
    """R realizations of the BCD loop as blocks of
    ``_block_steps(eval_every)`` (module docstring)."""
    dev = prob.device
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    V = torch.as_tensor(v0, dtype=torch.float32, device=dev).clone()
    R, T, m = masks.shape
    if eval_every < 1 or T % eval_every:
        raise ValueError(f"eval_every={eval_every} must be a positive "
                         f"divisor of the {T}-step schedule")
    c = _block_steps(eval_every)
    trace = torch.empty((R, T // eval_every), dtype=torch.float32,
                        device=dev)
    mblk = torch.empty((R, min(c, T), m), dtype=torch.float32, device=dev)
    oblk = torch.empty((R, min(c, T) // eval_every), dtype=torch.float32,
                       device=dev)

    def block(n: int) -> None:
        for i in range(n):
            for q in range(R):
                V[q] = _bcd_step(prob.XS, V[q], mblk[q, i], step_size,
                                 prob.phi_grad)[0]
            if (i + 1) % eval_every == 0:
                for q in range(R):
                    oblk[q, (i + 1) // eval_every - 1] = prob.phi_val(
                        _activations(prob.XS, V[q]))

    def store(t0: int, n: int) -> None:
        trace[:, t0 // eval_every:(t0 + n) // eval_every].copy_(
            oblk[:, :n // eval_every])

    _drain(_blocks("runner:batched_bcd", dev, T, c,
                   lambda t0, n: mblk[:, :n].copy_(masks[:, t0:t0 + n]),
                   block, store, capture))
    return V, trace


def batched_scan_bcd(prob: LiftedProblem, masks, step_size, v0,
                     eval_every: int = 1):
    """R realizations of encoded BCD in one device loop.

    masks: (R, T, m); v0: (R, m, b).  Unlike ``scan_bcd``'s pre-commit
    trace, the batched trace is POST-commit: trace[r, j] = phi(z after
    commit (j+1)*eval_every).  Both evaluate phi on the same activations,
    so at eval_every=1 realization r equals ``scan_bcd``'s trace[1:] on
    its masks bit for bit.
    """
    name = "runner:bcd" if len(masks) == 1 else "runner:batched_bcd"
    return _traced_call(name, _batched_bcd, prob, masks, step_size, v0,
                        eval_every)


# ---------------------------------------------------------------------------
# Asynchronous stale-gradient SGD
# ---------------------------------------------------------------------------

def _async_slots(workers, staleness, buffer_size: int, m: int):
    """The event streams' device indices, built once on the host before
    the run: (U, R) workers, (U, R) read slots (u - tau_u) mod B, the
    iterate worker i_u last read (head == u before update u), and (U,)
    write slots (u + 1) mod B."""
    workers = np.asarray(torch.as_tensor(workers).cpu(), dtype=np.int64)
    staleness = np.asarray(torch.as_tensor(staleness).cpu(), dtype=np.int64)
    if workers.ndim != 2 or staleness.shape != workers.shape:
        raise ValueError(f"expected (R, U) workers and staleness, got "
                         f"{workers.shape} and {staleness.shape}")
    if workers.size and (workers.min() < 0 or workers.max() >= m):
        raise ValueError(f"worker ids must lie in [0, {m}), got "
                         f"[{workers.min()}, {workers.max()}]")
    u = np.arange(workers.shape[1])
    return (workers.T.copy(), ((u - staleness) % buffer_size).T.copy(),
            (u + 1) % buffer_size)


def _async_updates(prob: EncodedProblem, workers, staleness, step_size, w0,
                   buffer_size: int, h: str, eval_every: int,
                   capture: bool = True):
    """R realizations' event streams (workers / staleness (R, U), w0
    (R, p)) as blocks of ``_block_steps(eval_every)`` updates (module
    docstring), a generator that yields once a block and returns (W (R, p),
    trace (R, U // eval_every)).  The ring of the last ``buffer_size``
    iterates, (R, B, p), lives on the device; update u gathers each
    realization's stale iterate by its read slot, takes its gradient at
    it, steps, and writes the new iterate into the write slot, reading
    before writing, so staleness 0 with B = 1 reads the current iterate.
    Every index comes from a block of device buffers that ``load`` fills:
    a graph replays what its capture recorded, so a slot taken as a host
    integer would be the same in every replay.  ``capture=False`` runs
    every block eagerly on a card too (the A/B checks)."""
    dev = prob.device
    m = prob.SX.shape[0]
    wk, rs, ws = (torch.as_tensor(a, device=dev) for a in _async_slots(
        workers, staleness, buffer_size, m))
    U, R = wk.shape
    if eval_every < 1 or U % eval_every:
        raise ValueError(f"eval_every={eval_every} must be a positive "
                         f"divisor of the {U}-update stream")
    W = torch.as_tensor(w0, dtype=torch.float32, device=dev).clone()
    ring = W[:, None].repeat(1, buffer_size, 1)
    c = _block_steps(eval_every)
    step = _step_vector(step_size, R, dev)[:, None]
    scale = m / (prob.n * prob.beta)
    trace = torch.empty((R, U // eval_every), dtype=torch.float32,
                        device=dev)
    rows = torch.arange(R, device=dev)
    cb = min(c, U)
    rblk = torch.empty((cb, R), dtype=torch.int64, device=dev)
    wsblk = torch.empty(cb, dtype=torch.int64, device=dev)
    oblk = torch.empty((R, cb // eval_every), dtype=torch.float32,
                       device=dev)
    fused = fused_enabled()
    if fused:
        # the arriving worker as a one-hot mask: k = 1, so the kernel's
        # c_i = m / (n beta), the reference's scale
        mblk = torch.empty((cb, R, m), dtype=torch.float32, device=dev)
    else:
        wblk = torch.empty((cb, R), dtype=torch.int64, device=dev)

    def grad(i: int, W_stale: torch.Tensor) -> torch.Tensor:
        if fused:
            return fused_masked_gradient(prob.SX, prob.Sy, W_stale, mblk[i],
                                         n=prob.n, beta=prob.beta)
        # the reference's own form, a realization at a time: the worker's
        # block gathered by its device index, then two plain products
        out = []
        for q in range(R):
            i_u = wblk[i, q:q + 1]
            SXi = prob.SX.index_select(0, i_u)[0]          # (r, p)
            r = torch.matmul(SXi, W_stale[q]) - prob.Sy.index_select(
                0, i_u)[0]
            out.append(torch.matmul(SXi.T, r) * scale)
        return torch.stack(out)

    def block(n: int) -> None:
        for i in range(n):
            W_stale = ring[rows, rblk[i]]                   # (R, p)
            g = grad(i, W_stale)
            if h == "l2":
                g = g + prob.lam * W_stale
            W.sub_(step * g)
            ring.index_copy_(1, wsblk[i:i + 1], W[:, None])
            if (i + 1) % eval_every == 0:
                oblk[:, (i + 1) // eval_every - 1] = _objectives(prob, W, h)

    def load(t0: int, n: int) -> None:
        rblk[:n].copy_(rs[t0:t0 + n])
        wsblk[:n].copy_(ws[t0:t0 + n])
        if fused:
            mblk[:n].zero_().scatter_(2, wk[t0:t0 + n, :, None], 1.0)
        else:
            wblk[:n].copy_(wk[t0:t0 + n])

    def store(t0: int, n: int) -> None:
        trace[:, t0 // eval_every:(t0 + n) // eval_every].copy_(
            oblk[:, :n // eval_every])

    yield from _blocks("runner:async", dev, U, c, load, block, store,
                       capture)
    return W, trace


@full_f32_matmul
def _batched_async(prob, workers, staleness, step_size, w0, buffer_size, h,
                   eval_every, capture: bool = True):
    """R realizations' event streams (see ``_async_updates``)."""
    return _drain(_async_updates(prob, workers, staleness, step_size, w0,
                                 buffer_size, h, eval_every, capture))


def _single_async(prob, workers, staleness, step_size, w0, buffer_size, h,
                  eval_every):
    w0 = torch.as_tensor(w0, dtype=torch.float32, device=prob.device)
    W, tr = _batched_async(prob, torch.as_tensor(workers)[None],
                           torch.as_tensor(staleness)[None], step_size,
                           w0[None], buffer_size, h, eval_every)
    return W[0], tr[0]


def scan_async(prob: EncodedProblem, workers, staleness, step_size, w0,
               buffer_size: int, h: str = "l2", eval_every: int = 1):
    """Asynchronous stale-gradient SGD over a per-arrival event stream.

    workers[u]   — which worker's gradient lands at update u;
    staleness[u] — how many master updates happened since that worker read w.

    The ring buffer holds the last ``buffer_size`` iterates (buffer_size
    must exceed the engine's staleness bound); update u computes worker i's
    block gradient at the stale iterate and applies it immediately.  The
    per-worker gradient is scaled by m, an unbiased estimate of the full
    gradient.  Returns (w, trace) with trace[j] = f after update
    (j+1)*eval_every.
    """
    return _traced_call("runner:async", _single_async, prob, workers,
                        staleness, step_size, w0, buffer_size, h, eval_every)


def batched_scan_async(prob: EncodedProblem, workers, staleness, step_size,
                       w0, buffer_size: int, h: str = "l2",
                       eval_every: int = 1):
    """R realizations of async stale-gradient SGD.

    workers/staleness: (R, U) stacked event streams; w0: (R, p).  Returns
    (w (R, p), trace (R, U // eval_every)).  The realizations step together,
    one kernel launch an update for all R, and neither the kernel's sums
    nor the objective depend on the batch, so realization r equals
    ``scan_async`` on its stream bit for bit.
    """
    name = "runner:async" if len(workers) == 1 else "runner:batched_async"
    return _traced_call(name, _batched_async, prob, workers, staleness,
                        step_size, w0, buffer_size, h, eval_every)


# ---------------------------------------------------------------------------
# The realization axis over cards (the reference's shard_map over a
# 'trials' mesh axis): each card runs the batched loop over its contiguous
# chunk of the R realizations on its own copy of the problem; no
# collective, the results gathered back in order
# ---------------------------------------------------------------------------

def trials_device_count(trials: int, device=None) -> int:
    """Cards the realization axis of ``trials`` realizations is spread
    over: every visible card when there are more than one and they divide
    R evenly, else 1 (the batched run on the problem's device), the
    reference's rule.  A problem on the CPU (``device``; None is the card)
    runs on its one device."""
    if torch.device(device or "cuda").type != "cuda":
        return 1
    ndev = torch.cuda.device_count()
    return ndev if ndev > 1 and trials % ndev == 0 else 1


def _device_guard(device: torch.device):
    """``device`` made current for the calling thread (a card), or
    nothing (the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@full_f32_matmul
def _sharded_run(devices, kind: str, prob: EncodedProblem, *args, **kw):
    """Realizations split over ``devices`` (entries may repeat): chunk j,
    realizations [j R/ndev, (j+1) R/ndev), runs on ``devices[j]`` against
    its own copy of the problem.  One host thread advances the chunks in
    turn, each with its device current, one block of each chunk in turn:
    on cards, each chunk captures its own graph with its card current and
    the host enqueues a replay a card every block.  ``kind`` "gd" / "prox"
    takes ``_steps``'s (masks, step_size, w0) and keywords, a (R,) step
    vector split with its chunk; "async" takes ``_async_updates``'s
    (workers, staleness, step_size, w0, buffer_size, h, eval_every), the
    event streams split with their realizations.  A host thread a card,
    measured on an H100 with the step loop uncaptured, ran a step 2.3x
    slower than one thread (PERF.md, "sharded").  Returns (w, trace)
    gathered onto the problem's device in realization order.  A chunk that
    fails raises; none is run again elsewhere."""
    devices = [torch.device(d) for d in devices]
    ndev, R = len(devices), len(args[0])
    if R % ndev:
        raise ValueError(f"{R} realizations do not split evenly over "
                         f"{ndev} devices")
    c = R // ndev
    if kind in ("gd", "prox"):
        masks, step_size, w0 = args
        args = (masks, _step_vector(step_size, R, prob.device), w0)
        steps = functools.partial(_steps, kind=kind, **kw)
        split = (True, True, True)
    elif kind == "async":
        steps = functools.partial(_async_updates, **kw)
        split = (True, True, False, True, False, False, False)
    else:
        raise KeyError(f"unknown sharded runner kind '{kind}'")
    copies = {d: prob.to(d) for d in set(devices)}
    chunks = [steps(copies[d], *[a[j * c:(j + 1) * c] if cut else a
                                 for a, cut in zip(args, split)])
              for j, d in enumerate(devices)]
    outs = [None] * ndev
    live = list(range(ndev))
    while live:
        for j in list(live):
            with _device_guard(devices[j]):
                try:
                    next(chunks[j])
                except StopIteration as done:
                    outs[j] = done.value
                    live.remove(j)
    return (torch.cat([w.to(prob.device) for w, _ in outs]),
            torch.cat([tr.to(prob.device) for _, tr in outs]))


def _visible_cards(ndev: int) -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(ndev)]


def sharded_scan_gd(prob: EncodedProblem, masks, step_size, w0,
                    h: str = "l2", eval_every: int = 1, degrade=None):
    """``batched_scan_gd`` with the realization axis split over every
    visible card (``trials_device_count``), the problem copied to each.
    Returns (w, trace, ndev); ndev == 1 is the batched run.  Realization
    r equals the batched run's realization r bit for bit."""
    degrade = _degrade_tuple(degrade)
    ndev = trials_device_count(len(masks), prob.device)
    if ndev == 1:
        w, tr = batched_scan_gd(prob, masks, step_size, w0, h=h,
                                eval_every=eval_every, degrade=degrade)
        return w, tr, 1
    w, tr = _traced_call("runner:sharded_gd", _sharded_run,
                         _visible_cards(ndev), "gd", prob, masks, step_size,
                         w0, h=h, eval_every=eval_every, degrade=degrade)
    return w, tr, ndev


def sharded_scan_prox(prob: EncodedProblem, masks, step_size, w0,
                      eval_every: int = 1, degrade=None):
    """``batched_scan_prox`` placed like ``sharded_scan_gd``."""
    degrade = _degrade_tuple(degrade)
    ndev = trials_device_count(len(masks), prob.device)
    if ndev == 1:
        w, tr = batched_scan_prox(prob, masks, step_size, w0,
                                  eval_every=eval_every, degrade=degrade)
        return w, tr, 1
    w, tr = _traced_call("runner:sharded_prox", _sharded_run,
                         _visible_cards(ndev), "prox", prob, masks,
                         step_size, w0, h="l1", eval_every=eval_every,
                         degrade=degrade)
    return w, tr, ndev


def sharded_scan_async(prob: EncodedProblem, workers, staleness, step_size,
                       w0, buffer_size: int, h: str = "l2",
                       eval_every: int = 1):
    """``batched_scan_async`` placed like ``sharded_scan_gd``: the event
    streams split with their realizations."""
    ndev = trials_device_count(len(workers), prob.device)
    if ndev == 1:
        w, tr = batched_scan_async(prob, workers, staleness, step_size, w0,
                                   buffer_size, h=h, eval_every=eval_every)
        return w, tr, 1
    w, tr = _traced_call("runner:sharded_async", _sharded_run,
                         _visible_cards(ndev), "async", prob, workers,
                         staleness, step_size, w0, buffer_size, h,
                         eval_every)
    return w, tr, ndev
