"""Device-resident iteration loops: encoded GD and ISTA, encoded BCD and
asynchronous stale-gradient SGD.

Port of ``src/repro/runtime/runners.py``.  The
reference's ``lax.scan`` becomes a Python loop over T steps on the device:
the (R, T, m) mask stack is loaded once, the objective trace is
preallocated on the device, and nothing inside the loop reads a value back
to the host (no ``.item()``, no sync); callers copy the results to the host
once, at the end.

Every step is one call of the fused masked-gradient kernel
(``kernels/fused_step.py``): the CUDA kernel for a problem on the card,
its plain PyTorch version for a problem on the CPU.  There is no switch:
the problem's device decides.

One implementation serves the single and the batched runners: a single
run is the batched loop at R = 1, so ``batched_scan_*`` at R = 1 equals
``scan_*`` bit for bit, and since neither the kernel's sums nor the
per-realization objective depend on the batch, realization r of a
batched (or cell-batched) run equals the same realization run alone.
``eval_every=s`` records f after steps s, 2s, ... (every s-th entry of the
dense trace), as the reference does.

The BCD and async runners make plain products (``torch.einsum`` /
``torch.matmul`` in full float32), as the reference leaves them to XLA; no
kernel of the port is on their path.  Their batched forms run each
realization's products on its own, one realization after the other within
a step, so a realization never depends on the batch around it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.data_parallel import (EncodedProblem,
                                            original_objective, prox_l1)
from repro_torch.core.model_parallel import LiftedProblem
from repro_torch.device import full_f32_matmul
from repro_torch.kernels.fused_step import fused_masked_gradient
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


def _runner_name(base: str, prob: EncodedProblem) -> str:
    """Obs span name; runs on the card go through the fused kernel and say
    so, as the reference's fused path does."""
    return base + ":fused" if prob.device.type == "cuda" else base


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


def _run(prob: EncodedProblem, masks, step_size, w0, *, kind: str, h: str,
         eval_every: int, degrade):
    """The T-step loop over R realizations: masks (R, T, m), w0 (R, p).
    Returns (W (R, p), trace (R, T // eval_every)) on the problem's
    device."""
    dev = prob.device
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    W = torch.as_tensor(w0, dtype=torch.float32, device=dev)
    R, T, _ = masks.shape
    if eval_every < 1 or T % eval_every:
        raise ValueError(f"eval_every={eval_every} must be a positive "
                         f"divisor of the {T}-step schedule")
    step = _step_vector(step_size, R, dev)[:, None]
    # step-major copy: masks_t[t] is one contiguous (R, m) kernel operand
    masks_t = masks.transpose(0, 1).contiguous()
    trace = torch.empty((R, T // eval_every), dtype=torch.float32,
                        device=dev)
    h_obj = "l1" if kind == "prox" else h
    thresh = step * prob.lam
    g_prev = torch.zeros_like(W) if degrade is not None else None
    for t in range(T):
        mask = masks_t[t]
        g = fused_masked_gradient(prob.SX, prob.Sy, W, mask, n=prob.n,
                                  beta=prob.beta)
        if kind == "gd" and h == "l2":
            g = g + prob.lam * W
        if degrade is not None:
            # below k_min survivors reuse the last gradient at shrink x its
            # scale; the shrunk gradient re-enters the carry, so
            # consecutive sub-k rounds decay geometrically
            _, k_min, shrink = degrade
            subk = mask.sum(-1, keepdim=True) < k_min
            g = torch.where(subk, shrink * g_prev, g)
            g_prev = g
        if kind == "gd":
            W = W - step * g
        else:
            W = prox_l1(W - step * g, thresh)
        if (t + 1) % eval_every == 0:
            trace[:, (t + 1) // eval_every - 1] = _objectives(prob, W, h_obj)
    return W, trace


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
    return _traced_call(_runner_name("runner:gd", prob), _single, "gd", prob,
                        masks, step_size, w0, h=h, eval_every=eval_every,
                        degrade=_degrade_tuple(degrade))


def scan_prox(prob: EncodedProblem, masks, step_size, w0,
              eval_every: int = 1, degrade=None):
    """Encoded proximal gradient (ISTA, l1) over a mask schedule."""
    return _traced_call(_runner_name("runner:prox", prob), _single, "prox",
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
    return _traced_call(_runner_name(name, prob), _run, prob, masks,
                        step_size, w0, kind="gd", h=h, eval_every=eval_every,
                        degrade=_degrade_tuple(degrade))


def batched_scan_prox(prob: EncodedProblem, masks, step_size, w0,
                      eval_every: int = 1, degrade=None):
    """R realizations of encoded ISTA in one device loop (see
    ``batched_scan_gd`` for the axis and eval_every conventions)."""
    R = len(masks)
    name = "runner:prox" if R == 1 else "runner:batched_prox"
    return _traced_call(_runner_name(name, prob), _run, prob, masks,
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
def _scan_bcd(prob: LiftedProblem, masks, step_size, v0):
    dev = prob.device
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    v = torch.as_tensor(v0, dtype=torch.float32, device=dev)
    T = masks.shape[0]
    trace = torch.empty(T + 1, dtype=torch.float32, device=dev)
    for t in range(T):
        v, z = _bcd_step(prob.XS, v, masks[t], step_size, prob.phi_grad)
        trace[t] = prob.phi_val(z)
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
def _batched_bcd(prob: LiftedProblem, masks, step_size, v0, eval_every):
    dev = prob.device
    masks = torch.as_tensor(masks, dtype=torch.float32, device=dev)
    V = torch.as_tensor(v0, dtype=torch.float32, device=dev).clone()
    R, T, _ = masks.shape
    if eval_every < 1 or T % eval_every:
        raise ValueError(f"eval_every={eval_every} must be a positive "
                         f"divisor of the {T}-step schedule")
    trace = torch.empty((R, T // eval_every), dtype=torch.float32,
                        device=dev)
    for t in range(T):
        for q in range(R):
            V[q] = _bcd_step(prob.XS, V[q], masks[q, t], step_size,
                             prob.phi_grad)[0]
        if (t + 1) % eval_every == 0:
            for q in range(R):
                trace[q, (t + 1) // eval_every - 1] = prob.phi_val(
                    _activations(prob.XS, V[q]))
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

@full_f32_matmul
def _async_run(prob: EncodedProblem, workers, staleness, step_size, w0,
               buffer_size: int, h: str, eval_every: int):
    """One realization's event stream.  The ring buffer of the last
    ``buffer_size`` iterates lives on the device; update u reads slot
    (u - tau_u) mod B, the iterate worker i_u last read (head == u before
    update u).  Worker ids and staleness come from the host engine, so the
    slots are host integers and nothing in the loop reads the device."""
    dev = prob.device
    workers = np.asarray(torch.as_tensor(workers).cpu(), dtype=np.int64)
    staleness = np.asarray(torch.as_tensor(staleness).cpu(), dtype=np.int64)
    U = workers.shape[0]
    if eval_every < 1 or U % eval_every:
        raise ValueError(f"eval_every={eval_every} must be a positive "
                         f"divisor of the {U}-update stream")
    m = prob.SX.shape[0]
    scale = m / (prob.n * prob.beta)
    w = torch.as_tensor(w0, dtype=torch.float32, device=dev)
    buf = w[None].repeat(buffer_size, 1)
    trace = torch.empty(U // eval_every, dtype=torch.float32, device=dev)
    for u in range(U):
        i = int(workers[u])
        w_stale = buf[(u - int(staleness[u])) % buffer_size]
        SXi = prob.SX[i]                       # (r, p) block of worker i
        r = torch.matmul(SXi, w_stale) - prob.Sy[i]
        g = torch.matmul(SXi.T, r) * scale
        if h == "l2":
            g = g + prob.lam * w_stale
        w = w - step_size * g
        buf[(u + 1) % buffer_size] = w
        if (u + 1) % eval_every == 0:
            trace[(u + 1) // eval_every - 1] = original_objective(prob, w,
                                                                  h=h)
    return w, trace


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
    return _traced_call("runner:async", _async_run, prob, workers, staleness,
                        step_size, w0, buffer_size, h, eval_every)


def _batched_async(prob, workers, staleness, step_size, w0, buffer_size, h,
                   eval_every):
    runs = [_async_run(prob, workers[q], staleness[q], step_size, w0[q],
                       buffer_size, h, eval_every)
            for q in range(len(workers))]
    return (torch.stack([w for w, _ in runs]),
            torch.stack([tr for _, tr in runs]))


def batched_scan_async(prob: EncodedProblem, workers, staleness, step_size,
                       w0, buffer_size: int, h: str = "l2",
                       eval_every: int = 1):
    """R realizations of async stale-gradient SGD.

    workers/staleness: (R, U) stacked event streams; w0: (R, p).  Returns
    (w (R, p), trace (R, U // eval_every)).  Each realization is its own
    event loop (the event streams differ), so realization r equals
    ``scan_async`` on its stream bit for bit.
    """
    name = "runner:async" if len(workers) == 1 else "runner:batched_async"
    return _traced_call(name, _batched_async, prob, workers, staleness,
                        step_size, w0, buffer_size, h, eval_every)


def trials_device_count(trials: int) -> int:
    """Devices the realization axis is spread over.  The port runs every
    realization on the problem's one device, so this is 1: the reference's
    own answer on one device (spreading realizations over several cards is
    not ported yet)."""
    return 1


def sharded_scan_gd(prob: EncodedProblem, masks, step_size, w0,
                    h: str = "l2", eval_every: int = 1, degrade=None):
    """``batched_scan_gd`` with the realization axis placed over the
    devices; returns (w, trace, ndev), ndev == 1 being the batched
    fallback."""
    w, tr = batched_scan_gd(prob, masks, step_size, w0, h=h,
                            eval_every=eval_every, degrade=degrade)
    return w, tr, trials_device_count(len(masks))


def sharded_scan_prox(prob: EncodedProblem, masks, step_size, w0,
                      eval_every: int = 1, degrade=None):
    """``batched_scan_prox`` placed like ``sharded_scan_gd``."""
    w, tr = batched_scan_prox(prob, masks, step_size, w0,
                              eval_every=eval_every, degrade=degrade)
    return w, tr, trials_device_count(len(masks))


def sharded_scan_async(prob: EncodedProblem, workers, staleness, step_size,
                       w0, buffer_size: int, h: str = "l2",
                       eval_every: int = 1):
    """``batched_scan_async`` placed like ``sharded_scan_gd``."""
    w, tr = batched_scan_async(prob, workers, staleness, step_size, w0,
                               buffer_size, h=h, eval_every=eval_every)
    return w, tr, trials_device_count(len(workers))
