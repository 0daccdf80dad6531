"""CUDA graphs of the port's device loops: a block captured once, replayed.

The reference runs each of its loops (the runners' step loops, the model
zoo's recurrences) as one ``lax.scan`` that XLA compiles into one device
program.  The port runs such a loop as **blocks** over static buffers
and, on a card, captures a block into a CUDA graph and replays it, so the
host enqueues a few calls a block rather than every op of every step.

The capture itself (``_capture``, ``_Replay``, ``_counted``) serves four
callers.  The runners (``runtime/runners.py``) capture a graph a run.
``scan`` (the sLSTM token loop, the mLSTM and Mamba chunk loops and the
attention's KV chunk loop in ``models/``) keeps one graph a **block
shape** for the life of the process, keyed by the loop's name, its
device, the block length, the static buffers' shapes and dtypes and the
block's Python constants (``static``: a window, a soft-cap, causality),
so two layers of equal shapes that mask differently never share a graph:
one capture serves every layer of that shape and constants and every
later call.  The decoder (``models/decoder.py``) captures one decode step
and the stepper (``train/stepper.py``) one coded train step, and each
registers itself (``hold``).  ``clear()`` drops the cached graphs, the
held decoders' and steppers' graphs and their memory pools.

``scan`` never bakes a weight into a graph: the weights a block reads
(``consts``) are copied into its static buffers at the start of every
call that replays, the carried state before the first replay, and each
block's inputs before its replay; each replay's outputs are copied out.
A capture happens only where it can: every tensor of the loop on a CUDA
card, none requiring grad, no functorch transform active (the train
step's ``torch.func.grad``), no ``TorchDispatchMode`` active (the dry
run's ``FlopCounterMode`` on the meta device), ``capturing(False)`` not
in force, and no capture already under way on the current stream: a
``scan`` reached while an outer graph is being captured (the KV loop of
the decoder's step over a long cache) runs its blocks eagerly, so the
outer graph records them inline; so does one reached under the train
step's ``torch.func.grad`` and ``vmap``, so the stepper's graph holds
every loop's forward and backward.
Elsewhere (the CPU, the meta device, training) the same block function
runs eagerly, block by block, on the loop's own tensors, so the CPU tests
run the code that the card captures.  An eager block takes its inputs
contiguous, as a replay finds them in the static buffers: a product that
folds a (B, c, ...) block into one matrix when it is contiguous and runs
a batched product when it is a strided slice (``torch.matmul``) rounds
otherwise on the card, and captured must equal eager bit for bit.  A capture that fails raises,
naming the loop and the block; nothing falls back to the eager loop.

Code inside a block must not read a value back to the host, synchronize,
or allocate outside PyTorch's allocator: a replay repeats what its capture
recorded.

The dry run (``launch.roofline``) counts a loop as one body times its trip
count, as the reference's HLO analysis multiplies a while body: under
``counting`` a ``scan`` over meta tensors runs a run of like blocks once
and hands it, with the number of blocks it stands for, to the counters.
"""
from __future__ import annotations

import contextlib
import time
import weakref

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from repro_torch.kernels import _build
from repro_torch.obs.trace import span as _obs_span

__all__ = ["scan", "clear", "capturing", "cached", "pool_bytes", "hold",
           "counting"]


def _counted(fn) -> dict:
    """Run ``fn()``; return the launches it counted
    (``kernels._build.launches``) and take them back out of the counts."""
    before = _build.launches.copy()
    try:
        fn()
    finally:
        counted = dict(_build.launches - before)
        _build.launches.clear()
        _build.launches.update(before)
    return counted


class _Replay:
    """A captured block: ``replay()`` launches the graph on the current
    stream of its card and adds the launches its capture counted, once.
    ``pool_bytes``: what the card's reserved memory grew by during the
    capture, the segments of the graph's own memory pool."""

    def __init__(self, graph, counted: dict, pool_bytes: int = 0):
        self.graph = graph
        self.counted = counted
        self.pool_bytes = pool_bytes

    def replay(self) -> None:
        self.graph.replay()
        _build.launches.update(self.counted)


def _capture(block, where: str, device: torch.device,
             span: str = "runner:capture") -> _Replay:
    """Capture ``block()`` into a CUDA graph on a side stream of
    ``device``, with its own memory pool; the capture executes nothing.
    The general pool's cached blocks go back to the card first: a capture
    cannot free them while it is under way, so a large cache left by
    earlier work (a train step's warm-up, an encode) would starve the
    graph's pool.  Its host seconds add to
    ``kernels._build.capture_seconds`` and it is the obs span ``span``.
    Raises, naming ``where``, if the capture fails."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()

    def run():
        with _obs_span(span), torch.cuda.stream(torch.cuda.Stream(device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                block()
            finally:
                graph.capture_end()
    try:
        counted = _counted(run)
    except Exception as exc:
        raise RuntimeError(f"{where}: capturing the block into a CUDA graph "
                           f"on {device} failed: {exc}") from exc
    finally:
        _build.capture_seconds += time.perf_counter() - t0
        _build.captures += 1
    return _Replay(graph, counted,
                   torch.cuda.memory_reserved(device) - reserved)


# -- the model zoo's loops: a graph a block shape -----------------------------

class _Loop:
    """A block shape of a ``scan``: static buffers for the weights, one
    block's inputs and the carried state, and once captured, the graph
    that reads them, writes the new state back into the carry buffers and
    leaves the block's outputs in ``ys`` (tensors of its pool)."""

    def __init__(self, consts, xs, carry):
        def static(ts):
            return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         for t in ts)
        self.consts, self.xs, self.carry = static(consts), static(xs), \
            static(carry)
        self.ys: tuple = ()
        self.graph: _Replay | None = None

    def capture(self, block, where: str, device: torch.device) -> None:
        def body():
            ys, carry = block(self.consts, self.xs, self.carry)
            for buf, t in zip(self.carry, carry):
                buf.copy_(t)
            self.ys = tuple(ys)
        self.graph = _capture(body, where, device, span="scan:capture")


# (name, device, block length, static shapes and dtypes, static) -> _Loop
_CACHE: dict[tuple, _Loop] = {}
# objects holding graphs of their own (the decoders): ``release()`` drops them
_HELD: "weakref.WeakSet" = weakref.WeakSet()
_capture_on = True


@contextlib.contextmanager
def capturing(on: bool):
    """Within, ``scan`` captures (``True``, the default) or runs every
    block eagerly, on a card too (``False``: the A/B checks of
    ``chip_smoke.py`` and the tests)."""
    global _capture_on
    was, _capture_on = _capture_on, on
    try:
        yield
    finally:
        _capture_on = was


def hold(obj) -> None:
    """Register ``obj`` (it has ``release()``, which drops its graphs) for
    ``clear()``; the registry keeps no reference that would keep it alive."""
    _HELD.add(obj)


def clear() -> None:
    """Drop every cached block shape, its graph and its memory pool, and
    every held decoder's and stepper's graph."""
    _CACHE.clear()
    for obj in list(_HELD):
        obj.release()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def cached() -> list[tuple]:
    """The keys of the captured block shapes (one a capture)."""
    return [key for key, loop in _CACHE.items() if loop.graph is not None]


def pool_bytes() -> dict[tuple, int]:
    """The memory pool of each captured block shape (``_Replay``), by key."""
    return {key: loop.graph.pool_bytes for key, loop in _CACHE.items()
            if loop.graph is not None}


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _stream_capturing() -> bool:
    """Whether a CUDA graph is being captured on the current stream."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _capturable(tensors) -> bool:
    """Whether a loop over ``tensors`` may run as captured blocks."""
    if not _capture_on or not all(_on_card(t) for t in tensors):
        return False
    if any(t.requires_grad for t in tensors):
        return False
    return not (torch._C._are_functorch_transforms_active()
                or is_in_torch_dispatch_mode() or _stream_capturing())


def _key(name: str, c: int, static: tuple, *groups) -> tuple:
    dev = groups[0][0].device
    return (name, str(dev), c) + tuple(
        tuple((tuple(t.shape), t.dtype) for t in g) for g in groups) + (
        tuple(static),)


# -- counting: a loop on the meta device as one body times its trip count ---

_COUNT: list = []        # the hooks of the ``counting`` contexts, innermost last


@contextlib.contextmanager
def counting(hook):
    """Within, ``scan`` over meta tensors runs a run of like blocks once:
    ``hook(run, times, alone)`` gets ``run`` (runs the block in its place
    in the trace and returns its ``(ys, carry)``; ``hook`` returns that),
    ``times`` (the number of the loop's blocks it stands for) and
    ``alone``: where the block has a backward pass (grad mode, an input
    that requires grad), a function that runs a copy of the block by
    itself on fresh meta tensors like its inputs, forward and backward,
    for counters that see the backward pass, which the block in its
    place has once; else ``None``.  Blocks are like where they have the
    same length and their carry comes in with the same ``requires_grad``
    and strides; the first block (its carry the loop's initial state),
    the block after it where the carry changed, the last full block (its
    carry leaves the loop) and a shorter last block run on their own, so
    every count equals the whole loop's.  Entered by the dry run's
    counters (``launch.roofline``) and their tests only."""
    _COUNT.append(hook)
    try:
        yield
    finally:
        _COUNT.pop()


def _alone(block, consts, xs, carry) -> None:
    """``block`` run by itself on fresh meta tensors of its inputs' shapes,
    strides and dtypes, forward and backward (``torch.func.vjp``, a
    cotangent for every output that requires grad)."""
    ins = (*consts, *xs, *carry)
    fresh = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                 device="meta") for t in ins]
    diff = [i for i, t in enumerate(ins) if t.requires_grad]
    n1, n2 = len(consts), len(consts) + len(xs)

    def run(*d):
        args = list(fresh)
        for i, t in zip(diff, d):
            args[i] = t
        ys, cy = block(tuple(args[:n1]), tuple(args[n1:n2]),
                       tuple(args[n2:]))
        return (*ys, *cy)

    outs, pull = torch.func.vjp(run, *(fresh[i] for i in diff))
    pull(tuple(torch.empty_like(o) for o in outs))


def _counted_scan(block, consts, xs, held: list, length: int, c: int,
                  hook):
    """``scan``'s blocks on meta under ``counting``: a block whose carry
    comes in as the block before's did stands for every full block up to
    the last full one.  ``held``: a list holding the initial carry."""
    carry = held.pop()
    n_full = length // c
    ys, before, b = [], None, 0
    while b * c < length:
        # the block's inputs are made inside it, as the eager loop makes
        # them, so they are its temporaries
        xb = lambda t0=b * c: tuple(  # noqa: E731
            x[:, t0:t0 + c].contiguous() for x in xs)
        now = tuple((t.requires_grad, t.stride()) for t in carry)
        times = 1
        if b < n_full and now == before and n_full - 1 - b >= 2:
            times = n_full - 1 - b
        before = now
        backward = torch.is_grad_enabled() and any(
            t.requires_grad for t in (*consts, *xs, *carry))
        y, carry = hook(
            lambda xb=xb, cy=carry: block(consts, xb(), cy), times,
            (lambda xb=xb, cy=carry: _alone(block, consts, xb(), cy))
            if backward else None)
        ys.extend([tuple(y)] * times)
        b += times
    return ys, tuple(carry)


def scan(name: str, block, consts: tuple, xs: tuple, carry: tuple, *,
         length: int, c: int, static: tuple, per_position: bool = False):
    """Run ``block(consts, xs_block, carry) -> (ys_block, carry)`` over
    positions [0, length) of dim 1 of every tensor in ``xs``, in blocks of
    c positions (a shorter last block when c does not divide ``length``).
    Returns (the list of each block's ``ys``, the last carry).

    Its callers: the sLSTM token loop and the mLSTM chunk loop
    (``models/xlstm.py``), the Mamba chunk loop (``models/mamba.py``) and
    the attention's KV chunk loop (``models/attention.py``), reached by
    the serve path (captured here a block shape), the decoder's captured
    step and the train step under ``train.stepper.Stepper``'s capture
    (both recorded inline: eager blocks inside the outer capture).

    ``static`` holds every Python value ``block`` closes over that changes
    what it computes (a mask's window, a soft-cap): it is part of the
    graph cache's key, so ``()`` says the block depends on its tensors
    alone.

    On a card (module docstring) the first call for a block shape runs its
    first full block eagerly (the warm-up: cuBLAS's handle and workspace
    are set up outside any capture) and captures the shape at its next
    full block, in this call or the next; from then on every full block
    is a replay.  A shorter last block runs eagerly.

    On the meta device under ``counting`` (the dry run) like blocks run
    once, each standing for its run of blocks, and the returned list
    holds each block's ``ys`` once for every block it stands for.
    ``per_position``: ``block`` computes one position after another from
    the carry, so every c computes the same (the sLSTM token loop); there
    the counted loop's blocks are one position, the reference's scan
    body, and its trace costs one position's operators, not c's."""
    if _COUNT and all(t.is_meta for t in (*consts, *xs, *carry)):
        # handed over in a list so that this frame keeps no reference to
        # the initial carry, as the eager loop drops it after block 0
        held = [carry]
        del carry
        return _counted_scan(block, consts, xs, held, length,
                             1 if per_position else c, _COUNT[-1])
    capture = _capturable((*consts, *xs, *carry))
    loop = None
    ys = []
    in_graph = False      # the carry lives in loop.carry
    for b, t0 in enumerate(range(0, length, c)):
        n = min(c, length - t0)
        xb = tuple(x[:, t0:t0 + n] for x in xs)
        if capture and n == c and loop is None:
            key = _key(name, c, static, consts, xb, carry)
            loop = _CACHE.get(key)
            if loop is None:         # first sight: this block is the warm-up
                _CACHE[key] = _Loop(consts, xb, carry)
            else:
                for buf, t in zip(loop.consts, consts):
                    buf.copy_(t)
        if loop is not None and n == c:
            if loop.graph is None:
                loop.capture(block, f"{name}, block {b} (positions {t0}-"
                             f"{t0 + c - 1} of {length})", xb[0].device)
            if not in_graph:
                for buf, t in zip(loop.carry, carry):
                    buf.copy_(t)
                in_graph = True
            for buf, t in zip(loop.xs, xb):
                buf.copy_(t)
            loop.graph.replay()
            ys.append(tuple(t.clone() for t in loop.ys))
        else:
            if in_graph:
                carry, in_graph = loop.carry, False
            y, carry = block(consts, tuple(t.contiguous() for t in xb),
                             carry)
            ys.append(tuple(y))
    if in_graph:
        carry = tuple(t.clone() for t in loop.carry)
    return ys, tuple(carry)
