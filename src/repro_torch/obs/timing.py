"""The one clock and blocking discipline of the port (counterpart of
``repro.obs.timing``, rewritten on torch).

  * :func:`block`      — wait for the CUDA device of EVERY tensor leaf of
    an output (waiting for one leaf's device only lets work on another
    overlap the clock and under-reports);
  * :func:`time_us`    — mean microseconds per call: CUDA events when the
    calls produce tensors on the card, else the host clock with a
    :func:`block` inside the timed loop;
  * :class:`CompileWatch` — splits the kernels' build and first load
    (``kernels._build.load_library``: the ``nvcc`` builds and the
    library's load) out of a timed region, so ``execute_s`` never silently
    includes a build, and counts the builds.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels import _build

__all__ = ["block", "time_us", "emit", "CompileWatch"]


def _leaves(out):
    """The tensor leaves of nested tuples, lists and dicts."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _leaves(x)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _leaves(x)


def _cuda_devices(out) -> list:
    return sorted({t.device.index or 0 for t in _leaves(out) if t.is_cuda})


def block(out):
    """Wait for the CUDA device of every tensor leaf of ``out`` and return
    it; a no-op for host values."""
    for index in _cuda_devices(out):
        torch.cuda.synchronize(index)
    return out


def time_us(fn, *args, iters: int = 5, warmup: int = 1, **kw) -> float:
    """Mean microseconds per call.

    When the last warm-up call returned tensors on the card, CUDA events on
    that device's current stream bracket the ``iters`` calls (the device's
    time, launch gaps included); otherwise the host clock does, with a
    :func:`block` inside the timed loop (waiting only after the last call
    would let earlier calls overlap the clock).  ``warmup=0`` always takes
    the host clock."""
    devices: list = []
    for _ in range(warmup):
        devices = _cuda_devices(block(fn(*args, **kw)))
    if devices:
        with torch.cuda.device(devices[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(*args, **kw)
            end.record()
            block(out)
            end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        block(fn(*args, **kw))
    return (time.perf_counter() - t0) / iters * 1e6


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """One benchmark CSV line on stdout."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


class CompileWatch:
    """Measure a region, splitting the kernels' build time from run time.

    ``with CompileWatch() as cw: ...`` leaves ``cw.total_s`` (wall),
    ``cw.compile_s`` (host seconds inside the region of the kernel
    library's first load, the ``nvcc`` builds, the link and the load, and
    of the CUDA graph captures (``repro_torch.graphs``), the port's
    counterpart of the reference's trace and compile of its ``lax.scan``),
    ``cw.execute_s`` (the remainder) and ``cw.compiles`` (``nvcc`` builds
    inside the region; 0 when the library was built or loaded before).
    The split comes from the loader's and the capture tool's counters
    (``kernels._build.build_seconds``, ``builds`` and
    ``capture_seconds``), so no warm-up call is needed.  On the CPU
    nothing is captured and the captures add 0.
    """

    def __enter__(self) -> "CompileWatch":
        self._s0 = _build.build_seconds + _build.capture_seconds
        self._n0 = _build.builds
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total_s = time.perf_counter() - self._t0
        spent = _build.build_seconds + _build.capture_seconds - self._s0
        self.compile_s = min(max(spent, 0.0), self.total_s)
        self.compiles = _build.builds - self._n0
        self.execute_s = max(self.total_s - self.compile_s, 0.0)
