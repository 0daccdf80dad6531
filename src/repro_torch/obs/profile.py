"""Opt-in profiling hooks: ``torch.profiler`` capture and device-memory
peaks (counterpart of ``repro.obs.profile``, rewritten on torch).

  * :func:`profile_region` — context manager capturing a ``torch.profiler``
    trace of the block, exported as a Chrome trace into a per-cell logdir
    (open it in https://ui.perfetto.dev or ``chrome://tracing``);
  * :func:`memory_stats`    — per-device byte counters from
    ``torch.cuda.memory_stats``, normalized to ``{device: {bytes_in_use,
    peak_bytes_in_use, bytes_limit}}``;
  * :func:`memory_high_water` — the max ``torch.cuda.max_memory_allocated``
    across the devices, the single gauge attached to cell records.

Each takes ``device``: unset it means CUDA (and raises without a card).
On the CPU, a device the caller chose, the memory hooks return what the
reference returns on a backend without device memory (``{}`` and
``None``), and the profiler records host activity only.
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.device import resolve_device

__all__ = ["profile_region", "memory_stats", "memory_high_water"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_region(logdir: str | None, device=None):
    """Capture a ``torch.profiler`` trace of the block into
    ``<logdir>/trace.json`` (``None`` makes this a plain no-op).  The
    card's kernels are captured when ``device`` is CUDA."""
    if not logdir:
        yield
        return
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _cuda_indices(device) -> list:
    dev = resolve_device(device)
    if dev.type != "cuda":
        return []
    if dev.index is not None:
        return [dev.index]
    return list(range(torch.cuda.device_count()))


def memory_stats(device=None) -> dict:
    """``{device_str: {counter: bytes}}`` for ``device`` (unset: every CUDA
    device); ``{}`` for the CPU."""
    out: dict = {}
    for i in _cuda_indices(device):
        ms = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
        }
    return out


def memory_high_water(device=None) -> int | None:
    """Max peak bytes allocated across ``device``'s CUDA devices (unset:
    every one), ``None`` for the CPU."""
    indices = _cuda_indices(device)
    if not indices:
        return None
    return max(int(torch.cuda.max_memory_allocated(i)) for i in indices)
