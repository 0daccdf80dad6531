"""repro_torch.obs — structured tracing, straggler metrics, profiling hooks
(counterpart of ``repro.obs``, with the same public names).

  * :mod:`.trace`    — :class:`TraceRecorder`: per-iteration straggler
    timelines from the ``ClusterEngine`` plus host-clock phase spans,
    exported as JSONL and Chrome/Perfetto ``trace_event`` JSON;
  * :mod:`.metrics`  — counter/gauge/histogram registry and the per-cell
    summarizers (miss-rate, active-set distribution, step-latency
    percentiles, staleness histogram and clamp counts);
  * :mod:`.timing`   — ``block`` / ``time_us`` (CUDA events on the card)
    and :class:`CompileWatch`, which splits the kernels' ``nvcc`` build
    out of a region's time;
  * :mod:`.profile`  — opt-in ``torch.profiler`` capture and
    device-memory high-water marks;
  * :mod:`.sketch`   — O(1)-memory streaming estimators (P² quantiles,
    EWMA, per-worker :class:`DelayTailEstimator`);
  * :mod:`.runstore` — indexed run-manifest store (spec hash, git sha,
    backend and device, artifact paths) every ``execute`` records to;
  * ``python -m repro_torch.obs.diff`` — cross-run regression gate;
  * ``python -m repro_torch.obs.report`` — text straggler-timeline and
    phase-breakdown reports from a saved trace, plus ``--html``.

With no active recorder every hook is a single ``is None`` check.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      async_metrics, cell_summary, clamp_async_event,
                      fault_metrics, schedule_metrics)
from .profile import memory_high_water, memory_stats, profile_region
from .runstore import (RunStore, begin_experiment, completed_cells,
                       default_store, finish_experiment, provenance,
                       record_cell, record_experiment, runstore_enabled,
                       spec_hash)
from .sketch import DelayTailEstimator, Ewma, P2Quantile, QuantileSketch
from .timing import CompileWatch, block, emit, time_us
from .trace import TraceEvent, TraceRecorder, current_recorder, span

__all__ = [
    "TraceEvent", "TraceRecorder", "current_recorder", "span",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "schedule_metrics", "async_metrics", "fault_metrics", "cell_summary",
    "clamp_async_event",
    "P2Quantile", "QuantileSketch", "Ewma", "DelayTailEstimator",
    "RunStore", "default_store", "runstore_enabled", "provenance",
    "spec_hash", "record_experiment", "begin_experiment",
    "finish_experiment", "record_cell", "completed_cells",
    "CompileWatch", "block", "time_us", "emit",
    "profile_region", "memory_stats", "memory_high_water",
]
