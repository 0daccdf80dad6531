"""Lightweight metrics: counters/gauges/histograms + per-cell summaries.

Two layers (DESIGN.md §11):

  * a tiny process-local :class:`MetricsRegistry` (counter / gauge /
    histogram) for code that wants to count things as it goes — no
    background threads, no exporters, ``summary()`` renders the whole
    registry as a JSON-safe dict;
  * pure summarizers over the engine's realized artifacts —
    :func:`schedule_metrics` (per-worker miss-rate, active-set-size
    distribution, p50/p95/p99 step latency) and :func:`async_metrics`
    (staleness histogram, drop/clamp counts) — which
    ``repro_torch.experiments.execute`` attaches to the canonical record as the
    ``obs`` key and ``write_metrics_csv`` flattens to the per-cell CSV.

Metric names are stable identifiers (the report CLI and tests key on
them): ``miss_rate``, ``active_size``, ``step_latency_s``, ``staleness``,
``staleness_clamped``, ``dropped``, ``delay_tail``, ``compile_s``,
``execute_s``, ``compiles``.
"""
from __future__ import annotations

import numpy as np

from .sketch import DelayTailEstimator, QuantileSketch
# the ONE clamp rule, shared with the trace expander
from .trace import clamp_async_event

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "schedule_metrics", "async_metrics", "fault_metrics",
    "clamp_async_event", "cell_summary",
]


class Counter:
    """A monotonically increasing count."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A last-write-wins scalar."""

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """A bounded-memory histogram behind the historical raw-sample API.

    Up to ``buffer_size`` observations everything is exact (raw samples,
    ``np.percentile``) — a 200-step cell keeps every sample.  Beyond that
    the buffer seeds P² quantile markers (:class:`repro_torch.obs.sketch.QuantileSketch`) and raw samples
    are dropped, so streaming workloads can observe forever at O(1)
    memory (the ``summary()`` then carries ``approx: True``).  The
    integer-bucket ``counts()`` view is kept exactly in a dict — its size
    is the number of DISTINCT integer values (worker counts, staleness
    bounds: small by construction), capped at ``max_buckets``.
    """

    MAX_BUCKETS = 4096

    def __init__(self, percentiles=(50, 95, 99), buffer_size: int = 4096,
                 max_buckets: int = MAX_BUCKETS):
        self._sketch = QuantileSketch(percentiles, buffer_size)
        self._counts: dict | None = {}
        self._max_buckets = int(max_buckets)

    def observe(self, v) -> None:
        self.observe_many([v])

    def observe_many(self, vs) -> None:
        a = np.asarray(vs, dtype=float).ravel()
        self._sketch.observe_many(a)
        if self._counts is not None:
            ints, cnts = np.unique(a.astype(int), return_counts=True)
            for v, c in zip(ints.tolist(), cnts.tolist()):
                self._counts[v] = self._counts.get(v, 0) + c
            if len(self._counts) > self._max_buckets:
                self._counts = None        # too many distinct values

    @property
    def count(self) -> int:
        return self._sketch.count

    @property
    def spilled(self) -> bool:
        """True once raw samples were folded into the P² sketch."""
        return self._sketch.spilled

    def summary(self, percentiles=(50, 95, 99)) -> dict:
        if self.count == 0:
            return {"count": 0}
        if not self._sketch.spilled:
            s = self._sketch.summary()
            for q in tuple(s):
                if isinstance(q, str) and q.startswith("p"):
                    del s[q]
            for q in percentiles:
                s[f"p{q}"] = self._sketch.quantile(q)
            return s
        if tuple(percentiles) != self._sketch.percentiles:
            raise ValueError(
                f"histogram spilled tracking {self._sketch.percentiles}; "
                f"cannot produce {tuple(percentiles)}")
        return self._sketch.summary()

    def counts(self) -> dict:
        """Integer-bucket view ``{str(value): occurrences}`` — the natural
        rendering for discrete quantities (active-set sizes, staleness);
        ``{}`` when the stream exceeded ``max_buckets`` distinct values."""
        if self._counts is None:
            return {}
        return {str(v): int(c) for v, c in sorted(self._counts.items())}


class MetricsRegistry:
    """Name -> metric map with one-line accessors; ``summary()`` is the
    JSON-safe snapshot every consumer (records, report CLI) reads."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric '{name}' is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def summary(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = m.summary()
            else:
                out[name] = m.value
        return out


# ---------------------------------------------------------------------------
# Engine-artifact summarizers
# ---------------------------------------------------------------------------

def fault_metrics(schedules, *, k: int | None = None) -> dict:
    """Summarize the fault side of realized ``Schedule``s: crash count,
    blackout seconds, per-kind failed-entry fractions and — given the
    decode threshold ``k`` — the fraction of iterations that committed
    below it (``subk_fraction``).  ``{}`` when no schedule carries a
    ``failed`` array (the delay-only cluster)."""
    from repro_torch.runtime.faults import (FAULT_BLACKOUT, FAULT_CORRUPT,
                                            FAULT_CRASHED)
    rows = [s for s in schedules
            if getattr(s, "failed", None) is not None]
    if not rows:
        return {}
    failed = np.concatenate([np.asarray(s.failed) for s in rows], axis=0)
    crashes = blackouts = blackout_s = 0
    for s in rows:
        for fe in getattr(s, "fault_events", ()):
            if fe.kind == "crash":
                crashes += 1
            elif fe.kind == "blackout":
                blackouts += 1
                blackout_s += float(fe.duration)
    total = float(failed.size) or 1.0
    out = {
        "crashes": int(crashes),
        "blackouts": int(blackouts),
        "blackout_s": float(blackout_s),
        "crashed_frac": float((failed == FAULT_CRASHED).sum() / total),
        "blackout_frac": float((failed == FAULT_BLACKOUT).sum() / total),
        "corrupt_count": int((failed == FAULT_CORRUPT).sum()),
    }
    if k is not None:
        masks = np.concatenate([np.asarray(s.masks) for s in rows], axis=0)
        out["subk_fraction"] = float(
            (masks.sum(axis=1) < int(k)).mean())
    return out


def schedule_metrics(schedules, *, k: int | None = None) -> dict:
    """Summarize realized synchronous ``Schedule``s (one or many — batched
    cells pass all R realizations, chunked workloads every sub-solve).

    Returns per-worker ``miss_rate`` (fraction of iterations worker i was
    erased), the ``active_size`` distribution, per-iteration
    ``step_latency_s`` (commit-to-commit barrier time) percentiles, and
    the per-worker ``delay_tail`` snapshot (EWMA delay + p50/p95/p99 of
    each worker's arrival latency — the auto-tuner's sensing interface).
    Schedules realized under a fault model additionally carry a ``faults``
    block (:func:`fault_metrics`; ``k`` enables its ``subk_fraction``).
    Schedules whose worker count differs from the first are skipped (a
    matrix cell never mixes cluster sizes).
    """
    schedules = [s for s in schedules if s is not None]
    if not schedules:
        return {}
    m = schedules[0].m
    schedules = [s for s in schedules if s.m == m]
    masks = np.concatenate([np.asarray(s.masks, dtype=float)
                            for s in schedules], axis=0)
    lat = Histogram()
    active = Histogram()
    tail = DelayTailEstimator(m)
    for s in schedules:
        times = np.asarray(s.times, dtype=float)
        lat.observe_many(np.diff(times, prepend=0.0))
        active.observe_many(np.asarray(s.masks).sum(axis=1))
        tail.observe_schedule(s)
    miss = 1.0 - masks.mean(axis=0)
    out = {
        "iterations": int(masks.shape[0]),
        "workers": int(m),
        "miss_rate": [float(x) for x in miss],
        "mean_miss_rate": float(miss.mean()),
        "max_miss_rate": float(miss.max()),
        "active_size": {**active.summary(), "hist": active.counts()},
        "step_latency_s": lat.summary(),
        "delay_tail": tail.snapshot(),
    }
    fm = fault_metrics(schedules, k=k)
    if fm:
        out["faults"] = fm
    return out


def async_metrics(traces) -> dict:
    """Summarize realized ``AsyncTrace``s: staleness histogram, per-arrival
    latency percentiles, dropped-gradient totals, and the count of events
    clamped at the trace boundary (see :func:`clamp_async_event`)."""
    traces = [t for t in traces if t is not None]
    if not traces:
        return {}
    stale = Histogram()
    lat = Histogram()
    tail = DelayTailEstimator(int(traces[0].m))
    dropped = 0
    clamped = 0
    corrupted = 0
    for t in traces:
        corrupted += int(getattr(t, "corrupted", 0))
        staleness = np.asarray(t.staleness, dtype=int)
        reads = np.asarray(t.read_versions, dtype=int)
        U = staleness.shape[0]
        for u in range(U):
            tau, _, was = clamp_async_event(u, int(staleness[u]),
                                            int(reads[u]), U)
            stale.observe(tau)
            clamped += was
        lat.observe_many(np.diff(np.asarray(t.times, dtype=float),
                                 prepend=0.0))
        if t.m == tail.m:
            tail.observe_async(t)
        dropped += int(t.dropped)
    out = {
        "updates": stale.count,
        "workers": int(traces[0].m),
        "staleness": {**stale.summary(), "hist": stale.counts()},
        "update_latency_s": lat.summary(),
        "dropped": dropped,
        "staleness_clamped": clamped,
        "delay_tail": tail.snapshot(),
    }
    if corrupted:
        out["corrupted"] = corrupted
    return out


def cell_summary(sources) -> dict:
    """Per-cell ``obs`` summary from a recorder's engine-artifact slice
    (``TraceRecorder.sources_since``): synchronous schedules and async
    traces summarized side by side."""
    scheds = [s.obj for s in sources if s.tag == "schedule"]
    asyncs = [s.obj for s in sources if s.tag == "async"]
    out: dict = {}
    sm = schedule_metrics(scheds)
    if sm:
        out["schedule"] = sm
    am = async_metrics(asyncs)
    if am:
        out["async"] = am
    return out
