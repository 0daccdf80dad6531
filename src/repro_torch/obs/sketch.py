"""Online sketches: P² quantiles, EWMA, per-worker delay-tail estimators.

The streaming layer of repro_torch.obs (a copy of ``repro.obs.sketch``;
DESIGN.md §13).  Raw samples are fine for a 200-step cell but unbounded
for the streaming-serving scenario (ROADMAP) where observations arrive forever.
Everything here is O(1) memory per tracked quantity:

  * :class:`P2Quantile`      — the P² algorithm (Jain & Chlamtac 1985):
    one quantile from five markers, no samples retained;
  * :class:`QuantileSketch`  — several quantiles + running count/mean/
    min/max behind one ``observe`` API.  Exact (raw-sample) up to
    ``buffer_size`` observations, then the buffer seeds the P² markers
    and is dropped — small cells keep bit-exact percentiles, long
    streams get bounded memory;
  * :class:`Ewma`            — exponentially weighted moving average;
  * :class:`DelayTailEstimator` — per-worker EWMA delay + tail-quantile
    (p50/p95/p99) estimators fed from the engine's schedule / async
    event stream.  This is the sensing interface the adaptive-redundancy
    controller (Avestimehr et al., arXiv 1804.00217) consumes to adapt
    k and β mid-run, surfaced to records as the ``delay_tail_*``
    metrics.

Accuracy contract (tested): on 10⁶ i.i.d. samples the spilled sketch's
p50/p95/p99 are within 1% of exact ``np.percentile``.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["P2Quantile", "QuantileSketch", "Ewma", "DelayTailEstimator"]


class P2Quantile:
    """Streaming estimate of one quantile via the P² algorithm.

    Five markers track (min, q/2, q, (1+q)/2, max); each observation
    adjusts the middle markers by a piecewise-parabolic update.  Below
    five observations the estimate is exact.  ``seed_sorted`` initializes
    the markers from a sorted sample instead of the first five points,
    which is how :class:`QuantileSketch` hands over its exact buffer.
    """

    def __init__(self, q: float):
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        self.q = float(q)
        self._fracs = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)
        self._init: list | None = []    # first <5 observations
        self._heights: list | None = None
        self._pos: list | None = None       # integer marker positions
        self._want: list | None = None      # desired (fractional) positions
        self.count = 0

    # -- initialization ----------------------------------------------------

    def _start(self, sorted_vals: np.ndarray) -> None:
        n = int(sorted_vals.size)
        self._heights = [float(np.percentile(sorted_vals, f * 100.0))
                         for f in self._fracs]
        self._want = [1.0 + f * (n - 1) for f in self._fracs]
        pos = [int(round(w)) for w in self._want]
        # positions must be strictly increasing and span [1, n]
        pos[0], pos[4] = 1, n
        for i in range(1, 4):
            pos[i] = min(max(pos[i], pos[i - 1] + 1), n - (4 - i))
        self._pos = pos
        self.count = n
        self._init = None

    def seed_sorted(self, sorted_vals) -> None:
        """Initialize from an ascending array (>= 5 values) of past
        observations — more accurate than growing from the first five."""
        a = np.asarray(sorted_vals, dtype=float)
        if a.size < 5:
            raise ValueError("seed_sorted needs at least 5 values")
        if self.count:
            raise ValueError("P2Quantile already has observations")
        self._start(a)

    # -- update ------------------------------------------------------------

    def observe(self, x: float) -> None:
        x = float(x)
        if self._heights is None:
            self._init.append(x)
            self.count += 1
            if self.count == 5:
                self._start(np.sort(np.asarray(self._init)))
            return
        q, n = self._heights, self._pos
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._want[i] += self._fracs[i]
        self.count += 1
        for i in range(1, 4):
            d = self._want[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1) or \
                    (d <= -1.0 and n[i - 1] - n[i] < -1):
                s = 1 if d > 0 else -1
                # parabolic prediction; fall back to linear when it would
                # break marker monotonicity
                hp = q[i] + s / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + s) * (q[i + 1] - q[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1])
                    / (n[i] - n[i - 1]))
                if q[i - 1] < hp < q[i + 1]:
                    q[i] = hp
                else:
                    q[i] = q[i] + s * (q[i + s] - q[i]) / (n[i + s] - n[i])
                n[i] += s

    @property
    def value(self) -> float | None:
        """Current quantile estimate (None before any observation)."""
        if self._heights is not None:
            return self._heights[2]
        if not self._init:
            return None
        return float(np.percentile(np.asarray(self._init), self.q * 100.0))


class QuantileSketch:
    """Several streaming percentiles + running moments, one observe API.

    Exact up to ``buffer_size`` observations (``np.percentile`` over the
    raw buffer — identical to the historical raw-sample ``Histogram``),
    then the sorted buffer seeds one :class:`P2Quantile` per requested
    percentile and is dropped.  Memory after the spill is O(#percentiles),
    independent of the stream length.
    """

    def __init__(self, percentiles=(50, 95, 99), buffer_size: int = 4096):
        self.percentiles = tuple(percentiles)
        self.buffer_size = int(buffer_size)
        self._buf: list | None = []
        self._p2: dict | None = None
        self.count = 0
        self._mean = 0.0
        self._min = math.inf
        self._max = -math.inf

    @property
    def spilled(self) -> bool:
        """True once the raw buffer was folded into P² markers."""
        return self._buf is None

    def _track(self, a: np.ndarray) -> None:
        if a.size == 0:
            return
        total = self.count + a.size
        self._mean += (float(a.sum()) - a.size * self._mean) / total
        self.count = total
        self._min = min(self._min, float(a.min()))
        self._max = max(self._max, float(a.max()))

    def _spill(self) -> None:
        srt = np.sort(np.asarray(self._buf, dtype=float))
        self._p2 = {}
        for q in self.percentiles:
            est = P2Quantile(q / 100.0)
            est.seed_sorted(srt)
            self._p2[q] = est
        self._buf = None

    def observe(self, v) -> None:
        self.observe_many([v])

    def observe_many(self, vs) -> None:
        a = np.asarray(vs, dtype=float).ravel()
        self._track(a)
        if self._buf is not None:
            self._buf.extend(a.tolist())
            if len(self._buf) > self.buffer_size:
                self._spill()
            return
        vals = a.tolist()
        for est in self._p2.values():
            for x in vals:
                est.observe(x)

    def quantile(self, q: float) -> float | None:
        """Quantile estimate for percentile ``q`` (must be one of
        ``percentiles`` after the spill; arbitrary while exact)."""
        if self.count == 0:
            return None
        if self._buf is not None:
            return float(np.percentile(np.asarray(self._buf), q))
        if q not in self._p2:
            raise KeyError(f"percentile {q} not tracked after spill; have "
                           f"{self.percentiles}")
        return self._p2[q].value

    def summary(self) -> dict:
        """The same schema as the historical ``Histogram.summary``:
        count/mean/min/max + one ``p<q>`` key per tracked percentile."""
        if self.count == 0:
            return {"count": 0}
        out = {"count": int(self.count), "mean": float(self._mean),
               "min": float(self._min), "max": float(self._max)}
        for q in self.percentiles:
            out[f"p{q}"] = self.quantile(q)
        if self.spilled:
            out["approx"] = True
        return out


class Ewma:
    """Exponentially weighted moving average; ``value`` is None until the
    first observation (which initializes it exactly)."""

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.value: float | None = None
        self.count = 0

    def update(self, x) -> float:
        x = float(x)
        self.value = x if self.value is None else \
            self.alpha * x + (1.0 - self.alpha) * self.value
        self.count += 1
        return self.value


class DelayTailEstimator:
    """Per-worker online delay-tail state: EWMA delay + tail quantiles.

    The sensing layer for adaptive redundancy: pass one to
    ``ClusterEngine(tail_estimator=...)`` and every sampled schedule /
    async trace updates it in-stream — a controller can then read
    ``snapshot()`` mid-run to adapt the active-set size k (or β) to the
    observed tail.  ``repro_torch.obs.metrics`` uses the same class offline to
    attach ``delay_tail`` summaries to records.

    Per worker: one :class:`Ewma` over its per-iteration delay (arrival
    minus iteration start for synchronous schedules; inter-apply gap for
    async traces) and one :class:`QuantileSketch` (p50/p95/p99, small
    exact buffer) — O(1) memory per worker regardless of run length.
    """

    PERCENTILES = (50, 95, 99)

    def __init__(self, m: int, *, alpha: float = 0.2,
                 buffer_size: int = 128):
        self.m = int(m)
        self._ewma = [Ewma(alpha) for _ in range(self.m)]
        self._tail = [QuantileSketch(self.PERCENTILES, buffer_size)
                      for _ in range(self.m)]
        # fault sensing: counts from faulted schedules so
        # the adaptive-k controller can tell a fat delay tail from genuine
        # failures (a crash wants more redundancy, a tail wants a smaller k)
        self._fault_schedules = 0
        self._crashes = 0
        self._blackouts = 0
        self._blackout_s = 0.0
        self._corrupt = 0

    def observe(self, worker: int, delay: float) -> None:
        self._ewma[worker].update(delay)
        self._tail[worker].observe(delay)

    def observe_iteration(self, start: float, arrivals) -> None:
        """One synchronous barrier: every worker's arrival minus the
        iteration start (the realized compute+delay of that worker)."""
        a = np.asarray(arrivals, dtype=float)
        for i in range(min(self.m, a.shape[0])):
            self.observe(i, a[i] - float(start))

    def observe_schedule(self, sched) -> None:
        """Feed a realized ``runtime.engine.Schedule`` — delay tails from
        its barrier events plus, for faulted schedules, the realized
        crash/blackout/corrupt counts (``fault_metrics`` in-stream)."""
        for ev in sched.events:
            self.observe_iteration(ev.start, ev.arrivals)
        if getattr(sched, "failed", None) is not None:
            self._fault_schedules += 1
        for fe in getattr(sched, "fault_events", ()) or ():
            kind = getattr(fe, "kind", None)
            if kind == "crash":
                self._crashes += 1
            elif kind == "blackout":
                self._blackouts += 1
                self._blackout_s += float(getattr(fe, "duration", 0.0))
            elif kind == "corrupt":
                self._corrupt += 1

    def observe_async(self, trace) -> None:
        """Feed a realized ``runtime.engine.AsyncTrace``: each worker's
        delay proxy is the gap between its consecutive applied updates
        (its first update counts from t=0)."""
        workers = np.asarray(trace.workers, dtype=int)
        times = np.asarray(trace.times, dtype=float)
        last = np.zeros(self.m)
        for u in range(workers.shape[0]):
            w = int(workers[u])
            if w < self.m:
                self.observe(w, times[u] - last[w])
                last[w] = times[u]

    def snapshot(self) -> dict:
        """JSON-safe per-worker state: the ``delay_tail_*`` metric family.

        ``ewma``/``p50``/``p95``/``p99`` are per-worker lists (None for a
        worker with no observations); ``p99_max`` / ``p99_mean`` aggregate
        the slowest tail across workers — the scalars an auto-tuner (or
        the metrics CSV) keys on.
        """
        ewma = [e.value for e in self._ewma]
        out = {"workers": self.m,
               "count": [t.count for t in self._tail],
               "ewma": ewma}
        for q in self.PERCENTILES:
            out[f"p{q}"] = [t.quantile(q) if t.count else None
                            for t in self._tail]
        p99 = [v for v in out["p99"] if v is not None]
        out["p99_max"] = max(p99) if p99 else None
        out["p99_mean"] = float(np.mean(p99)) if p99 else None
        if self._fault_schedules:
            # gated: clean-path snapshots keep their historical key set
            out["faults"] = {"schedules": self._fault_schedules,
                             "crashes": self._crashes,
                             "blackouts": self._blackouts,
                             "blackout_s": self._blackout_s,
                             "corrupt": self._corrupt}
        return out
