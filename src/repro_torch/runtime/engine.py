"""Discrete-event cluster simulator for straggler experiments (DESIGN.md §5-6).

The engine owns everything about *time*: it samples per-worker delays from a
``core.straggler`` delay model, decides which workers the master waits for
(pluggable active-set policies), and charges wall-clock correctly for both
execution modes the paper compares (§5):

  * **bulk-synchronous** strategies pay a *barrier* per iteration — the master
    commits when the slowest worker in the active set arrives
    (``sample_schedule``; for fastest-k this is the k-th order statistic, the
    same accounting as ``core.straggler.WallClock``);
  * **asynchronous** strategies pay *per arrival* — every worker gradient is
    applied the moment it lands on the master, so a single straggler delays
    only its own (stale) update (``sample_async``).

Everything here is host-side numpy; the resulting mask / event arrays are fed
into the device-resident step loops (``runtime.runners``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from repro_torch.core.straggler import (DelayModel, adaptive_k, bimodal_delays,
                                  constant_delays, exponential_delays,
                                  fastest_k, multimodal_delays,
                                  power_law_delays)
from repro_torch.runtime.faults import (FAULT_BLACKOUT, FAULT_CORRUPT,
                                  FAULT_CRASHED, FaultEvent,
                                  make_fault_model)
# obs hooks: with no active TraceRecorder, each is a single None-check
from repro_torch.obs.trace import current_recorder as _obs_recorder
from repro_torch.obs.trace import span as _obs_span

__all__ = [
    "DELAY_MODELS", "make_delay_model", "ActiveSetPolicy", "FastestK",
    "AdaptiveK", "Deadline", "AdversarialRotation", "POLICIES", "make_policy",
    "IterationEvent", "Schedule", "AsyncTrace", "ScheduleBatch", "AsyncBatch",
    "ClusterEngine",
]


DELAY_MODELS = {
    "bimodal": bimodal_delays,
    "power_law": power_law_delays,
    "exponential": exponential_delays,
    "multimodal": multimodal_delays,
    "constant": constant_delays,
}


def make_delay_model(name: str, **kw) -> DelayModel:
    if name not in DELAY_MODELS:
        raise KeyError(f"unknown delay model '{name}'; have "
                       f"{sorted(DELAY_MODELS)}")
    return DELAY_MODELS[name](**kw)


# ---------------------------------------------------------------------------
# Active-set policies: which workers does the master wait for at iteration t?
# ---------------------------------------------------------------------------

class ActiveSetPolicy:
    """Selects the active set A_t from this iteration's delay draw."""

    def reset(self) -> None:
        """Called once per schedule; clear any cross-iteration state."""

    def select(self, t: int, delays: np.ndarray,
               prev_active: np.ndarray | None) -> np.ndarray:
        raise NotImplementedError


class FastestK(ActiveSetPolicy):
    """Wait for the k smallest delays — the paper's default master (§3.1)."""

    def __init__(self, k: int):
        if int(k) < 1:
            raise ValueError(f"fastest-k needs k >= 1, got {k}")
        self.k = int(k)

    def select(self, t, delays, prev_active):
        return np.sort(fastest_k(delays, self.k))


class AdaptiveK(ActiveSetPolicy):
    """Paper §3.3: grow k until the overlap with A_{t-1} exceeds m/beta, so
    the L-BFGS overlap matrix stays full rank."""

    def __init__(self, beta: float, k_min: int = 1):
        self.beta = float(beta)
        # floor of 1: a 0/negative k_min would let the policy return an
        # empty set on a quiet round, which only the fault paths expect
        self.k_min = max(1, int(k_min))

    def select(self, t, delays, prev_active):
        return adaptive_k(delays, prev_active, self.beta, self.k_min)


class Deadline(ActiveSetPolicy):
    """Wait a fixed time budget per iteration: every worker whose delay is
    within ``deadline`` makes the cut; fall back to fastest-``k_min`` when
    the round was universally slow."""

    def __init__(self, deadline: float, k_min: int = 1):
        self.deadline = float(deadline)
        self.k_min = max(1, int(k_min))   # same floor as AdaptiveK

    def select(self, t, delays, prev_active):
        active = np.nonzero(delays <= self.deadline)[0]
        if active.size < self.k_min:
            active = fastest_k(delays, self.k_min)
        return np.sort(active)


class AdversarialRotation(ActiveSetPolicy):
    """Deterministic worst-case rotation (ignores delays): the erased set
    sweeps all workers with maximal churn — the paper's 'arbitrary {A_t}'
    sample-path guarantee (same sequence as ``core.adversarial_sets``)."""

    def __init__(self, k: int):
        if int(k) < 1:
            raise ValueError(f"adversarial rotation needs k >= 1, got {k}")
        self.k = int(k)

    def select(self, t, delays, prev_active):
        m = delays.shape[0]
        drop = m - self.k
        start = (t * drop) % m
        erased = (start + np.arange(drop)) % m
        return np.setdiff1d(np.arange(m), erased)


POLICIES = {
    "fastest-k": FastestK,
    "adaptive-k": AdaptiveK,
    "deadline": Deadline,
    "adversarial": AdversarialRotation,
}


def make_policy(name: str, **kw) -> ActiveSetPolicy:
    if name not in POLICIES:
        raise KeyError(f"unknown policy '{name}'; have {sorted(POLICIES)}")
    return POLICIES[name](**kw)


def _policy_k_min(policy: ActiveSetPolicy) -> int:
    """The decode threshold a policy aims for — ``k`` for fastest-k /
    adversarial, ``k_min`` for adaptive-k / deadline — used as the
    survivor floor that triggers degradation under faults."""
    for attr in ("k", "k_min"):
        if hasattr(policy, attr):
            return max(1, int(getattr(policy, attr)))
    return 1


# ---------------------------------------------------------------------------
# Event records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IterationEvent:
    """One bulk-synchronous iteration of the simulated cluster."""
    t: int
    start: float              # master broadcast time
    commit: float             # master update time (barrier + overhead)
    active: np.ndarray        # sorted worker indices in A_t
    arrivals: np.ndarray      # (m,) absolute arrival time of every worker


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A realized synchronous straggler schedule: masks + wall-clock.

    ``_events`` is either the materialized event tuple or a zero-arg
    thunk producing it — the batched samplers hand a thunk so matrix
    cells that never inspect per-iteration events (the hot path) skip
    building R x T ``IterationEvent`` objects; the first ``.events``
    access materializes and caches.
    """
    m: int
    masks: np.ndarray         # (T, m) float32 0/1 erasure masks
    times: np.ndarray         # (T,) elapsed seconds at each commit
    _events: object           # tuple[IterationEvent, ...] | () -> tuple
    # fault lane (runtime.faults): per-(t, worker) int8 codes —
    # FAULT_OK covers active AND healthy-but-slow (the mask disambiguates);
    # crashed/blackout/corrupt name genuine failures, distinct from "slow".
    # None = sampled without a fault model (the default, zero-cost path).
    failed: np.ndarray | None = None   # (T, m) int8 fault codes
    fault_events: tuple = ()           # tuple[FaultEvent, ...]

    @property
    def events(self) -> tuple:
        ev = self._events
        if callable(ev):
            ev = ev()
            object.__setattr__(self, "_events", ev)
        return ev

    @property
    def steps(self) -> int:
        return self.masks.shape[0]


@dataclasses.dataclass(frozen=True)
class AsyncTrace:
    """A realized asynchronous run: one entry per APPLIED master update."""
    m: int
    workers: np.ndarray        # (U,) int32   worker that produced update u
    staleness: np.ndarray      # (U,) int32   master_version - read_version
    read_versions: np.ndarray  # (U,) int32   parameter timestamp worker read
    times: np.ndarray          # (U,) float64 elapsed seconds at apply
    dropped: int               # gradients discarded for exceeding the bound
    corrupted: int = 0         # arrivals discarded as corrupt (fault lane)
    fault_events: tuple = ()   # tuple[FaultEvent, ...]

    @property
    def updates(self) -> int:
        return self.workers.shape[0]


@dataclasses.dataclass(frozen=True)
class ScheduleBatch:
    """R independent synchronous realizations, stacked along a leading trial
    axis — the input of the batched runners.  Realization r is
    exactly ``engine.trial(r).sample_schedule(...)``, so batched and
    sequential execution see identical delay draws."""
    m: int
    masks: np.ndarray         # (R, T, m) float32 0/1 erasure masks
    times: np.ndarray         # (R, T) elapsed seconds at each commit
    schedules: tuple          # tuple[Schedule, ...], one per realization
    failed: np.ndarray | None = None   # (R, T, m) int8, None without faults

    @property
    def trials(self) -> int:
        return self.masks.shape[0]

    @property
    def steps(self) -> int:
        return self.masks.shape[1]

    def realization(self, r: int) -> Schedule:
        return self.schedules[r]


@dataclasses.dataclass(frozen=True)
class AsyncBatch:
    """R independent asynchronous realizations (same trial-seed convention
    as ``ScheduleBatch``).  Every realization applies the same number of
    updates U, so the event streams stack into rectangular (R, U) arrays."""
    m: int
    workers: np.ndarray        # (R, U) int32
    staleness: np.ndarray      # (R, U) int32
    times: np.ndarray          # (R, U) float64 elapsed seconds at apply
    dropped: np.ndarray        # (R,) gradients discarded per realization
    traces: tuple              # tuple[AsyncTrace, ...], one per realization
    corrupted: np.ndarray | None = None   # (R,) corrupt arrivals discarded

    @property
    def trials(self) -> int:
        return self.workers.shape[0]

    @property
    def updates(self) -> int:
        return self.workers.shape[1]

    def realization(self, r: int) -> AsyncTrace:
        return self.traces[r]


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class ClusterEngine:
    """Simulates an m-worker cluster under a delay model.

    One engine instance = one delay environment; strategies ask it for either
    a synchronous ``Schedule`` or an asynchronous ``AsyncTrace``.  Sampling is
    deterministic given ``seed`` (each ``sample_*`` call re-seeds, so two
    strategies handed the same engine config see the same delay realization —
    fair wall-clock comparisons).
    """

    def __init__(self, delay_model: DelayModel, m: int, *,
                 compute_time: float = 0.05, master_overhead: float = 0.01,
                 seed: int = 0, tail_estimator=None, faults=None):
        self.delay_model = delay_model
        self.m = int(m)
        self.compute_time = float(compute_time)
        self.master_overhead = float(master_overhead)
        self.seed = int(seed)
        # fault injection (runtime.faults): a FaultModel or spec
        # string composes crashes / blackouts / zone loss / corruption on
        # top of the delay model.  None (the default) keeps every sampler
        # on the exact pre-fault code path — a single is-None check.
        self.faults = make_fault_model(faults)
        # online delay-tail sensing (a DelayTailEstimator-like object):
        # when set, every realized schedule / async trace updates it
        # in-stream — the adaptive-redundancy controller's input.  None
        # (the default) keeps sampling on the zero-overhead path.
        self.tail_estimator = tail_estimator
        # which realization lane this engine's samples record under when an
        # obs TraceRecorder is active; engine.trial(r) children carry r so
        # host-loop harnesses land on the same lanes as batched samplers
        self._obs_realization = 0

    # -- trial seeding ---------------------------------------------------

    def _trial_seed(self, realization: int) -> int:
        """Seed of delay realization ``realization``, derived from the ONE
        engine seed.  Realization 0 is the engine's own seed (so single-trial
        runs are unchanged); realization r > 0 is the (seed, r) child stream
        — stable no matter how many trials are drawn alongside it."""
        if realization == 0:
            return self.seed
        return int(np.random.SeedSequence(
            [self.seed, realization]).generate_state(1)[0])

    def trial(self, realization: int) -> "ClusterEngine":
        """Delay realization ``realization`` as its own engine: identical
        cluster, trial-r seed.  ``engine.trial(r).sample_schedule(...)``
        equals realization r of ``engine.sample_schedules(...)`` — the
        bridge harnesses use to run non-batchable cells (host-loop solvers,
        chunked workloads) trial by trial on the same realizations."""
        if realization == 0:
            return self
        child = ClusterEngine(self.delay_model, self.m,
                              compute_time=self.compute_time,
                              master_overhead=self.master_overhead,
                              seed=self._trial_seed(realization),
                              tail_estimator=self.tail_estimator,
                              faults=self.faults)
        child._obs_realization = self._obs_realization + realization
        return child

    # -- synchronous (barrier) mode -------------------------------------

    def sample_schedule(self, steps: int, policy: ActiveSetPolicy, *,
                        realization: int = 0, degrade=None) -> Schedule:
        """Realize ``steps`` BSP iterations under ``policy``.

        Iteration t starts at the previous commit; worker i's gradient
        arrives ``compute_time + delay_i`` later; the master commits at the
        latest arrival over A_t plus ``master_overhead``.  With a fault
        model attached the schedule additionally carries a ``failed`` code
        array and fault events; ``degrade`` (a ``backoff``-mode
        :class:`~repro_torch.runtime.faults.DegradePolicy`) lets the master
        extend its deadline when survivors fall below the threshold.
        """
        with _obs_span("sample-schedule", steps=steps, m=self.m):
            trial_seed = self._trial_seed(realization)
            rng = np.random.default_rng(trial_seed)
            policy.reset()
            if self.faults is not None:
                sched = self._sample_faulted(rng, steps, policy,
                                             trial_seed, degrade)
            elif type(policy) is FastestK:
                sched = self._sample_fastest_k(rng, steps, policy.k)
            else:
                sched = self._sample_generic(rng, steps, policy)
        if self.tail_estimator is not None:
            self.tail_estimator.observe_schedule(sched)
        rec = _obs_recorder()
        if rec is not None:
            rec.record_schedule(
                sched, realization=self._obs_realization + realization)
        return sched

    def _sample_generic(self, rng, steps: int,
                        policy: ActiveSetPolicy) -> Schedule:
        """The reference per-step loop: any policy, any cross-iteration
        state (the fast path below must stay bit-identical to this)."""
        now = 0.0
        prev_active: np.ndarray | None = None
        masks = np.zeros((steps, self.m), dtype=np.float32)
        times = np.zeros(steps)
        events = []
        for t in range(steps):
            delays = np.asarray(self.delay_model(rng, self.m),
                                dtype=float)
            arrivals = now + self.compute_time + delays
            active = np.asarray(policy.select(t, delays, prev_active))
            commit = float(arrivals[active].max()) + self.master_overhead
            masks[t, active] = 1.0
            times[t] = commit
            events.append(IterationEvent(t=t, start=now, commit=commit,
                                         active=active,
                                         arrivals=arrivals))
            now = commit
            prev_active = active
        return Schedule(self.m, masks, times, tuple(events))

    def _sample_fastest_k(self, rng, steps: int, k: int) -> Schedule:
        """Vectorized fastest-k sampling — the hot path of every batched
        matrix (R x T selections dominated per-cell dispatch cost).

        Bit-identical to ``_sample_generic`` with a ``FastestK`` policy: the
        delay draws keep the exact per-step rng call sequence, the row-wise
        ``argpartition``/``sort`` match the per-row calls, and the commit
        recursion preserves the reference float associativity
        ``((now + compute) + max_delay) + overhead``.
        """
        m, ct, oh = self.m, self.compute_time, self.master_overhead
        # per-step draws (NOT one (T, m) draw): the rng stream must match
        # the reference loop call for call
        delays = np.stack([np.asarray(self.delay_model(rng, m), dtype=float)
                           for _ in range(steps)])
        order = np.argpartition(delays, k - 1, axis=1)[:, :k]
        actives = np.sort(order, axis=1)
        masks = np.zeros((steps, m), dtype=np.float32)
        np.put_along_axis(masks, actives, 1.0, axis=1)
        dmax = np.take_along_axis(delays, order, axis=1).max(axis=1)
        times = np.zeros(steps)
        starts = np.zeros(steps)
        now = 0.0
        for t in range(steps):      # scalar recursion, reference rounding
            starts[t] = now
            now = ((now + ct) + dmax[t]) + oh
            times[t] = now
        def events():            # lazy: most matrix cells never look
            arrivals = (starts[:, None] + ct) + delays
            return tuple(
                IterationEvent(t=t, start=starts[t], commit=times[t],
                               active=actives[t], arrivals=arrivals[t])
                for t in range(steps))
        return Schedule(self.m, masks, times, events)

    def _sample_faulted(self, rng, steps: int, policy: ActiveSetPolicy,
                        trial_seed: int, degrade) -> Schedule:
        """The fault-aware per-step loop (only reached when a fault model
        is attached; the no-fault paths above stay byte-identical).

        Per iteration: crashed workers are permanently gone, blacked-out
        workers are unavailable for rounds that start inside their window
        (both are given infinite delay BEFORE policy selection and filtered
        from its pick — ``Deadline``'s fastest-k fallback must never wait
        on a dead worker); corrupt results arrive (the barrier pays for
        them) but are flagged and masked out of the combine.  The master
        detects failures instantly (a heartbeat assumption, DESIGN.md §14),
        so an all-failed round commits after one idle compute window.
        """
        fr = self.faults.realize(self.m, trial_seed)
        ct, oh = self.compute_time, self.master_overhead
        backoff = (degrade if degrade is not None
                   and degrade.mode == "backoff" else None)
        k_floor = _policy_k_min(policy)
        if backoff is not None and backoff.k_min is not None:
            k_floor = int(backoff.k_min)
        now = 0.0
        prev_active: np.ndarray | None = None
        masks = np.zeros((steps, self.m), dtype=np.float32)
        failed = np.zeros((steps, self.m), dtype=np.int8)
        times = np.zeros(steps)
        events, corrupt_events = [], []
        for t in range(steps):
            delays = np.asarray(self.delay_model(rng, self.m), dtype=float)
            crashed = fr.crashed_at(now)
            dark = fr.blackout_at(now) & ~crashed
            failed[t, crashed] = FAULT_CRASHED
            failed[t, dark] = FAULT_BLACKOUT
            avail = ~(crashed | dark)
            eff = np.where(avail, delays, np.inf)
            active = np.asarray(policy.select(t, eff, prev_active),
                                dtype=int)
            active = active[avail[active]]
            arrivals = now + ct + delays
            if backoff is not None and active.size < k_floor:
                # deadline extension: wait up to base * 2^j for blacked-out
                # workers to recover, restart, and report in
                recov = fr.recovery_time(now)
                rec_arrivals = recov + ct + delays
                window = backoff.base
                for _ in range(max(1, int(backoff.retries))):
                    rejoin = np.nonzero(dark & (recov <= now + window))[0]
                    extra = np.setdiff1d(rejoin, active)
                    if extra.size:
                        arrivals = arrivals.copy()
                        arrivals[extra] = rec_arrivals[extra]
                        active = np.sort(np.concatenate([active, extra]))
                    if active.size >= k_floor:
                        break
                    window *= 2.0
            if active.size:
                commit = float(arrivals[active].max()) + oh
                corrupt = fr.corrupt_draw(active.size)
                if corrupt.any():
                    for w in active[corrupt]:
                        failed[t, w] = FAULT_CORRUPT
                        corrupt_events.append(FaultEvent(
                            "corrupt", int(w), float(arrivals[w]), t=t))
                    active = active[~corrupt]
                masks[t, active] = 1.0
            else:
                # every worker failed: the master idles one compute window
                # and commits an empty round (mask row all-zero)
                commit = now + ct + oh
            times[t] = commit
            events.append(IterationEvent(t=t, start=now, commit=commit,
                                         active=active, arrivals=arrivals))
            now = commit
            prev_active = active
        horizon = float(times[-1]) if steps else 0.0
        fault_events = sorted(fr.static_events(horizon) + corrupt_events,
                              key=lambda e: (e.time, e.worker))
        return Schedule(self.m, masks, times, tuple(events),
                        failed=failed, fault_events=tuple(fault_events))

    def sample_schedules(self, steps: int, policy: ActiveSetPolicy,
                         trials: int, *, degrade=None) -> ScheduleBatch:
        """Realize ``trials`` independent schedules as one (R, T, m) stack.

        The realization axis is the Monte-Carlo axis of the paper's §5
        protocol (sample-path guarantees hold for EVERY delay realization,
        so figures average many).  Each realization replays the exact rng
        stream of ``sample_schedule`` under its trial seed — batched runs
        are bit-identical to looping ``engine.trial(r)`` — and stateful
        policies are reset at every realization boundary.
        """
        if trials < 1:
            raise ValueError("trials must be >= 1")
        scheds = tuple(self.sample_schedule(steps, policy, realization=r,
                                            degrade=degrade)
                       for r in range(trials))
        return ScheduleBatch(
            m=self.m,
            masks=np.stack([s.masks for s in scheds]),
            times=np.stack([s.times for s in scheds]),
            schedules=scheds,
            failed=(np.stack([s.failed for s in scheds])
                    if scheds[0].failed is not None else None))

    # -- asynchronous (per-arrival) mode --------------------------------

    def sample_async(self, updates: int, staleness_bound: int, *,
                     realization: int = 0) -> AsyncTrace:
        """Realize an async run until ``updates`` gradients are APPLIED.

        Every worker loops {read w, compute for compute_time + delay, send};
        the master applies each arriving gradient immediately (per-arrival
        accounting — no barrier) and bumps its version counter.  A gradient
        whose staleness ``master_version - read_version`` exceeds
        ``staleness_bound`` is discarded (the worker's time is still spent:
        bounded-staleness wastes work instead of corrupting the iterate),
        so every APPLIED update satisfies the bound.
        """
        if staleness_bound < 0:
            raise ValueError("staleness_bound must be >= 0")
        with _obs_span("sample-async", updates=updates, m=self.m):
            trial_seed = self._trial_seed(realization)
            rng = np.random.default_rng(trial_seed)
            # fault realization (None = the exact pre-fault event loop):
            # crashed workers take their in-flight gradient down with them
            # and never re-queue; blacked-out workers restart at window
            # end; corrupt arrivals are discarded without a version bump.
            fr = (self.faults.realize(self.m, trial_seed)
                  if self.faults is not None else None)
            read_version = np.zeros(self.m, dtype=np.int64)  # per-worker ts
            version = 0
            heap: list[tuple[float, int]] = []
            first = np.asarray(self.delay_model(rng, self.m), dtype=float)
            start0 = fr.recovery_time(0.0) if fr is not None else None
            for i in range(self.m):
                if start0 is None:
                    heapq.heappush(heap, (self.compute_time + first[i], i))
                elif np.isfinite(start0[i]):
                    heapq.heappush(
                        heap, (start0[i] + self.compute_time + first[i], i))

            workers, stale, reads, times = [], [], [], []
            dropped = corrupted = 0
            while len(workers) < updates:
                if not heap:
                    raise ValueError(
                        f"async cluster died: every worker crashed after "
                        f"{len(workers)} of {updates} updates")
                arrival, i = heapq.heappop(heap)
                if fr is not None and fr.crash_time[i] <= arrival:
                    continue   # worker died mid-compute; result lost
                if fr is not None and fr.corrupt_draw(1)[0]:
                    corrupted += 1
                else:
                    tau = version - read_version[i]
                    if tau <= staleness_bound:
                        workers.append(i)
                        stale.append(tau)
                        reads.append(read_version[i])
                        times.append(arrival + self.master_overhead)
                        version += 1
                    else:
                        dropped += 1
                # worker re-reads the (possibly updated) parameters, restarts
                read_version[i] = version
                delay = float(np.asarray(self.delay_model(rng, 1))[0])
                restart = arrival
                if fr is not None:
                    restart = float(fr.recovery_time(arrival)[i])
                heapq.heappush(heap, (restart + self.compute_time + delay, i))
            trace = AsyncTrace(
                m=self.m,
                workers=np.asarray(workers, dtype=np.int32),
                staleness=np.asarray(stale, dtype=np.int32),
                read_versions=np.asarray(reads, dtype=np.int32),
                times=np.asarray(times),
                dropped=dropped,
                corrupted=corrupted,
                fault_events=(tuple(fr.static_events(
                    float(times[-1]) if times else 0.0))
                    if fr is not None else ()),
            )
        if self.tail_estimator is not None:
            self.tail_estimator.observe_async(trace)
        rec = _obs_recorder()
        if rec is not None:
            rec.record_async(
                trace, realization=self._obs_realization + realization)
        return trace

    def sample_asyncs(self, updates: int, staleness_bound: int,
                      trials: int) -> AsyncBatch:
        """Realize ``trials`` independent async event streams, stacked
        (R, U) — every realization runs until the same ``updates`` gradients
        are applied, so the streams are rectangular.  Same trial-seed
        convention as ``sample_schedules``."""
        if trials < 1:
            raise ValueError("trials must be >= 1")
        traces = tuple(self.sample_async(updates, staleness_bound,
                                         realization=r)
                       for r in range(trials))
        return AsyncBatch(
            m=self.m,
            workers=np.stack([t.workers for t in traces]),
            staleness=np.stack([t.staleness for t in traces]),
            times=np.stack([t.times for t in traces]),
            dropped=np.asarray([t.dropped for t in traces]),
            traces=traces,
            corrupted=np.asarray([t.corrupted for t in traces]))
