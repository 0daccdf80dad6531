"""Structured tracing: straggler timelines + phase spans (DESIGN.md §11).

A :class:`TraceRecorder` captures two clock domains into one event stream:

  * **simulated time** — per-iteration straggler timelines from the
    ``ClusterEngine``: one ``iter`` event per barrier on the master lane and
    one ``worker`` event per (iteration, worker) with its arrival and
    active/erased flag; asynchronous runs contribute one ``update`` event
    per applied gradient with its staleness.  Batched (Monte-Carlo) runs
    record one lane group per realization.
  * **host time** — ``span`` events around the phases of a cell (``encode``,
    ``sample-schedule``, ``solve``, ``chunk``, ...), relative to recorder
    creation.

Recording is cheap by construction: the engine hands the recorder the
``Schedule`` / ``AsyncTrace`` it already built and the recorder stores a
*reference* (one list append); expansion into per-worker events happens only
at export/inspection time.  With no active recorder every hook is a single
``is None`` check — the disabled path does no work at all.

Exports: JSONL (``to_jsonl`` / ``TraceRecorder.load`` round-trip) and
Chrome/Perfetto ``trace_event`` JSON (``to_perfetto``) that opens directly
in ``chrome://tracing`` / https://ui.perfetto.dev with one process per
(cell, realization) sim lane group and one thread per worker.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Iterator

import numpy as np

__all__ = ["TraceEvent", "TraceRecorder", "current_recorder", "span"]


# kinds measured on the host clock; everything else is simulated seconds
HOST_KINDS = ("span", "mark")
SIM_KINDS = ("iter", "worker", "update", "instant")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One event of a trace.  ``ts``/``dur`` are seconds in the clock domain
    of ``kind`` (host-relative for spans/marks, simulated for the rest)."""
    kind: str
    name: str
    ts: float
    dur: float = 0.0
    lane: str = ""
    realization: int = 0
    step: int | None = None
    cell: str | None = None
    args: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if not d["args"]:
            d.pop("args")
        if d["step"] is None:
            d.pop("step")
        if d["cell"] is None:
            d.pop("cell")
        return d

    @staticmethod
    def from_dict(d: dict) -> "TraceEvent":
        return TraceEvent(
            kind=d["kind"], name=d["name"], ts=float(d["ts"]),
            dur=float(d.get("dur", 0.0)), lane=d.get("lane", ""),
            realization=int(d.get("realization", 0)), step=d.get("step"),
            cell=d.get("cell"), args=d.get("args", {}))


@dataclasses.dataclass(frozen=True)
class _SimSource:
    """A lazily-expanded engine artifact: the recorder keeps the reference,
    per-event expansion happens at export time."""
    tag: str                 # "schedule" | "async"
    obj: Any                 # runtime.engine Schedule / AsyncTrace
    realization: int
    cell: str | None


# ---------------------------------------------------------------------------
# Active-recorder plumbing (module global; one None-check when disabled)
# ---------------------------------------------------------------------------

_ACTIVE: "TraceRecorder | None" = None


def current_recorder() -> "TraceRecorder | None":
    """The recorder instrumentation hooks should emit into (None = off)."""
    return _ACTIVE


def span(name: str, **args):
    """Context manager recording a host-clock span on the active recorder;
    a shared no-op when tracing is disabled."""
    rec = _ACTIVE
    if rec is None:
        return contextlib.nullcontext()
    return rec.span(name, **args)


class TraceRecorder:
    """Collects trace events; activate with ``with recorder.activate():``."""

    def __init__(self, meta: dict | None = None):
        self.meta = dict(meta or {})
        self._t0 = time.perf_counter()
        self._entries: list = []        # TraceEvent | _SimSource, in order
        self._cell: str | None = None
        self._cache: list | None = None

    # -- activation -------------------------------------------------------

    @contextlib.contextmanager
    def activate(self):
        """Make this the process-wide active recorder for the block."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev

    # -- scoping ----------------------------------------------------------

    @contextlib.contextmanager
    def cell(self, label: str):
        """Attach ``label`` as the cell of every event recorded inside."""
        prev = self._cell
        self._cell = label
        try:
            yield self
        finally:
            self._cell = prev

    def checkpoint(self) -> int:
        """Entry-count marker; pair with :meth:`sources_since`."""
        return len(self._entries)

    def sources_since(self, mark: int) -> list:
        """The engine artifacts recorded after ``mark`` — the per-cell
        slice the metrics layer summarizes."""
        return [e for e in self._entries[mark:] if isinstance(e, _SimSource)]

    # -- host-clock spans ---------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = self._now()
        try:
            yield self
        finally:
            self._append(TraceEvent(kind="span", name=name, ts=t0,
                                    dur=self._now() - t0, lane="host",
                                    cell=self._cell, args=args))

    def instant(self, name: str, **args) -> None:
        self._append(TraceEvent(kind="mark", name=name, ts=self._now(),
                                lane="host", cell=self._cell, args=args))

    # -- engine streams (lazy; one append each) -----------------------------

    def record_schedule(self, sched, *, realization: int = 0,
                        cell: str | None = None) -> None:
        """Record a realized synchronous ``Schedule`` (per-iteration
        straggler timeline: master barrier lane + one lane per worker)."""
        self._append(_SimSource("schedule", sched, realization,
                                cell if cell is not None else self._cell))

    def record_async(self, trace, *, realization: int = 0,
                     cell: str | None = None) -> None:
        """Record a realized ``AsyncTrace`` (per-applied-update events with
        staleness, clamped at this boundary — see :func:`_expand_async`)."""
        self._append(_SimSource("async", trace, realization,
                                cell if cell is not None else self._cell))

    def _append(self, entry) -> None:
        self._entries.append(entry)
        self._cache = None

    # -- materialization -----------------------------------------------------

    def events(self) -> list:
        """Every event, sim sources expanded, in recording order (cached)."""
        if self._cache is None:
            out: list = []
            for e in self._entries:
                if isinstance(e, TraceEvent):
                    out.append(e)
                elif e.tag == "schedule":
                    out.extend(_expand_schedule(e))
                else:
                    out.extend(_expand_async(e))
            self._cache = out
        return self._cache

    def iteration_events(self) -> list:
        return [e for e in self.events() if e.kind == "iter"]

    def worker_events(self) -> list:
        return [e for e in self.events() if e.kind == "worker"]

    def spans(self) -> list:
        return [e for e in self.events() if e.kind == "span"]

    # -- I/O -------------------------------------------------------------

    def to_jsonl(self, path: str) -> None:
        """One JSON object per line; line 1 is the recorder meta."""
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "meta", "meta": self.meta}) + "\n")
            for ev in self.events():
                f.write(json.dumps(ev.to_dict()) + "\n")

    @classmethod
    def load(cls, path: str) -> "TraceRecorder":
        """Inverse of :meth:`to_jsonl` (events come back materialized)."""
        rec = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if d.get("kind") == "meta":
                    rec.meta.update(d.get("meta", {}))
                    continue
                rec._append(TraceEvent.from_dict(d))
        return rec

    def to_perfetto(self, path: str) -> None:
        """Chrome ``trace_event`` JSON: open in ``chrome://tracing`` or
        https://ui.perfetto.dev.  Host spans live in pid 0; every
        (cell, realization) sim lane group gets its own process with the
        master barrier timeline on tid 0 and worker i on tid i+1 (erased
        workers are greyed out)."""
        tev: list[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "host (phase spans)"}},
        ]
        groups: dict[tuple, int] = {}
        named_tids: set = set()

        def pid_for(cell, realization) -> int:
            key = (cell, realization)
            if key not in groups:
                pid = 1 + len(groups)
                groups[key] = pid
                label = f"sim {cell or 'run'} [r{realization}]"
                tev.append({"ph": "M", "pid": pid, "tid": 0,
                            "name": "process_name", "args": {"name": label}})
            return groups[key]

        def tid_for(pid: int, lane: str) -> int:
            if lane.startswith("worker:"):
                tid, tname = int(lane.split(":", 1)[1]) + 1, lane
            else:
                tid, tname = 0, "master"
            if (pid, tid) not in named_tids:
                named_tids.add((pid, tid))
                tev.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name", "args": {"name": tname}})
            return tid

        for ev in self.events():
            args = dict(ev.args)
            if ev.step is not None:
                args["step"] = ev.step
            if ev.kind in HOST_KINDS:
                pid, tid = 0, 0
                if ev.cell is not None:
                    args["cell"] = ev.cell
            else:
                pid = pid_for(ev.cell, ev.realization)
                tid = tid_for(pid, ev.lane)
            base = {"name": ev.name, "pid": pid, "tid": tid,
                    "ts": ev.ts * 1e6, "args": args}
            if ev.dur > 0.0:
                base.update(ph="X", dur=ev.dur * 1e6)
                if ev.kind == "worker" and not ev.args.get("active", True):
                    base["cname"] = "grey"
            else:
                base.update(ph="i", s="t")
            tev.append(base)

        with open(path, "w") as f:
            json.dump({"traceEvents": tev, "displayTimeUnit": "ms",
                       "otherData": self.meta}, f)


# ---------------------------------------------------------------------------
# Source expansion
# ---------------------------------------------------------------------------

def _expand_schedule(src: _SimSource) -> Iterator[TraceEvent]:
    from repro_torch.runtime.faults import FAULT_KINDS
    sched, r, cell = src.obj, src.realization, src.cell
    masks = np.asarray(sched.masks)
    # fault-model schedules carry per-(iter, worker) failure codes and the
    # realized fault timeline (getattr: hand-built schedules predate them)
    failed = getattr(sched, "failed", None)
    if failed is not None:
        failed = np.asarray(failed)
    for ev in sched.events:
        arrivals = np.asarray(ev.arrivals)
        row = masks[ev.t]
        yield TraceEvent(
            kind="iter", name=f"iter {ev.t}", ts=float(ev.start),
            dur=float(ev.commit - ev.start), lane="master", realization=r,
            step=int(ev.t), cell=cell,
            args={"active": [int(a) for a in ev.active],
                  "active_size": int(len(ev.active))})
        for i in range(sched.m):
            args = {"active": bool(row[i])}
            if failed is not None and failed[ev.t, i]:
                args["failed"] = FAULT_KINDS.get(int(failed[ev.t, i]),
                                                 str(int(failed[ev.t, i])))
            # a crashed/blacked-out worker never arrives: clamp its lane
            # event to the barrier instead of an infinite bar
            dur = float(arrivals[i] - ev.start)
            if not np.isfinite(dur):
                dur = float(ev.commit - ev.start)
            yield TraceEvent(
                kind="worker", name="compute", ts=float(ev.start),
                dur=dur, lane=f"worker:{i}",
                realization=r, step=int(ev.t), cell=cell, args=args)
    for fe in getattr(sched, "fault_events", ()):
        args = {"fault": fe.kind}
        if fe.duration:
            args["duration_s"] = float(fe.duration)
        if fe.t >= 0:
            args["step"] = int(fe.t)
        yield TraceEvent(
            kind="instant", name=f"fault:{fe.kind}", ts=float(fe.time),
            lane=f"worker:{int(fe.worker)}", realization=r, cell=cell,
            args=args)


def clamp_async_event(u: int, tau: int, rv: int, total: int) -> tuple:
    """Snap one async (update index, staleness, read_version) triple into
    range; returns ``(tau, rv, was_clamped)``.

    The engine's invariant is ``rv + tau == u`` with ``0 <= tau <= u`` and
    ``rv < total``; a hand-built or corrupted trace can violate it, which
    would silently wrap downstream ring buffers.
    """
    if rv + tau != u or rv >= total or tau < 0:
        tau = min(max(tau, 0), u)
        return tau, u - tau, True
    return tau, rv, False


def _expand_async(src: _SimSource) -> Iterator[TraceEvent]:
    """Per-applied-update events.  Staleness accounting is CLAMPED at this
    trace boundary: an event whose (read_version, staleness) pair is
    inconsistent with its update index (it would reference an update beyond
    the recorded stream, e.g. a hand-built or corrupted trace) is snapped
    into range and counted, instead of silently wrapping downstream
    consumers' ring buffers; the count is surfaced on the trailing
    ``async-summary`` event."""
    tr, r, cell = src.obj, src.realization, src.cell
    workers = np.asarray(tr.workers)
    staleness = np.asarray(tr.staleness)
    reads = np.asarray(tr.read_versions)
    times = np.asarray(tr.times)
    U = int(workers.shape[0])
    clamped = 0
    for u in range(U):
        tau, rv, was = clamp_async_event(u, int(staleness[u]),
                                         int(reads[u]), U)
        clamped += was
        yield TraceEvent(
            kind="update", name="apply", ts=float(times[u]), dur=0.0,
            lane=f"worker:{int(workers[u])}", realization=r, step=u,
            cell=cell, args={"staleness": tau, "read_version": rv})
    for fe in getattr(tr, "fault_events", ()):
        args = {"fault": fe.kind}
        if fe.duration:
            args["duration_s"] = float(fe.duration)
        yield TraceEvent(
            kind="instant", name=f"fault:{fe.kind}", ts=float(fe.time),
            lane=f"worker:{int(fe.worker)}", realization=r, cell=cell,
            args=args)
    summary = {"updates": U, "dropped": int(tr.dropped),
               "staleness_clamped": clamped}
    corrupted = int(getattr(tr, "corrupted", 0))
    if corrupted:
        summary["corrupted"] = corrupted
    yield TraceEvent(
        kind="instant", name="async-summary",
        ts=float(times[-1]) if U else 0.0, lane="master", realization=r,
        cell=cell, args=summary)
