"""repro_torch.runtime.faults — failure injection beyond delay-only stragglers
(DESIGN.md §14).

The paper's sample-path guarantees treat stragglers as *erasures*: a slow
worker is simply absent from A_t and every worker eventually returns.  Real
clusters fail harder — workers crash and never return, racks black out for
a window and come back, a zone takes out a correlated group at once, and a
worker can return a *wrong* answer (bit-flip, torn write) that must be
detected and discarded rather than waited out.  This module gives the
cluster engine that vocabulary while keeping the delay models untouched:

  * a :class:`FaultModel` is a composition of independent injectors
    (:class:`CrashFault`, :class:`BlackoutFault`, :class:`ZoneFault`,
    :class:`CorruptionFault`) realized per delay realization from the ONE
    trial seed (a tagged child stream, so fault draws never perturb the
    delay rng — a fault model with zero realized faults reproduces the
    no-fault schedule bit for bit);
  * the engine stamps ``Schedule.failed`` with per-(iteration, worker)
    fault codes **distinct from "slow"**: ``mask == 0 and failed == OK``
    means erased-but-healthy (the paper's straggler), anything else names
    the failure (see the code table below);
  * a :class:`DegradePolicy` says what the optimizer does when the
    survivor set falls below the decode threshold k — renormalize over
    survivors (default, the existing m/|A_t| math), hold the last good
    gradient with a shrunk step, or have the master extend its deadline
    with exponential backoff so blacked-out workers can rejoin.

Spec strings (the ``--faults`` / ``--degrade`` CLI surface)::

    crash:p=0.2,at=0.5            each worker iid w.p. p crashes at t=0.5
    blackout:p=0.3,at=0.4,dur=0.6 window [0.4, 1.0) for sampled workers
    blackout:...,period=2.0       ...recurring every 2.0 sim-seconds
    zone:workers=0-3,at=0.8       correlated permanent loss of workers 0..3
    zone:workers=0-3,at=0.8,dur=1 ...transient (a zone blackout)
    corrupt:p=0.05                each arrival iid w.p. p is corrupt
    crash:p=0.2,at=0.5;corrupt:p=0.01      compose with ';'

    preset:<name>                 named chaos preset (``FAULT_PRESETS``):
      preset:ec2-tail             recurring short blackouts + rare corrupt
                                  arrivals — the EC2 delay-tail chaos the
                                  paper's wall-clocks were measured under
      preset:zone-outage          a correlated zone (workers 0-3) down for a
                                  window + an independent crash per worker
      preset:flaky-rack           one rack (workers 0-1) in periodic
                                  blackout with corrupt re-arrivals
    Presets expand to ordinary chunks and compose with them:
    ``preset:ec2-tail;crash:p=0.1,at=0.8`` is valid.

    renormalize                   DegradePolicy (default)
    hold:shrink=0.5               reuse last gradient at half step below k
    backoff:base=0.05,retries=4   deadline extension, capped exponential

All times are simulated seconds on the engine's wall clock.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "FAULT_OK", "FAULT_CRASHED", "FAULT_BLACKOUT", "FAULT_CORRUPT",
    "FAULT_KINDS", "FaultEvent", "CrashFault", "BlackoutFault", "ZoneFault",
    "CorruptionFault", "FaultModel", "FaultRealization", "make_fault_model",
    "FAULT_PRESETS", "DegradePolicy", "DEGRADE_MODES", "make_degrade",
]

# ``Schedule.failed`` codes.  OK covers both "active" and "healthy but
# slow" — the mask disambiguates; the other codes name a genuine failure.
FAULT_OK = 0        # healthy (active, or merely slow/erased)
FAULT_CRASHED = 1   # permanently dead at this iteration's start
FAULT_BLACKOUT = 2  # inside a transient blackout window
FAULT_CORRUPT = 3   # arrived (wall-clock charged) but result discarded

FAULT_KINDS = {FAULT_OK: "ok", FAULT_CRASHED: "crashed",
               FAULT_BLACKOUT: "blackout", FAULT_CORRUPT: "corrupt"}

# fault rng tag: keeps fault structure on a child stream of the trial seed
# so delay draws are untouched (see module docstring)
_FAULT_STREAM_TAG = 0xFA017


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One realized fault occurrence, the obs trace's fault lane unit."""
    kind: str          # "crash" | "blackout" | "corrupt"
    worker: int        # worker index
    time: float        # sim-seconds the fault takes effect
    duration: float = 0.0   # blackout window length (0 for crash/corrupt)
    t: int = -1        # iteration index for corruption, -1 for timed faults


def _parse_workers(spec: str, m_hint: int | None = None) -> tuple:
    """``"0-3"`` | ``"0,2,5"`` | ``"0-1,4"`` -> sorted tuple of indices."""
    out: set[int] = set()
    for part in str(spec).split("+"):
        for piece in part.split("/"):
            piece = piece.strip()
            if not piece:
                continue
            if "-" in piece:
                lo, hi = piece.split("-", 1)
                out.update(range(int(lo), int(hi) + 1))
            else:
                out.add(int(piece))
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class CrashFault:
    """Each worker independently crashes (permanently) w.p. ``p`` at time
    ``at`` (+ Uniform(0, jitter) so crashes need not be simultaneous)."""
    p: float = 0.1
    at: float = 0.5
    jitter: float = 0.0

    def apply(self, rz: "FaultRealization", rng) -> None:
        hit = rng.random(rz.m) < self.p
        when = self.at + (rng.uniform(0.0, self.jitter, rz.m)
                          if self.jitter > 0 else 0.0)
        rz.crash_time = np.where(hit, np.minimum(rz.crash_time, when),
                                 rz.crash_time)


@dataclasses.dataclass(frozen=True)
class BlackoutFault:
    """Each worker independently (w.p. ``p``) goes dark over
    ``[at, at + dur)``; with ``period`` set the window recurs every
    ``period`` sim-seconds (dur < period required)."""
    p: float = 0.2
    at: float = 0.3
    dur: float = 0.5
    period: float | None = None

    def __post_init__(self):
        if self.period is not None and self.dur >= self.period:
            raise ValueError("blackout dur must be < period")

    def apply(self, rz: "FaultRealization", rng) -> None:
        members = rng.random(rz.m) < self.p
        if members.any():
            rz.windows.append((float(self.at), float(self.dur),
                               None if self.period is None
                               else float(self.period), members))


@dataclasses.dataclass(frozen=True)
class ZoneFault:
    """Correlated failure: the named worker group goes down together at
    ``at`` — permanently when ``dur`` is inf (a zone crash), else for a
    shared window (a zone blackout)."""
    workers: tuple = (0,)
    at: float = 0.5
    dur: float = float("inf")

    def apply(self, rz: "FaultRealization", rng) -> None:
        idx = np.asarray([w for w in self.workers if 0 <= w < rz.m],
                         dtype=int)
        if idx.size == 0:
            return
        if np.isinf(self.dur):
            rz.crash_time[idx] = np.minimum(rz.crash_time[idx], self.at)
        else:
            members = np.zeros(rz.m, dtype=bool)
            members[idx] = True
            rz.windows.append((float(self.at), float(self.dur), None,
                               members))


@dataclasses.dataclass(frozen=True)
class CorruptionFault:
    """Each *arrival* is independently corrupt w.p. ``p``: the master
    waited for it (wall-clock charged) but discards the result."""
    p: float = 0.05

    def apply(self, rz: "FaultRealization", rng) -> None:
        rz.corrupt_p = 1.0 - (1.0 - rz.corrupt_p) * (1.0 - self.p)


_INJECTORS = {"crash": CrashFault, "blackout": BlackoutFault,
              "zone": ZoneFault, "corrupt": CorruptionFault}

# Named chaos presets for the workload zoo (``--faults preset:<name>``);
# each expands to ordinary spec chunks, so presets compose with explicit
# injectors and with each other via ';'.
FAULT_PRESETS = {
    # the EC2 delay-tail story (paper §5): machines fall out for short
    # recurring windows and an occasional arrival is garbage
    "ec2-tail": "blackout:p=0.3,at=0.4,dur=0.4,period=2.5;corrupt:p=0.02",
    # a correlated availability-zone outage plus independent attrition
    "zone-outage": "zone:workers=0-3,at=0.6,dur=1.5;crash:p=0.1,at=1.0",
    # one flaky rack: periodic blackout of a fixed pair with corrupt
    # re-arrivals as it flaps
    "flaky-rack": "zone:workers=0-1,at=0.2,dur=0.3;"
                  "blackout:p=0.15,at=0.8,dur=0.4,period=3.0;corrupt:p=0.05",
}


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """A composition of fault injectors; ``realize`` instantiates the
    realization-specific fault structure from the trial seed."""
    injectors: tuple
    spec: str = ""     # the originating spec string (meta / provenance)

    def realize(self, m: int, trial_seed: int) -> "FaultRealization":
        rng = np.random.default_rng(
            np.random.SeedSequence([int(trial_seed) & 0xFFFFFFFF,
                                    _FAULT_STREAM_TAG]))
        rz = FaultRealization(m=int(m), rng=rng)
        for inj in self.injectors:
            inj.apply(rz, rng)
        return rz


class FaultRealization:
    """Per-realization fault structure: crash times, blackout windows and
    the corruption stream.  All queries are vectorized over workers."""

    def __init__(self, m: int, rng):
        self.m = int(m)
        self.rng = rng
        self.crash_time = np.full(self.m, np.inf)
        # (start, dur, period|None, member mask (m,)) per blackout spec
        self.windows: list[tuple] = []
        self.corrupt_p = 0.0

    # -- point-in-time queries ------------------------------------------

    def crashed_at(self, time: float) -> np.ndarray:
        return self.crash_time <= time

    def blackout_at(self, time: float) -> np.ndarray:
        dark = np.zeros(self.m, dtype=bool)
        for start, dur, period, members in self.windows:
            if period is None:
                inside = start <= time < start + dur
            else:
                inside = time >= start and ((time - start) % period) < dur
            if inside:
                dark |= members
        return dark

    def recovery_time(self, time: float) -> np.ndarray:
        """Earliest instant >= ``time`` each worker is out of blackout
        (inf for crashed workers, ``time`` for workers not dark now) —
        the master's lookup for deadline-extension backoff."""
        rec = np.full(self.m, time)
        for start, dur, period, members in self.windows:
            if period is None:
                inside = start <= time < start + dur
                end = start + dur
            else:
                inside = time >= start and ((time - start) % period) < dur
                end = (start + np.floor((time - start) / period) * period
                       + dur) if time >= start else start + dur
            if inside:
                rec = np.where(members, np.maximum(rec, end), rec)
        return np.where(self.crashed_at(time), np.inf, rec)

    def corrupt_draw(self, count: int) -> np.ndarray:
        """Bernoulli(corrupt_p) over ``count`` arrivals, consuming the
        realization's fault stream (deterministic given the sample path)."""
        if self.corrupt_p <= 0.0 or count == 0:
            return np.zeros(count, dtype=bool)
        return self.rng.random(count) < self.corrupt_p

    def any_timed(self) -> bool:
        return bool(np.isfinite(self.crash_time).any() or self.windows)

    # -- obs events ------------------------------------------------------

    def static_events(self, horizon: float, max_events: int = 1024) -> list:
        """Crash and blackout :class:`FaultEvent` rows within the realized
        schedule's horizon (corruption events are appended by the engine
        as they occur)."""
        events: list[FaultEvent] = []
        for i in np.nonzero(np.isfinite(self.crash_time))[0]:
            if self.crash_time[i] <= horizon:
                events.append(FaultEvent("crash", int(i),
                                         float(self.crash_time[i])))
        for start, dur, period, members in self.windows:
            starts = [start] if period is None else [
                start + j * period
                for j in range(int(max(0.0, horizon - start) // period) + 1)]
            for s in starts:
                if s > horizon or len(events) >= max_events:
                    break
                for i in np.nonzero(members)[0]:
                    if self.crash_time[i] <= s:
                        continue   # already dead; crash event covers it
                    events.append(FaultEvent("blackout", int(i), float(s),
                                             duration=float(dur)))
        events.sort(key=lambda e: (e.time, e.worker))
        return events[:max_events]


def _coerce(val: str):
    if val == "inf":
        return float("inf")
    try:
        return int(val)
    except ValueError:
        try:
            return float(val)
        except ValueError:
            return val


def make_fault_model(spec) -> FaultModel | None:
    """Parse a ``--faults`` spec string (see module docstring) into a
    :class:`FaultModel`; passes through None / FaultModel unchanged."""
    if spec is None or isinstance(spec, FaultModel):
        return spec
    spec = str(spec).strip()
    if not spec or spec in ("none", "0"):
        return None
    injectors = []
    chunks = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, _, arg = chunk.partition(":")
        if name.strip() == "preset":
            key = arg.strip()
            if key not in FAULT_PRESETS:
                raise KeyError(f"unknown fault preset '{key}'; have "
                               f"{sorted(FAULT_PRESETS)}")
            chunks.extend(p.strip() for p in FAULT_PRESETS[key].split(";"))
        else:
            chunks.append(chunk)
    for chunk in chunks:
        name, _, argstr = chunk.partition(":")
        name = name.strip()
        if name not in _INJECTORS:
            raise KeyError(f"unknown fault injector '{name}'; have "
                           f"{sorted(_INJECTORS)}")
        kw = {}
        for pair in filter(None, (p.strip() for p in argstr.split(","))):
            key, _, val = pair.partition("=")
            key = key.strip()
            if name == "zone" and key == "workers":
                kw[key] = _parse_workers(val)
            else:
                kw[key] = _coerce(val.strip())
        injectors.append(_INJECTORS[name](**kw))
    if not injectors:
        return None
    return FaultModel(tuple(injectors), spec=spec)


# ---------------------------------------------------------------------------
# Degradation policies: what happens below the decode threshold k?
# ---------------------------------------------------------------------------

DEGRADE_MODES = ("renormalize", "hold", "backoff")


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """What the optimizer/master does when |survivors| < k (DESIGN.md §14).

    * ``renormalize`` — decode weights renormalize over the survivor set
      (the existing m/|A_t| masked-mean math; an empty set yields a zero
      gradient, i.e. the iterate holds still).  Pure math, no state.
    * ``hold`` — runner-side: below ``k_min`` survivors reuse the last
      full-rank gradient at ``shrink``x the step size (momentum-free
      Polyak-style damping); needs a gradient carry in the scan.
    * ``backoff`` — engine-side: the master extends its deadline in
      capped exponential windows (``base * 2^j``, ``retries`` attempts)
      so blacked-out workers can rejoin before the round commits.
    """
    mode: str = "renormalize"
    k_min: int | None = None   # decode threshold; None = policy's k
    shrink: float = 0.5        # hold-mode step multiplier below k
    base: float = 0.05         # backoff first window (sim-seconds)
    retries: int = 4           # backoff attempts (cap of the exponential)

    def __post_init__(self):
        if self.mode not in DEGRADE_MODES:
            raise KeyError(f"unknown degrade mode '{self.mode}'; have "
                           f"{DEGRADE_MODES}")

    @property
    def is_default(self) -> bool:
        return self.mode == "renormalize"


def make_degrade(spec) -> DegradePolicy | None:
    """Parse ``--degrade`` specs: ``hold``, ``hold:shrink=0.25,k_min=4``,
    ``backoff:base=0.1,retries=3``; None/''/'renormalize' -> None (the
    default math needs no policy object)."""
    if spec is None or isinstance(spec, DegradePolicy):
        return spec
    spec = str(spec).strip()
    if not spec or spec == "none":
        return None
    mode, _, argstr = spec.partition(":")
    kw = {}
    for pair in filter(None, (p.strip() for p in argstr.split(","))):
        key, _, val = pair.partition("=")
        kw[key.strip()] = _coerce(val.strip())
    pol = DegradePolicy(mode=mode.strip(), **kw)
    return None if pol.is_default and not kw else pol
