"""Workload protocol + registry (DESIGN.md §8).

A ``Workload`` is the layer between the paper's problem definitions
(``configs/paper_native.py``) and the execution engine (``runtime``).
Each workload knows three things:

  1. **data** — how to synthesize (or load) its dataset deterministically,
     at one of three presets (``smoke``/``bench``/``paper``) scaled down
     from the paper's published dimensions;
  2. **lowering** — how to hand itself to the strategy layer: ridge/LASSO
     lower to a data-parallel ``ProblemSpec``, logistic lowers to the lifted
     BCD path (``make_lifted_problem`` + ``phi_logistic``), and matrix
     factorization runs ALS with every half-step dispatched as a coded ridge
     solve through the ``ClusterEngine``;
  3. **scoring** — its paper metric against a ground-truth reference
     (``workloads.ground_truth``): suboptimality gap, support-recovery F1,
     held-out classification error, test RMSE.

New workloads register with ``@register_workload``.

Port of ``src/repro/workloads/base.py``.  Every entry point (``run``,
``run_trials``, ``run_strategy_chunked``) takes ``device``: CUDA unless the
caller passes ``device="cpu"``, resolved once and handed to every strategy.
Datasets, ground truth and scores stay on the host as numpy, as in the
reference; iterates come back from the strategies as host arrays.  With an
obs recorder active, ``workload:data``, ``workload:ground_truth`` and
``workload:score`` spans split a cell's host clock into its data build,
its reference solve and its scoring; the rest of ``run`` is the run.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.configs.paper_native import QuadraticProblemConfig
from repro_torch.device import resolve_device
from repro_torch.obs.trace import span as _obs_span
from repro_torch.runtime.engine import ClusterEngine, make_delay_model
from repro_torch.runtime.strategies import (RunResult, get_strategy,
                                            json_safe_meta)

__all__ = [
    "Preset", "Workload", "WorkloadRunResult", "UnsupportedStrategy",
    "register_workload", "get_workload", "available_workloads",
    "sub_engine", "chunk_sizes", "run_strategy_chunked",
]


PRESET_NAMES = ("smoke", "bench", "paper")


class UnsupportedStrategy(ValueError):
    """A strategy that cannot run a given workload — carries the reason, so
    harnesses (compare, the workloads runner) can skip-with-reason instead
    of aborting the matrix."""


@dataclasses.dataclass(frozen=True)
class Preset:
    """One scale point of a workload: dims + cluster + solver budget.

    ``paper``-preset fields are the published §5 settings verbatim (via
    ``configs.paper_native``); ``bench``/``smoke`` keep the paper's ratios
    (k/m, lam regime, delay model) while shrinking dimensions to laptop/CI
    budgets.
    """
    name: str
    m: int                   # workers
    k: int                   # fastest-k the master waits for
    steps: int               # outer iteration budget
    lam: float
    delay: str               # delay-model registry name
    seed: int = 0
    dims: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WorkloadRunResult:
    """One (workload, strategy, engine) cell: wall-clock-vs-metric trace.

    ``times``/``objective`` are the full-resolution optimizer trace;
    ``metric_times``/``metric`` are the paper-metric record points (equal
    length to ``times`` when the metric is derivable per step, coarser when
    it needs the iterate).  ``extras`` is JSON-safe workload-specific
    payload — e.g. MF's per-half-step active sets.
    """
    workload: str
    strategy: str
    preset: str
    metric_name: str
    times: np.ndarray
    objective: np.ndarray
    metric_times: np.ndarray
    metric: np.ndarray
    w: np.ndarray | None = None
    meta: dict = dataclasses.field(default_factory=dict)
    extras: dict = dataclasses.field(default_factory=dict)

    @property
    def final_metric(self) -> float:
        return float(self.metric[-1])

    @property
    def final_objective(self) -> float:
        return float(self.objective[-1])

    @property
    def wallclock(self) -> float:
        return float(self.times[-1])

    def to_record(self) -> dict:
        """JSON-serializable record (iterate omitted)."""
        # np.asarray().tolist() converts whole traces in C instead of a
        # per-element float() loop (same fix as RunResult.to_record)
        return {
            "workload": self.workload,
            "strategy": self.strategy,
            "preset": self.preset,
            "metric_name": self.metric_name,
            "final_metric": self.final_metric,
            "final_objective": self.final_objective,
            "wallclock_s": self.wallclock,
            "times": np.asarray(self.times, dtype=float).tolist(),
            "objective": np.asarray(self.objective, dtype=float).tolist(),
            "metric_times": np.asarray(self.metric_times,
                                       dtype=float).tolist(),
            "metric": np.asarray(self.metric, dtype=float).tolist(),
            "meta": json_safe_meta(self.meta),
            "extras": self.extras,
        }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_WORKLOADS: dict[str, type["Workload"]] = {}


def register_workload(name: str):
    def deco(cls):
        cls.name = name
        _WORKLOADS[name] = cls
        return cls
    return deco


def get_workload(name: str) -> "Workload":
    if name not in _WORKLOADS:
        raise KeyError(f"unknown workload '{name}'; have "
                       f"{available_workloads()}")
    return _WORKLOADS[name]()


def available_workloads() -> list[str]:
    return sorted(_WORKLOADS)


# ---------------------------------------------------------------------------
# Engine helpers
# ---------------------------------------------------------------------------

def sub_engine(engine: ClusterEngine, tag: int) -> ClusterEngine:
    """A fresh delay realization of the same cluster: identical delay model /
    size / overheads, seed offset by ``tag``.  Deterministic, so two
    strategies handed the same parent engine see the same sub-realizations
    (fair comparisons), yet no two chunks/half-steps share a draw."""
    return ClusterEngine(engine.delay_model, engine.m,
                         compute_time=engine.compute_time,
                         master_overhead=engine.master_overhead,
                         seed=engine.seed + 7919 * (tag + 1),
                         faults=engine.faults)


def chunk_sizes(steps: int, records: int) -> list[int]:
    """Split ``steps`` into ``records`` near-equal positive chunks."""
    records = max(1, min(int(records), int(steps)))
    base, extra = divmod(steps, records)
    return [base + (1 if i < extra else 0) for i in range(records)]


def run_strategy_chunked(strategy: str, spec, engine: ClusterEngine, *,
                         steps: int, records: int, w0=None, device=None,
                         **cfg):
    """Drive a registry strategy in ``records`` chunks, threading the iterate.

    For stateless strategies (GD / prox / uncoded / replication) the iterate
    sequence is the same function of the realized masks as a single run —
    the chunking only exposes ``w_t`` at chunk boundaries, the hook
    workloads use for metrics that need the iterate (support F1) without
    touching the fused runners.  Note the realized SCHEDULE does depend on
    ``records``: each chunk draws a fresh delay realization via
    ``sub_engine``, and a stateful policy (e.g. ``AdversarialRotation``)
    restarts its sweep at each boundary.

    Each chunk re-runs the strategy, so it encodes the problem again, as
    the reference does.  The iterate is threaded between chunks as a host
    array.

    Returns (times, objective, record list of (elapsed, w), final RunResult).
    """
    device = resolve_device(device)
    times, objective, recs = [], [], []
    now = 0.0
    w = w0
    result: RunResult | None = None
    for c, chunk in enumerate(chunk_sizes(steps, records)):
        chunk_cfg = dict(cfg)
        if w is not None:
            chunk_cfg["w0"] = w
        with _obs_span("chunk", strategy=strategy, index=c, steps=chunk):
            result = get_strategy(strategy).run(spec, sub_engine(engine, c),
                                                steps=chunk, device=device,
                                                **chunk_cfg)
        times.extend((now + result.times).tolist())
        objective.extend(np.asarray(result.objective).tolist())
        now += result.wallclock
        w = np.asarray(result.w)
        recs.append((now, w))
    return np.asarray(times), np.asarray(objective), recs, result


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------

class Workload:
    """One paper-§5 end-to-end workload.  Subclasses define the class
    attributes below plus ``build`` and ``_run``."""

    name = "?"
    metric_name = "?"
    metric_goal = "min"            # "min" | "max" — how to read the metric
    paper_config: QuadraticProblemConfig | None = None
    canonical_coded = "coded-gd"   # what the 'coded' alias resolves to
    presets: dict[str, Preset] = {}

    # -- presets ----------------------------------------------------------
    def preset(self, name: str | Preset) -> Preset:
        if isinstance(name, Preset):
            return name
        if name not in self.presets:
            raise KeyError(f"workload '{self.name}' has no preset '{name}'; "
                           f"have {sorted(self.presets)}")
        return self.presets[name]

    # -- data -------------------------------------------------------------
    def build(self, preset: str | Preset) -> Any:
        """Synthesize/load the dataset (and ground truth) for a preset.
        Deterministic given the preset's seed; reusable across strategies."""
        raise NotImplementedError

    # -- lowering + scoring ------------------------------------------------
    def supports(self, strategy: str) -> str | None:
        """None if ``strategy`` can run this workload, else the reason."""
        return None

    def resolve_strategy(self, strategy: str) -> str:
        """Map the generic 'coded' alias to this workload's canonical coded
        scheme (ridge -> coded-lbfgs, lasso -> coded-prox, ...)."""
        return self.canonical_coded if strategy == "coded" else strategy

    def default_engine(self, preset: str | Preset, *, delay: str | None = None,
                       seed: int | None = None) -> ClusterEngine:
        ps = self.preset(preset)
        return ClusterEngine(make_delay_model(delay or ps.delay), ps.m,
                             seed=ps.seed if seed is None else seed)

    def skip_reason(self, strategy: str) -> str | None:
        """The skip-with-reason message this workload would raise for
        ``strategy``, or None when the cell can run — lets planners
        materialize skip cells up front with the exact message the record
        will carry."""
        try:
            self._resolve_checked(strategy)
        except UnsupportedStrategy as e:
            return str(e)
        return None

    def _resolve_checked(self, strategy: str) -> str:
        """Resolve the 'coded' alias and raise ``UnsupportedStrategy`` for
        unknown / unsupported strategies (shared by run and run_trials)."""
        from repro_torch.runtime.strategies import available_strategies
        strategy = self.resolve_strategy(strategy)
        # every workload lowering speaks in registry strategy names, so a
        # typo becomes a skip-with-reason cell rather than a KeyError that
        # aborts a half-finished matrix
        if strategy not in available_strategies():
            raise UnsupportedStrategy(
                f"unknown strategy '{strategy}'; have "
                f"{available_strategies()} (or the 'coded' alias)")
        reason = self.supports(strategy)
        if reason is not None:
            raise UnsupportedStrategy(
                f"{strategy} cannot run workload '{self.name}': {reason}")
        return strategy

    def run(self, strategy: str, engine: ClusterEngine | None = None, *,
            preset: str | Preset = "smoke", data: Any = None, device=None,
            **cfg) -> WorkloadRunResult:
        """Run one strategy on this workload end-to-end and score it.

        Raises ``UnsupportedStrategy`` (with the reason) when the strategy
        cannot express this workload — harnesses turn that into a
        skip-with-reason cell.  ``device`` unset means CUDA, and raises
        where no card is present.
        """
        strategy = self._resolve_checked(strategy)
        device = resolve_device(device)
        ps = self.preset(preset)
        if engine is None:
            engine = self.default_engine(ps)
        if data is None:
            data = self.build(ps)
        return self._run(strategy, engine, ps, data, device=device, **cfg)

    def run_trials(self, strategy: str, engine: ClusterEngine | None = None,
                   *, preset: str | Preset = "smoke", data: Any = None,
                   trials: int = 1, eval_every: int = 1,
                   placement: str = "vmap", device=None,
                   **cfg) -> list[WorkloadRunResult]:
        """``trials`` delay realizations of one cell (paper §5 Monte-Carlo
        protocol), one scored result per realization.

        The default drives ``run`` once per realization on
        ``engine.trial(r)`` — correct for every workload, including the
        chunked/ALS lowerings whose multi-dispatch structure cannot be
        batched (so ``placement`` is effectively ``'single'`` here whatever
        was requested).  Workloads whose lowering is a single strategy run
        (ridge) override this with the ``Strategy.run_batched`` path, where
        the whole realization stack is one device loop, placed per
        ``placement`` (single / vmap / sharded).  ``eval_every`` is
        honored by the batched overrides; this sequential fallback records
        at full per-step resolution.
        """
        strategy = self._resolve_checked(strategy)
        device = resolve_device(device)
        ps = self.preset(preset)
        if engine is None:
            engine = self.default_engine(ps)
        if data is None:
            data = self.build(ps)
        return [self._run(strategy, engine.trial(r), ps, data, device=device,
                          **dict(cfg))
                for r in range(trials)]

    def _run(self, strategy: str, engine: ClusterEngine, ps: Preset,
             data: Any, *, device, **cfg) -> WorkloadRunResult:
        raise NotImplementedError
