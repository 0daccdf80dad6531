"""Declarative experiment axes (a copy of ``repro.experiments.spec``;
DESIGN.md §10).

An :class:`ExperimentSpec` is the single way to say "run this matrix": a
frozen dataclass tree naming every axis of the paper's §5 protocol —

  * :class:`ProblemAxis`    — WHAT is solved: a synthetic quadratic, a
    concrete ``ProblemSpec``, or a registered workload at a preset;
  * :class:`StrategyAxis`   — WHO solves it: registry strategy name (or the
    per-workload ``'coded'`` alias) + encoder + policy / async config;
  * :class:`DelayAxis`      — the simulated cluster: delay models, worker
    count, per-iteration compute time;
  * :class:`TrialsAxis`     — the Monte-Carlo axis: R delay realizations,
    objective record stride, master seed;
  * :class:`PlacementAxis`  — HOW the realization axis executes: one run
    per realization (``single``), one device loop over all of them
    (``vmap``), or that loop spread over the visible cards
    (``sharded``).

Specs never execute anything themselves: ``plan(spec)`` compiles the axes
into an explicit cell list and ``execute(plan)`` runs it (see
``experiments.plan`` / ``experiments.execute``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = [
    "ProblemAxis", "StrategyAxis", "DelayAxis", "TrialsAxis",
    "PlacementAxis", "ObsAxis", "ExperimentSpec", "PLACEMENTS",
]


PLACEMENTS = ("single", "vmap", "sharded")


@dataclasses.dataclass(frozen=True)
class ProblemAxis:
    """One problem of the matrix.  Three variants, selected by ``kind``:

    * ``'synthetic'`` — the compare harness's quadratic:
      f(w) = 1/(2n)||Xw - y||^2 + lam h(w) on an lsq dataset of shape
      (n, p), built at plan time with the spec's master seed;
    * ``'spec'``      — a concrete, caller-built ``runtime.ProblemSpec``
      (arbitrary data) carried verbatim in ``problem``;
    * ``'workload'``  — a registered paper-§5 workload (ridge / lasso /
      logistic / mf) at one of its presets; the preset owns dims, cluster
      shape, step budget and the paper metric;
    * ``'train'``     — a neural LM from the model zoo trained with coded
      SGD (DESIGN §15): ``arch`` names the architecture, ``preset`` picks
      ``smoke``/``100m``, and the metric is the decoded training loss.
    """
    kind: str = "synthetic"
    # -- synthetic fields --
    n: int = 512
    p: int = 128
    noise: float = 0.5
    lam: float = 0.05
    h: str = "l2"
    seed: int | None = None        # None -> the spec's TrialsAxis seed
    # -- spec variant --
    problem: Any = None            # a runtime.ProblemSpec instance
    # -- workload variant --
    workload: str | None = None
    preset: str = "smoke"          # also the train-variant preset
    # -- train variant --
    arch: str | None = None
    seq_len: int = 64
    rows_per_worker: int = 1
    vocab: int = 512

    @staticmethod
    def synthetic(n: int = 512, p: int = 128, *, noise: float = 0.5,
                  lam: float = 0.05, h: str = "l2",
                  seed: int | None = None) -> "ProblemAxis":
        return ProblemAxis(kind="synthetic", n=n, p=p, noise=noise, lam=lam,
                           h=h, seed=seed)

    @staticmethod
    def from_spec(problem) -> "ProblemAxis":
        return ProblemAxis(kind="spec", problem=problem)

    @staticmethod
    def from_workload(name: str, preset: str = "smoke") -> "ProblemAxis":
        return ProblemAxis(kind="workload", workload=name, preset=preset)

    @staticmethod
    def train(arch: str = "deepseek-7b", *, preset: str = "smoke",
              seq_len: int = 64, rows_per_worker: int = 1,
              vocab: int = 512) -> "ProblemAxis":
        return ProblemAxis(kind="train", arch=arch, preset=preset,
                           seq_len=seq_len, rows_per_worker=rows_per_worker,
                           vocab=vocab)

    def validate(self) -> None:
        if self.kind not in ("synthetic", "spec", "workload", "train"):
            raise ValueError(f"unknown ProblemAxis kind '{self.kind}'")
        if self.kind == "workload" and not self.workload:
            raise ValueError("workload ProblemAxis needs a workload name")
        if self.kind == "spec" and self.problem is None:
            raise ValueError("spec ProblemAxis needs a ProblemSpec instance")
        if self.kind == "train" and not self.arch:
            raise ValueError("train ProblemAxis needs an arch name")


@dataclasses.dataclass(frozen=True)
class StrategyAxis:
    """One strategy column: registry name plus its per-strategy config.

    ``encoder=None`` keeps the strategy's own default; sync strategies read
    the policy fields, ``async`` reads ``staleness_bound`` /
    ``async_updates``.  ``options`` is an escape hatch of extra ``(key,
    value)`` pairs forwarded verbatim to the strategy/workload call
    (``step_size=``, ``memory=``, a prebuilt policy instance, ...).
    """
    name: str
    encoder: str | Any | None = None   # registry name or LinearEncoder
    policy: str | None = None          # None -> fastest-k
    k: int | None = None               # None -> 3m/4 (synthetic) / preset k
    deadline: float = 1.0              # --policy deadline budget
    policy_beta: float = 2.0           # --policy adaptive-k overlap beta
    staleness_bound: int | None = None   # async only
    async_updates: int | None = None     # async only
    # sub-k degradation policy (repro_torch.runtime.faults.make_degrade spec:
    # 'renormalize' | 'hold[:shrink=..]' | 'backoff[:base=..,retries=..]');
    # None keeps the default renormalized decode weights
    degrade: str | None = None
    options: tuple = ()                # extra (key, value) cfg pairs

    def options_dict(self) -> dict:
        return dict(self.options)


@dataclasses.dataclass(frozen=True)
class DelayAxis:
    """The simulated cluster: which delay distributions, how many workers.

    ``delays=()`` means "each workload's native paper delay model" (only
    valid when every problem is a workload).  ``m=None`` defers to the
    workload preset (or the compare default of 16 for synthetic problems).
    """
    delays: tuple = ()
    m: int | None = None
    compute_time: float = 0.05
    # fault-injection spec (repro_torch.runtime.faults.make_fault_model
    # grammar, e.g. 'crash:p=0.2,at=0.5;corrupt:p=0.05'); None = delay-only cluster
    faults: str | None = None

    @staticmethod
    def of(*delays: str, m: int | None = None,
           compute_time: float = 0.05,
           faults: str | None = None) -> "DelayAxis":
        return DelayAxis(delays=tuple(delays), m=m,
                         compute_time=compute_time, faults=faults)


@dataclasses.dataclass(frozen=True)
class TrialsAxis:
    """The Monte-Carlo axis: R delay realizations per cell, each seeded
    from the master ``seed`` via the ``(seed, r)`` child stream (DESIGN.md
    §9).  ``eval_every=s`` records the objective every s steps inside the
    compiled loop; ``eval_every=0`` records the final objective only."""
    trials: int = 1
    eval_every: int = 1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PlacementAxis:
    """How the realization axis is placed on hardware:

    * ``'single'``  — one run per realization, host loop (also what
      non-batchable lowerings do regardless of placement);
    * ``'vmap'``    — all R realizations in ONE device loop on one device
      (the batched runners, DESIGN.md §9);
    * ``'sharded'`` — R realizations spread over every visible card
      where there are more than one and they divide R (else the batched
      loop on one device); the record carries the device count.

    ``cell_batch=True`` (opt-in, ``mode='vmap'`` only) additionally stacks
    COMPATIBLE cells of the matrix — same problem, strategy, encoder
    config, worker count, step budget and trial count, differing only in
    delay model / policy / step size — into one device loop along the
    realization axis (``Strategy.run_cellbatched``).  Incompatible cells
    and obs-enabled runs fall back to per-cell execution.
    """
    mode: str = "vmap"
    mesh_axis: str = "trials"
    cell_batch: bool = False

    def validate(self) -> None:
        if self.mode not in PLACEMENTS:
            raise ValueError(f"unknown placement '{self.mode}'; have "
                             f"{PLACEMENTS}")


@dataclasses.dataclass(frozen=True)
class ObsAxis:
    """The observability axis (DESIGN.md §11): what ``execute`` records
    about HOW the matrix ran, on top of what it computed.

    All fields default off, and the default path is bit-identical to a run
    without the axis — records only grow ``host_s``/``compile_s``/
    ``execute_s``/``obs`` keys when ``enabled``, so legacy comparisons
    (execute == compare/workloads.run) stay exact.

    * ``trace``   — path prefix; write ``<trace>.jsonl`` (the canonical
      event stream) and ``<trace>.perfetto.json`` (Chrome/Perfetto
      ``trace_event`` view) after the matrix;
    * ``profile`` — directory; capture a ``torch.profiler`` trace per cell
      under ``<profile>/<cell>/`` plus device-memory high-water marks;
    * ``metrics`` — attach per-cell straggler metrics (miss-rate,
      active-set distribution, staleness histogram, latency percentiles)
      and the compile/execute split to every record.

    ``trace``/``profile`` imply ``metrics``-grade recording: any enabled
    field activates the :class:`repro_torch.obs.TraceRecorder` for the run.
    """
    trace: str | None = None
    profile: str | None = None
    metrics: bool = False

    @property
    def enabled(self) -> bool:
        return bool(self.trace or self.profile or self.metrics)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The full declarative experiment: problems x strategies x delays,
    run for R realizations under one placement.

    ``steps`` overrides every problem's iteration budget (synthetic
    default 200; workload presets own theirs).  Compile with
    ``experiments.plan``, run with ``experiments.execute``.
    """
    problems: tuple
    strategies: tuple
    delays: DelayAxis = DelayAxis()
    trials: TrialsAxis = TrialsAxis()
    placement: PlacementAxis = PlacementAxis()
    steps: int | None = None
    obs: ObsAxis = ObsAxis()

    def validate(self) -> None:
        if not self.problems:
            raise ValueError("ExperimentSpec needs at least one problem")
        if not self.strategies:
            raise ValueError("ExperimentSpec needs at least one strategy")
        for pr in self.problems:
            pr.validate()
        self.placement.validate()
        if self.trials.trials < 1:
            raise ValueError("trials must be >= 1")
        if not self.delays.delays:
            for pr in self.problems:
                if pr.kind != "workload":
                    raise ValueError(
                        "DelayAxis.delays may only be empty (= workload-"
                        "native delay models) when every problem is a "
                        "workload")
