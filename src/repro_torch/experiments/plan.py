"""Compile an :class:`ExperimentSpec` into an explicit cell list (a copy
of ``repro.experiments.plan``: the same spec plans the same cells).

``plan(spec)`` resolves every axis product up front — one
:class:`PlannedCell` per (problem, delay, strategy) with its worker count,
fastest-k, step budget and placement already decided — so ``execute`` is a
dumb loop and callers can inspect/filter/price a matrix before running it.
Cells that can never run (unknown strategy for a workload, a strategy the
workload's lowering cannot express) are materialized as skip-with-reason
cells HERE, carrying the exact reason the record will report.

Harness misconfigurations that would poison every cell (an ``eval_every``
that does not divide the step budget, an empty delay axis for a synthetic
problem) raise at plan time instead of emitting a matrix of skips.
"""
from __future__ import annotations

import dataclasses

from .spec import ExperimentSpec, ProblemAxis, StrategyAxis

__all__ = ["PlannedCell", "ExperimentPlan", "plan"]

# compare-harness defaults for synthetic problems (workload presets own
# their own cluster shape and step budget)
SYNTHETIC_M = 16
SYNTHETIC_STEPS = 200

# train-kind defaults: a tiny coded-DP cluster and a step budget sized so a
# smoke LM cell stays in CI territory (the example/bench drive longer runs)
TRAIN_M = 8
TRAIN_STEPS = 12

# strategies a train-kind cell can lower to: coded-sgd natively; 'uncoded'
# maps onto the same trainer with the identity code (the no-redundancy
# baseline).  Everything else is a convex-problem scheme.
_TRAIN_STRATEGIES = ("coded-sgd", "uncoded")


def _default_k(m: int) -> int:
    return max(1, (3 * m) // 4)


@dataclasses.dataclass(frozen=True)
class PlannedCell:
    """One fully resolved cell of the matrix."""
    index: int
    problem: ProblemAxis
    strategy: StrategyAxis
    resolved_strategy: str       # 'coded' alias resolved per workload
    delay: str
    m: int                       # engine worker count
    k: int | None                # fastest-k (None -> workload preset's k)
    steps: int | None            # None -> workload preset's budget
    trials: int
    eval_every: int
    seed: int
    placement: str
    compute_time: float
    skip: str | None = None      # pre-materialized skip reason
    metric_name: str = "objective"
    faults: str | None = None    # DelayAxis fault-injection spec
    degrade: str | None = None   # StrategyAxis sub-k degradation spec

    @property
    def kind(self) -> str:
        return self.problem.kind


@dataclasses.dataclass(frozen=True)
class ExperimentPlan:
    """The compiled experiment: the spec plus its explicit cell list."""
    spec: ExperimentSpec
    cells: tuple

    def __len__(self) -> int:
        return len(self.cells)

    @property
    def skipped(self) -> tuple:
        return tuple(c for c in self.cells if c.skip is not None)

    def describe(self) -> str:
        lines = [f"ExperimentPlan: {len(self.cells)} cells "
                 f"({len(self.skipped)} pre-skipped), "
                 f"trials={self.spec.trials.trials}, "
                 f"placement={self.spec.placement.mode}"]
        for c in self.cells:
            tag = (f"  [{c.index:3d}] "
                   f"{c.problem.workload or c.problem.kind:10s} "
                   f"{c.resolved_strategy:14s} x {c.delay:12s} "
                   f"m={c.m}")
            if c.skip is not None:
                tag += f"  SKIP: {c.skip}"
            lines.append(tag)
        return "\n".join(lines)


def plan(spec: ExperimentSpec) -> ExperimentPlan:
    """Resolve the axis product into an explicit, validated cell list."""
    from repro_torch.runtime.faults import make_degrade, make_fault_model
    from repro_torch.runtime.strategies import check_trials, get_strategy
    from repro_torch.workloads import get_workload

    spec.validate()
    # malformed fault / degrade specs poison every cell -> raise at plan time
    make_fault_model(spec.delays.faults)
    for st in spec.strategies:
        make_degrade(st.degrade)
    tr, pl = spec.trials, spec.placement
    cells: list[PlannedCell] = []
    for pr in spec.problems:
        if pr.kind == "workload":
            wl = get_workload(pr.workload)
            ps = wl.preset(pr.preset)
            check_trials(spec.steps if spec.steps is not None else ps.steps,
                         tr.trials, tr.eval_every)
            m = spec.delays.m if spec.delays.m is not None else ps.m
            delays = spec.delays.delays or (ps.delay,)
            for delay in delays:
                for st in spec.strategies:
                    resolved = wl.resolve_strategy(st.name)
                    cells.append(PlannedCell(
                        index=len(cells), problem=pr, strategy=st,
                        resolved_strategy=resolved, delay=delay, m=m,
                        k=st.k, steps=spec.steps, trials=tr.trials,
                        eval_every=tr.eval_every, seed=tr.seed,
                        placement=pl.mode,
                        compute_time=spec.delays.compute_time,
                        skip=wl.skip_reason(st.name),
                        metric_name=wl.metric_name,
                        faults=spec.delays.faults, degrade=st.degrade))
        elif pr.kind == "train":
            steps = spec.steps if spec.steps is not None else TRAIN_STEPS
            check_trials(steps, tr.trials, tr.eval_every)
            m = spec.delays.m if spec.delays.m is not None else TRAIN_M
            for delay in spec.delays.delays:
                for st in spec.strategies:
                    get_strategy(st.name)   # unknown name -> KeyError now
                    skip = (None if st.name in _TRAIN_STRATEGIES else
                            f"strategy '{st.name}' has no train-kind "
                            f"lowering (coded-sgd/uncoded only)")
                    cells.append(PlannedCell(
                        index=len(cells), problem=pr, strategy=st,
                        resolved_strategy=st.name, delay=delay, m=m,
                        k=st.k if st.k is not None else _default_k(m),
                        steps=steps, trials=tr.trials,
                        eval_every=tr.eval_every, seed=tr.seed,
                        placement=pl.mode,
                        compute_time=spec.delays.compute_time,
                        skip=skip, metric_name="loss",
                        faults=spec.delays.faults, degrade=st.degrade))
        else:
            steps = spec.steps if spec.steps is not None else SYNTHETIC_STEPS
            check_trials(steps, tr.trials, tr.eval_every)
            m = spec.delays.m if spec.delays.m is not None else SYNTHETIC_M
            for delay in spec.delays.delays:
                for st in spec.strategies:
                    get_strategy(st.name)   # unknown name -> KeyError now
                    cells.append(PlannedCell(
                        index=len(cells), problem=pr, strategy=st,
                        resolved_strategy=st.name, delay=delay, m=m,
                        k=st.k if st.k is not None else _default_k(m),
                        steps=steps, trials=tr.trials,
                        eval_every=tr.eval_every, seed=tr.seed,
                        placement=pl.mode,
                        compute_time=spec.delays.compute_time,
                        metric_name="objective",
                        faults=spec.delays.faults, degrade=st.degrade))
    return ExperimentPlan(spec=spec, cells=tuple(cells))
