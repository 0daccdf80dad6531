"""Run an :class:`ExperimentPlan` and collect canonical per-cell records.

Port of ``repro.experiments.execute``.  This is the ONE place where "how a
cell executes" is decided — every harness (``repro_torch.experiments.run``,
the legacy ``runtime.compare`` and ``workloads.run`` CLIs) funnels through
``execute(plan, device=...)``:

  * synthetic/spec problems run through the strategy registry
    (``Strategy.run`` / ``run_batched`` / ``run_cellbatched``), workload
    problems through ``Workload.run`` / ``run_trials``, every one of them
    on the device ``execute`` was given — CUDA unless the caller passes
    ``device="cpu"``.  The device is an argument, not a spec field, so a
    spec's hash and records are the reference's; it goes into the run
    manifest's provenance.  The plan's placement decides whether R
    realizations run one at a time (``single``) or as one device loop
    (``vmap``, ``sharded``);
  * every cell yields one **canonical record** (see below) plus the raw
    result object for programmatic callers.

Train-kind cells (coded SGD over the model zoo) are not ported yet: a plan
that holds one is refused before any cell runs.

Canonical record schema (the union of the three legacy schemas; every
record carries the core keys, workload records add theirs):

  core:      strategy, delay, seed, metric_name, final_metric,
             final_objective, wallclock_s, times, objective, meta
  synthetic: n, p, m, k
  workload:  workload, preset, metric_times, metric, extras
  batched:   trials, summary {mean/p50/p95 wall-clock + finals}
  skipped:   the identifying keys + ``skipped`` (the reason) only
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import time
from typing import Any

import numpy as np

from repro_torch.device import resolve_device

from .io import (print_table, write_json, write_metrics_csv,
                 write_summary_csv, write_trace_csv)
from .plan import ExperimentPlan, PlannedCell
from .spec import ExperimentSpec, ObsAxis

__all__ = ["CellOutcome", "ExperimentResult", "execute", "run",
           "resolve_policy", "trials_record", "cell_label"]


def resolve_policy(name: str, m: int, k: int, *, deadline: float = 1.0,
                   beta: float = 2.0):
    """Build an active-set policy from its CLI name + cell shape."""
    from repro_torch.runtime.engine import make_policy
    if name in ("fastest-k", "adversarial"):
        return make_policy(name, k=k)
    if name == "adaptive-k":
        # k acts as the floor; the policy grows the set per the overlap rule
        return make_policy(name, beta=beta, k_min=k)
    if name == "deadline":
        return make_policy(name, deadline=deadline, k_min=max(1, m // 4))
    raise KeyError(f"unknown policy '{name}'")


def trials_record(results: list, *, delay: str, seed: int) -> dict:
    """Aggregate R per-realization workload results into ONE JSON record:
    stacked per-realization traces plus mean/p50/p95 wall-clock and metric
    summaries.  Scalar ``final_metric`` / ``final_objective`` /
    ``wallclock_s`` are across-trial means, so batched records drop into
    every single-trial consumer (summary CSV, tables)."""
    from repro_torch.runtime.strategies import json_safe_meta, summary_stats
    r0 = results[0]
    final_metric = [r.final_metric for r in results]
    final_obj = [r.final_objective for r in results]
    wallclock = [r.wallclock for r in results]
    return {
        "workload": r0.workload, "strategy": r0.strategy,
        "preset": r0.preset, "metric_name": r0.metric_name,
        "delay": delay, "seed": seed, "trials": len(results),
        "final_metric": float(np.mean(final_metric)),
        "final_objective": float(np.mean(final_obj)),
        "wallclock_s": float(np.mean(wallclock)),
        "summary": {"trials": len(results),
                    "wallclock_s": summary_stats(wallclock),
                    "final_metric": summary_stats(final_metric),
                    "final_objective": summary_stats(final_obj)},
        "times": [np.asarray(r.times, dtype=float).tolist()
                  for r in results],
        "objective": [np.asarray(r.objective, dtype=float).tolist()
                      for r in results],
        "metric_times": [np.asarray(r.metric_times, dtype=float).tolist()
                         for r in results],
        "metric": [np.asarray(r.metric, dtype=float).tolist()
                   for r in results],
        "extras": [r.extras for r in results],
        "meta": json_safe_meta(r0.meta),
    }


@dataclasses.dataclass
class CellOutcome:
    """One executed cell: the canonical record plus the raw result object
    (RunResult / TrialsResult / WorkloadRunResult / list of them; None for
    a skipped cell) for callers that need iterates or schedules."""
    cell: PlannedCell
    record: dict
    result: Any = None

    @property
    def skipped(self) -> bool:
        return "skipped" in self.record


@dataclasses.dataclass
class ExperimentResult:
    """Everything ``execute`` produced, with the shared writers attached.
    ``recorder`` is the run's :class:`repro_torch.obs.TraceRecorder` when the
    spec's :class:`ObsAxis` was enabled, else None."""
    plan: ExperimentPlan
    outcomes: list
    recorder: Any = None
    run_id: str | None = None      # run-store id when the run was recorded
    device: Any = None             # the torch.device the cells ran on

    @property
    def spec(self) -> ExperimentSpec:
        return self.plan.spec

    @property
    def records(self) -> list[dict]:
        return [o.record for o in self.outcomes]

    def to_json(self, path: str) -> None:
        write_json(self.records, path)

    def to_csv(self, path: str) -> None:
        write_trace_csv(self.records, path)

    def to_summary_csv(self, path: str) -> None:
        write_summary_csv(self.records, path)

    def print_table(self) -> None:
        print_table(self.records)

    def to_metrics_csv(self, path: str) -> None:
        write_metrics_csv(self.records, path)


def cell_label(cell: PlannedCell) -> str:
    """The stable human-readable id obs events carry for one cell."""
    if cell.kind == "workload":
        prefix = f"{cell.problem.workload}/"
    elif cell.kind == "train":
        prefix = f"{cell.problem.arch}/"
    else:
        prefix = ""
    return f"{prefix}{cell.resolved_strategy}x{cell.delay}"


def execute(plan: ExperimentPlan, *, device=None, record_to=None,
            retries: int = 0, retry_base: float = 0.5,
            resume: str | None = None) -> ExperimentResult:
    """Run every planned cell on ``device`` (unset: CUDA, which raises
    without a card); never aborts mid-matrix for per-cell
    incompatibilities (those become skip-with-reason records).  A plan
    that holds a train-kind cell is refused with ``NotImplementedError``
    before anything runs or is recorded.

    When the spec carries an enabled :class:`ObsAxis`, the whole matrix runs
    under an active :class:`repro_torch.obs.TraceRecorder`: every record gains
    ``host_s``/``compile_s``/``execute_s``/``compiles`` (the CompileWatch
    split) plus an ``obs`` per-cell metrics summary, and ``obs.trace`` /
    ``obs.profile`` write the trace / profiler artifacts.  With the axis
    off (the default) records are bit-identical to pre-obs builds.

    Every run additionally leaves a provenance manifest in the run store
    (``repro_torch.obs.runstore``) — ``record_to`` controls where: ``None``
    uses the ``REPRO_RUNSTORE``-governed default store, ``False`` skips
    recording (benchmark timing loops), a :class:`RunStore` or path
    records there.  The manifest opens with ``status: "running"`` before
    the first cell and each completed cell record streams to
    ``<run_id>/cells/<index>.json``, so a killed matrix is resumable:
    ``resume="RUN_ID"`` (or ``latest``) replays the streamed records —
    after verifying the plan's spec hash matches the recorded run's — and
    executes only the cells that never finished.  Resumed outcomes carry
    the persisted record with ``result=None`` (raw result objects are not
    serialized).

    ``retries`` re-runs a cell whose execution RAISED (host crash, OOM —
    not the in-simulation faults, and not per-cell ``ValueError``
    incompatibilities, which are already skip records) up to that many
    extra times with capped exponential backoff (``retry_base * 2**i``
    seconds, ±25% deterministic jitter, 30 s cap); the last failure
    re-raises, and the streamed records make the partial matrix resumable.
    """
    train = [c.index for c in plan.cells if c.kind == "train"]
    if train:
        raise NotImplementedError(
            f"cells {train} are train-kind (coded SGD over the model zoo), "
            f"which the port does not have yet (ROADMAP Queue 1 item 4); "
            f"nothing was run")
    dev = resolve_device(device)
    obs = getattr(plan.spec, "obs", None)
    cell_batch = getattr(plan.spec.placement, "cell_batch", False)
    store, run_id, done = _open_run(plan, record_to, resume, dev)
    runner = _CellRunner(retries=retries, retry_base=retry_base,
                         store=store, run_id=run_id, done=done, device=dev)
    if obs is None or not obs.enabled:
        if cell_batch:
            result = ExperimentResult(
                plan=plan, outcomes=_execute_cellbatched(plan, runner))
        else:
            result = ExperimentResult(
                plan=plan,
                outcomes=[runner.run(cell) for cell in plan.cells])
    else:
        if cell_batch:
            # per-cell CompileWatch/metrics attribution needs one dispatch
            # per cell; keep the obs contract and run the matrix unbatched
            print("# obs axis enabled: cell batching falls back to "
                  "per-cell execution")
        result = _execute_observed(plan, obs, runner)
    result.device = dev
    _finish_run(result, store, run_id)
    return result


def _resolve_store(record_to):
    """The run store ``record_to`` selects (None when recording is off)."""
    if record_to is False:
        return None
    from repro_torch.obs.runstore import RunStore, default_store
    if record_to is None:
        return default_store()
    if isinstance(record_to, RunStore):
        return record_to
    return RunStore(str(record_to))


def _open_run(plan: ExperimentPlan, record_to, resume, device):
    """Open the run-store side of one matrix: a fresh ``running`` manifest,
    or — with ``resume`` — the prior run's identity plus its streamed cell
    records.  Returns ``(store, run_id, {cell index: record})``."""
    store = _resolve_store(record_to)
    if resume is None:
        if store is None:
            return None, None, {}
        from repro_torch.obs.runstore import begin_experiment
        try:
            run_id = begin_experiment(plan.spec, store=store,
                                      total_cells=len(plan.cells),
                                      device=device)
        except Exception as e:                    # noqa: BLE001
            # best-effort: a full store disk must never fail the experiment
            print(f"# runstore: manifest not recorded: {e}")
            return None, None, {}
        return store, run_id, {}
    if store is None:
        raise ValueError(
            "resume needs an enabled run store (REPRO_RUNSTORE, or an "
            "explicit record_to)")
    from repro_torch.obs.runstore import completed_cells, spec_hash
    manifest = store.resolve(str(resume))
    want, got = spec_hash(plan.spec), manifest.get("spec_hash")
    if got != want:
        raise ValueError(
            f"resume {manifest.get('run_id')}: spec hash mismatch (run "
            f"{got}, plan {want}) — resuming would mix records from "
            f"different matrices")
    run_id = manifest["run_id"]
    done = completed_cells(store, run_id)
    print(f"# resuming {run_id}: {len(done)}/{len(plan.cells)} cells "
          f"already recorded")
    return store, run_id, done


def _finish_run(result: ExperimentResult, store, run_id) -> None:
    """Finalize the running manifest (best-effort, like _open_run)."""
    if store is None or run_id is None:
        return
    result.run_id = run_id
    from repro_torch.obs.runstore import finish_experiment
    try:
        finish_experiment(result, store, run_id)
    except Exception as e:                        # noqa: BLE001
        print(f"# runstore: manifest not finalized: {e}")


def _retry_delay(base: float, attempt: int, index: int,
                 cap: float = 30.0) -> float:
    """Backoff before retry ``attempt`` (1-based) of one cell: capped
    exponential with ±25% jitter derived from (cell, attempt) — spreads
    concurrent harnesses without introducing host randomness."""
    d = base * (2.0 ** (attempt - 1))
    h = hashlib.sha256(f"{index}:{attempt}".encode()).digest()[0] / 255.0
    return min(cap, d * (0.75 + 0.5 * h))     # cap bounds the jittered wait


class _CellRunner:
    """Per-cell execution policy for one matrix: the device, the shared
    problem/data caches, crash retry with capped exponential backoff, and
    the streamed run-store records that make a killed matrix resumable."""

    def __init__(self, *, retries: int = 0, retry_base: float = 0.5,
                 store=None, run_id=None, done=None, device=None):
        self.device = device
        self.caches: dict = {}
        self.retries = max(0, int(retries))
        self.retry_base = float(retry_base)
        self.store = store
        self.run_id = run_id
        self.done = dict(done or {})

    def resumed(self, cell: PlannedCell) -> "CellOutcome | None":
        """The persisted outcome of an already-completed cell, or None."""
        if cell.index not in self.done:
            return None
        return CellOutcome(cell, self.done[cell.index])

    def run(self, cell: PlannedCell, *, persist: bool = True) -> "CellOutcome":
        oc = self.resumed(cell)
        if oc is not None:
            return oc
        oc = self._attempt(cell)
        if persist:
            self.persist(oc)
        return oc

    def _attempt(self, cell: PlannedCell) -> "CellOutcome":
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                delay = _retry_delay(self.retry_base, attempt, cell.index)
                print(f"# cell {cell.index} ({cell_label(cell)}) raised "
                      f"{type(last).__name__}: {last}; retry {attempt}/"
                      f"{self.retries} in {delay:.2f}s")
                time.sleep(delay)
            try:
                return _execute_cell(cell, self.caches, self.device)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:                # noqa: BLE001
                last = e
        assert last is not None
        raise last

    def persist(self, oc: "CellOutcome") -> None:
        """Stream one finished cell record (best-effort; no-op for cells
        that were loaded from a resumed run)."""
        if (self.store is None or self.run_id is None
                or oc.cell.index in self.done):
            return
        from repro_torch.obs.runstore import record_cell
        try:
            record_cell(self.store, self.run_id, oc.cell.index, oc.record)
        except Exception as e:                    # noqa: BLE001
            print(f"# runstore: cell {oc.cell.index} not recorded: {e}")


def _execute_observed(plan: ExperimentPlan, obs: ObsAxis,
                      runner: _CellRunner) -> ExperimentResult:
    from repro_torch.obs import (CompileWatch, TraceRecorder, cell_summary,
                           memory_high_water, profile_region)
    dev = runner.device
    rec = TraceRecorder(meta={"cells": len(plan.cells),
                              "trials": plan.spec.trials.trials,
                              "placement": plan.spec.placement.mode})
    outcomes: list = []
    with rec.activate():
        for cell in plan.cells:
            resumed = runner.resumed(cell)
            if resumed is not None:
                # a resumed record keeps its original obs attribution —
                # nothing ran here to watch
                outcomes.append(resumed)
                continue
            label = cell_label(cell)
            mark = rec.checkpoint()
            prof = (profile_region(os.path.join(obs.profile,
                                                f"cell{cell.index:03d}"),
                                   device=dev)
                    if obs.profile and cell.skip is None
                    else contextlib.nullcontext())
            with rec.cell(label), prof, CompileWatch() as cw:
                outcome = runner.run(cell, persist=False)
            if not outcome.skipped:
                summary = cell_summary(rec.sources_since(mark))
                if obs.profile:
                    hwm = memory_high_water(dev)
                    if hwm is not None:
                        summary["memory_high_water_bytes"] = int(hwm)
                outcome.record.update(
                    host_s=cw.total_s, compile_s=cw.compile_s,
                    execute_s=cw.execute_s, compiles=cw.compiles,
                    obs=summary)
            runner.persist(outcome)
            outcomes.append(outcome)
    if obs.trace:
        prefix = obs.trace[:-len(".jsonl")] \
            if obs.trace.endswith(".jsonl") else obs.trace
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        rec.to_jsonl(prefix + ".jsonl")
        rec.to_perfetto(prefix + ".perfetto.json")
    return ExperimentResult(plan=plan, outcomes=outcomes, recorder=rec)


def run(spec: ExperimentSpec, *, device=None) -> ExperimentResult:
    """``execute(plan(spec), device=device)`` in one call."""
    from .plan import plan as _plan
    return execute(_plan(spec), device=device)


# ---------------------------------------------------------------------------
# Cell execution
# ---------------------------------------------------------------------------

def _engine(cell: PlannedCell):
    from repro_torch.runtime.engine import ClusterEngine, make_delay_model
    return ClusterEngine(make_delay_model(cell.delay), cell.m,
                         compute_time=cell.compute_time, seed=cell.seed,
                         faults=cell.faults)


def _execute_cell(cell: PlannedCell, caches: dict, device) -> CellOutcome:
    if cell.kind == "workload":
        return _execute_workload_cell(cell, caches, device)
    return _execute_synthetic_cell(cell, caches, device)


def _synthetic_problem(cell: PlannedCell, caches: dict):
    from repro_torch.runtime.strategies import ProblemSpec
    key = ("problem", id(cell.problem))
    if key not in caches:
        pr = cell.problem
        if pr.kind == "spec":
            caches[key] = pr.problem
        else:
            seed = pr.seed if pr.seed is not None else cell.seed
            caches[key] = ProblemSpec.synthetic(
                pr.n, pr.p, noise=pr.noise, lam=pr.lam, h=pr.h, seed=seed)
    return caches[key]


def _execute_synthetic_cell(cell: PlannedCell, caches: dict,
                            device) -> CellOutcome:
    from repro_torch.runtime.strategies import get_strategy
    spec_ = _synthetic_problem(cell, caches)
    st = cell.strategy
    engine = _engine(cell)
    cfg = st.options_dict()
    if cell.resolved_strategy == "async":
        if st.staleness_bound is not None:
            cfg.setdefault("staleness_bound", st.staleness_bound)
        if st.async_updates is not None:
            cfg.setdefault("updates", st.async_updates)
    else:
        if cell.resolved_strategy.startswith("coded"):
            cfg.setdefault("encoder", st.encoder if st.encoder is not None
                           else "hadamard")
        cfg.setdefault("policy", resolve_policy(
            st.policy or "fastest-k", cell.m, cell.k,
            deadline=st.deadline, beta=st.policy_beta))
    if cell.degrade is not None:
        cfg.setdefault("degrade", cell.degrade)
    base = {"strategy": cell.resolved_strategy, "delay": cell.delay,
            "n": spec_.n, "p": spec_.p, "m": cell.m, "k": cell.k,
            "seed": cell.seed}
    try:
        if cell.trials > 1:
            result = get_strategy(cell.resolved_strategy).run_batched(
                spec_, engine, steps=cell.steps, trials=cell.trials,
                eval_every=cell.eval_every, placement=cell.placement,
                device=device, **cfg)
        else:
            result = get_strategy(cell.resolved_strategy).run(
                spec_, engine, steps=cell.steps, device=device, **cfg)
    except ValueError as e:
        print(f"# skipping {cell.resolved_strategy} x {cell.delay}: {e}")
        return CellOutcome(cell, {**base, "skipped": str(e),
                                  "metric_name": "objective"})
    rec = result.to_record()
    rec.update(base, metric_name="objective",
               final_metric=rec["final_objective"])
    return CellOutcome(cell, rec, result)


# ---------------------------------------------------------------------------
# Cell batching: compatible cells -> one device loop (DESIGN.md §12)
# ---------------------------------------------------------------------------

# strategies whose hot path is the batched_scan_gd/prox runner — the only
# ones where stacking cells along the realization axis is a pure reshape
_CELLBATCH_STRATEGIES = ("coded-gd", "coded-prox", "uncoded", "replication")


def _freeze(v):
    try:
        hash(v)
    except TypeError:
        return id(v)
    return v


def _cellbatch_key(cell: PlannedCell):
    """Group key for one cell, or None when the cell must run on its own.

    Cells in one group share one device loop, so everything that
    shapes or re-parameterizes it is in the key: problem identity, strategy,
    encoder config, m, steps, trials, eval_every, seed, extra options, and
    the fault/degrade specs (degrade is a static argument of the fused
    runners; ``run_cellbatched`` rejects mixed-degrade batches as a
    backstop).  Delay model / compute time / policy / k / step size are
    FREE axes — they only change the sampled schedules and the
    per-realization step vector.
    """
    if (cell.kind in ("workload", "train") or cell.skip is not None
            or cell.placement != "vmap"
            or cell.resolved_strategy not in _CELLBATCH_STRATEGIES):
        return None
    st = cell.strategy
    opts = tuple(sorted((k, _freeze(v)) for k, v in st.options
                        if k != "step_size"))
    return (cell.resolved_strategy, id(cell.problem), cell.m, cell.steps,
            cell.trials, cell.eval_every, cell.seed, _freeze(st.encoder),
            cell.faults, cell.degrade, opts)


def _cell_cfg(cell: PlannedCell) -> dict:
    """The per-cell strategy config, exactly as ``_execute_synthetic_cell``
    builds it for the sync-gradient family."""
    st = cell.strategy
    cfg = st.options_dict()
    if cell.resolved_strategy.startswith("coded"):
        cfg.setdefault("encoder", st.encoder if st.encoder is not None
                       else "hadamard")
    cfg.setdefault("policy", resolve_policy(
        st.policy or "fastest-k", cell.m, cell.k,
        deadline=st.deadline, beta=st.policy_beta))
    if cell.degrade is not None:
        cfg.setdefault("degrade", cell.degrade)
    return cfg


def _execute_cell_group(cells: list, runner: _CellRunner) -> list:
    """One device loop for a group of compatible cells; any
    incompatibility the strategy detects at run time falls back to the
    per-cell path (same records, minus the sharing)."""
    from repro_torch.runtime.strategies import get_strategy
    spec_ = _synthetic_problem(cells[0], runner.caches)
    engines = [_engine(cell) for cell in cells]
    cfgs = [_cell_cfg(cell) for cell in cells]
    strat = get_strategy(cells[0].resolved_strategy)
    try:
        results = strat.run_cellbatched(
            spec_, engines, steps=cells[0].steps, trials=cells[0].trials,
            eval_every=cells[0].eval_every, cfgs=cfgs, device=runner.device)
    except ValueError as e:
        print(f"# cell batch of {len(cells)} "
              f"{cells[0].resolved_strategy} cells fell back to per-cell "
              f"execution: {e}")
        return [runner.run(cell, persist=False) for cell in cells]
    outcomes = []
    for cell, result in zip(cells, results):
        base = {"strategy": cell.resolved_strategy, "delay": cell.delay,
                "n": spec_.n, "p": spec_.p, "m": cell.m, "k": cell.k,
                "seed": cell.seed}
        if cell.trials == 1:
            # single-trial cells report the RunResult schema (scalar trace
            # rows), like the unbatched executor; the batching marker stays
            one = result.realization(0)
            for key in ("trials", "eval_every", "batched"):
                one.meta.pop(key, None)
            rec = one.to_record()
            result = one
        else:
            rec = result.to_record()
        rec.update(base, metric_name="objective",
                   final_metric=rec["final_objective"])
        outcomes.append(CellOutcome(cell, rec, result))
    return outcomes


def _execute_cellbatched(plan: ExperimentPlan, runner: _CellRunner) -> list:
    """Group compatible PENDING cells (resumed cells replay their streamed
    records), run each group as one device loop, and return outcomes in
    plan order."""
    groups: dict = {}
    by_index: dict = {}
    for cell in plan.cells:
        resumed = runner.resumed(cell)
        if resumed is not None:
            by_index[cell.index] = resumed
            continue
        groups.setdefault(_cellbatch_key(cell), []).append(cell)
    for key, cells in groups.items():
        if key is None or len(cells) == 1:
            for cell in cells:
                by_index[cell.index] = runner.run(cell)
        else:
            for cell, oc in zip(cells, _execute_cell_group(cells, runner)):
                runner.persist(oc)
                by_index[cell.index] = oc
    return [by_index[cell.index] for cell in plan.cells]


def _workload_data(cell: PlannedCell, wl, ps, caches: dict):
    key = ("data", cell.problem.workload, cell.problem.preset)
    if key not in caches:
        caches[key] = wl.build(ps)
    return caches[key]


def _execute_workload_cell(cell: PlannedCell, caches: dict,
                           device) -> CellOutcome:
    from repro_torch.workloads import UnsupportedStrategy, get_workload
    pr, st = cell.problem, cell.strategy
    wl = get_workload(pr.workload)
    ps = wl.preset(pr.preset)
    base = {"workload": wl.name, "strategy": cell.resolved_strategy,
            "delay": cell.delay, "preset": ps.name, "seed": cell.seed}
    if cell.skip is not None:
        return CellOutcome(cell, {**base, "skipped": cell.skip,
                                  "metric_name": wl.metric_name})
    data = _workload_data(cell, wl, ps, caches)
    engine = _engine(cell)
    cell_cfg = st.options_dict()
    if st.k is not None:
        cell_cfg.setdefault("k", st.k)
    if cell.steps is not None:
        cell_cfg.setdefault("steps", cell.steps)
    if st.encoder is not None:
        cell_cfg.setdefault("encoder", st.encoder)
    if not cell.resolved_strategy.startswith("coded"):
        # encoder targets the coded scheme; uncoded/replication keep their
        # defining encoders.
        cell_cfg.pop("encoder", None)
    # strategy-level config flows into the workload's strategy dispatch the
    # same way it does for synthetic cells — a StrategyAxis field the user
    # set must never be silently dropped
    if cell.resolved_strategy == "async":
        if st.staleness_bound is not None:
            cell_cfg.setdefault("staleness_bound", st.staleness_bound)
        if st.async_updates is not None:
            cell_cfg.setdefault("updates", st.async_updates)
    elif st.policy is not None:
        k = st.k if st.k is not None else ps.k
        cell_cfg.setdefault("policy", resolve_policy(
            st.policy, cell.m, k, deadline=st.deadline,
            beta=st.policy_beta))
    if cell.degrade is not None and cell.resolved_strategy != "async":
        # flows through the workload lowering into the registry strategy,
        # which pops it (async has no barrier to degrade)
        cell_cfg.setdefault("degrade", cell.degrade)
    try:
        if cell.trials > 1:
            results = wl.run_trials(st.name, engine, preset=ps, data=data,
                                    trials=cell.trials,
                                    eval_every=cell.eval_every,
                                    placement=cell.placement, device=device,
                                    **cell_cfg)
            return CellOutcome(
                cell, {**base, **trials_record(results, delay=cell.delay,
                                               seed=cell.seed)}, results)
        result = wl.run(st.name, engine, preset=ps, data=data,
                        device=device, **cell_cfg)
    except ValueError as e:
        # UnsupportedStrategy (runtime-detected), or a config clash (e.g.
        # --m below the preset's k) — record the reason, keep the matrix
        # going (same contract as the synthetic path)
        if not isinstance(e, UnsupportedStrategy):
            print(f"# skipping {cell.resolved_strategy} x {cell.delay}: {e}")
        return CellOutcome(cell, {**base, "skipped": str(e),
                                  "metric_name": wl.metric_name})
    rec = result.to_record()
    rec.update(delay=cell.delay, seed=cell.seed)
    return CellOutcome(cell, rec, result)
