"""repro_torch.experiments — declarative spec -> plan -> execute
(DESIGN.md §10).

Port of ``repro.experiments``: the same specs, plans and canonical records,
with ``execute(plan, device=...)`` running every cell on the CUDA card
unless the caller passes ``device="cpu"``.

ONE way to express every paper-§5 matrix: an :class:`ExperimentSpec`
(problems x strategies x delays x trials x placement) compiles to an
explicit :class:`ExperimentPlan` (skip-with-reason cells materialized up
front) and runs to an :class:`ExperimentResult` with one canonical record
per cell and shared JSON/CSV writers.

    from repro_torch.experiments import (ExperimentSpec, ProblemAxis,
                                         StrategyAxis, TrialsAxis, run)
    result = run(ExperimentSpec(
        problems=(ProblemAxis.from_workload("ridge"),),
        strategies=(StrategyAxis("coded"), StrategyAxis("uncoded")),
        trials=TrialsAxis(trials=8)), device="cpu")
    result.to_json("runs/ridge.json")

CLI:  PYTHONPATH=src python -m repro_torch.experiments.run \\
          --workloads ridge --strategies coded,uncoded \\
          --trials 8 --placement sharded

The legacy ``runtime.compare`` and ``workloads.run`` CLIs are thin
front-ends over this path (see DESIGN.md §10 for the migration table).
"""
from .execute import (CellOutcome, ExperimentResult, cell_label, execute,
                      resolve_policy, run, trials_record)
from .io import (print_table, trace_rows, write_json, write_metrics_csv,
                 write_summary_csv, write_trace_csv)
from .plan import ExperimentPlan, PlannedCell, plan
from .spec import (PLACEMENTS, DelayAxis, ExperimentSpec, ObsAxis,
                   PlacementAxis, ProblemAxis, StrategyAxis, TrialsAxis)

__all__ = [
    "PLACEMENTS", "ProblemAxis", "StrategyAxis", "DelayAxis", "TrialsAxis",
    "PlacementAxis", "ObsAxis", "ExperimentSpec", "PlannedCell",
    "ExperimentPlan", "plan", "CellOutcome", "ExperimentResult", "execute",
    "run", "resolve_policy", "trials_record", "cell_label", "write_json",
    "write_trace_csv", "write_summary_csv", "write_metrics_csv",
    "trace_rows", "print_table",
]
