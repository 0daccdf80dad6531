"""Workload experiment runner CLI — legacy front-end (DESIGN.md §10).

Port of ``repro.workloads.runner``: a thin shim that compiles the
reference's flags, plus ``--device`` (unset: the CUDA card), into a
``repro_torch.experiments.ExperimentSpec`` and delegates to the unified
``plan -> execute`` path.  Records, JSON and summary-CSV outputs have the
reference's schema; new code should use ``python -m
repro_torch.experiments.run`` or the ``repro_torch.experiments`` API
directly.

    PYTHONPATH=src python -m repro_torch.workloads.run --device cpu \\
        --workload mf --preset smoke \\
        --strategies coded-lbfgs,replication,uncoded

``--strategies coded,...`` resolves 'coded' per workload (ridge ->
coded-lbfgs, lasso -> coded-prox, logistic -> coded-bcd, mf -> coded-lbfgs).
Outputs: ``<out>/workloads.json`` (full traces) and ``<out>/summary.csv``.
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

from repro_torch.experiments import (DelayAxis, ExperimentSpec, ObsAxis,
                               PlacementAxis, ProblemAxis, StrategyAxis,
                               TrialsAxis, execute, plan, print_table,
                               trials_record, write_json, write_metrics_csv,
                               write_summary_csv)
from repro_torch.workloads.base import available_workloads

__all__ = ["run_workload_matrix", "trials_record", "write_json",
           "write_summary_csv", "write_metrics_csv", "main"]


def run_workload_matrix(workloads: Sequence[str], strategies: Sequence[str],
                        *, preset: str = "smoke",
                        delays: Sequence[str] | None = None, seed: int = 0,
                        m: int | None = None, compute_time: float = 0.05,
                        trials: int = 1, eval_every: int = 1,
                        placement: str = "vmap",
                        obs: ObsAxis | None = None, device=None,
                        **cfg) -> list[dict]:
    """Run every (workload, delay, strategy) cell on ``device`` (unset:
    CUDA); returns one record each.

    Legacy API shim over ``repro_torch.experiments``: ``delays=None`` uses each
    workload's native paper delay model, ``m`` overrides the preset's
    worker count, and extra ``cfg`` (``k=``, ``encoder=``, ``steps=``, and
    any strategy kwargs) is forwarded to every cell.  ``trials=R`` stacks R
    delay realizations per cell (one device loop where the lowering
    allows, with ``placement`` choosing single/vmap/sharded
    execution) and the record carries mean/p50/p95 summaries.  ``obs`` is
    the optional observability axis (trace export / per-cell metrics);
    default None keeps the legacy record schema byte-for-byte.
    """
    cfg = dict(cfg)
    k = cfg.pop("k", None)
    steps = cfg.pop("steps", None)
    encoder = cfg.pop("encoder", None)
    spec = ExperimentSpec(
        problems=tuple(ProblemAxis.from_workload(w, preset)
                       for w in workloads),
        strategies=tuple(StrategyAxis(name=s, encoder=encoder, k=k,
                                      options=tuple(cfg.items()))
                         for s in strategies),
        delays=DelayAxis(delays=tuple(delays or ()), m=m,
                         compute_time=compute_time),
        trials=TrialsAxis(trials=trials, eval_every=eval_every, seed=seed),
        placement=PlacementAxis(mode=placement), steps=steps,
        obs=obs if obs is not None else ObsAxis())
    return execute(plan(spec), device=device).records


def main(argv: Sequence[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="repro_torch.workloads.run",
        description="paper-§5 workload zoo experiment runner (legacy "
                    "front-end over repro_torch.experiments)")
    ap.add_argument("--workload", default="all",
                    help=f"comma list from {available_workloads()}, or 'all'")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "bench", "paper"])
    ap.add_argument("--strategies", default="coded,uncoded,replication",
                    help="comma list; 'coded' resolves per workload")
    ap.add_argument("--delays", default=None,
                    help="comma list of delay models (default: each "
                         "workload's native paper model)")
    ap.add_argument("--k", type=int, default=None,
                    help="fastest-k override (default: preset k)")
    ap.add_argument("--steps", type=int, default=None,
                    help="outer/inner step budget override")
    ap.add_argument("--encoder", default=None,
                    help="encoder override for the coded scheme")
    ap.add_argument("--trials", type=int, default=1,
                    help="delay realizations per cell (one device loop "
                         "where the lowering allows; records carry "
                         "per-realization traces + mean/p50/p95 summaries)")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="record stride inside batched runs (0 = final "
                         "objective only)")
    ap.add_argument("--placement", default="vmap",
                    choices=["single", "vmap", "sharded"],
                    help="how the realization axis executes (with --trials)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device the cells run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--out", default="runs/workloads")
    ap.add_argument("--formats", default="json,csv")
    ap.add_argument("--trace", default=None, metavar="PREFIX",
                    help="write <PREFIX>.jsonl + <PREFIX>.perfetto.json "
                         "straggler traces (repro_torch.obs)")
    ap.add_argument("--metrics-out", default=None, metavar="CSV",
                    help="write the per-cell obs metrics CSV")
    args = ap.parse_args(argv)

    workloads = (available_workloads() if args.workload == "all" else
                 [w.strip() for w in args.workload.split(",") if w.strip()])
    strategies = [s.strip() for s in args.strategies.split(",") if s.strip()]
    delays = ([d.strip() for d in args.delays.split(",") if d.strip()]
              if args.delays else None)
    cfg = {}
    if args.k is not None:
        cfg["k"] = args.k
    if args.steps is not None:
        cfg["steps"] = args.steps
    if args.encoder is not None:
        cfg["encoder"] = args.encoder

    obs = (ObsAxis(trace=args.trace, metrics=bool(args.metrics_out))
           if (args.trace or args.metrics_out) else None)
    records = run_workload_matrix(workloads, strategies, preset=args.preset,
                                  delays=delays, seed=args.seed,
                                  trials=args.trials,
                                  eval_every=args.eval_every,
                                  placement=args.placement, obs=obs,
                                  device=args.device, **cfg)

    os.makedirs(args.out, exist_ok=True)
    formats = {f.strip() for f in args.formats.split(",")}
    if "json" in formats:
        write_json(records, os.path.join(args.out, "workloads.json"))
    if "csv" in formats:
        write_summary_csv(records, os.path.join(args.out, "summary.csv"))
    if args.metrics_out:
        d = os.path.dirname(args.metrics_out)
        if d:
            os.makedirs(d, exist_ok=True)
        write_metrics_csv(records, args.metrics_out)
        print(f"wrote obs metrics to {args.metrics_out}")
    print_table(records)
    print(f"wrote {sorted(formats)} to {args.out}/")
    return records


if __name__ == "__main__":
    main()
