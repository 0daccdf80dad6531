"""Strategy x delay-model comparison CLI (paper §5 plots), a legacy
front-end.

Port of ``repro.runtime.compare``: a thin shim that parses the reference's
flags, plus ``--device`` (unset: the CUDA card), into a declarative
``repro_torch.experiments.ExperimentSpec`` and delegates to the unified
``plan -> execute`` path (DESIGN.md §10).  Records, JSON and CSV outputs
have the reference's schema; new code should use
``python -m repro_torch.experiments.run`` or the ``repro_torch.experiments``
API directly.

    PYTHONPATH=src python -m repro_torch.runtime.compare --device cpu \\
        --strategies coded-gd,uncoded,replication,async \\
        --delays bimodal,power_law,exponential

``--encoder`` accepts any registry name including the matrix-free operator
encoders ('fast-hadamard', 'block-diagonal'); ``--trials R`` adds the
Monte-Carlo axis (one device loop per cell, DESIGN.md §9) with
``--placement`` choosing single/vmap/sharded execution; ``--workload``
swaps the synthetic quadratic for a paper-§5 workload, whose preset then
owns problem shape, objective and policy.
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

from repro_torch.experiments import (DelayAxis, ExperimentSpec, PlacementAxis,
                               ProblemAxis, StrategyAxis, TrialsAxis,
                               execute, plan, print_table, trace_rows,
                               write_json)
from repro_torch.experiments import write_trace_csv as write_csv  # noqa: F401

__all__ = ["run_matrix", "write_json", "write_csv", "trace_rows", "main"]


def run_matrix(strategies: Sequence[str], delays: Sequence[str], *,
               n: int = 512, p: int = 128, m: int | None = None,
               k: int | None = None,
               steps: int | None = None, lam: float = 0.05, h: str = "l2",
               encoder: str = "hadamard", policy: str = "fastest-k",
               compute_time: float = 0.05, seed: int = 0,
               staleness_bound: int | None = None,
               async_updates: int | None = None,
               deadline: float = 1.0, policy_beta: float = 2.0,
               noise: float = 0.5, workload: str | None = None,
               preset: str = "smoke", trials: int = 1,
               eval_every: int = 1, placement: str = "vmap",
               device=None) -> list[dict]:
    """Run the full comparison matrix on ``device`` (unset: CUDA); returns
    one record per cell.

    Legacy API shim: the kwargs are compiled into an ``ExperimentSpec``
    and executed by ``repro_torch.experiments`` — see that package for the
    record schema (``metric_name`` / ``final_metric`` on every cell,
    skip-with-reason records, (R, T) trace stacks + mean/p50/p95 summaries
    when ``trials > 1``).
    """
    if workload is not None:
        ignored = [flag for flag, val, default in [
            ("--policy", policy, "fastest-k"), ("--h", h, "l2"),
            ("--lam", lam, 0.05), ("--n", n, 512), ("--p", p, 128),
            ("--noise", noise, 0.5), ("--deadline", deadline, 1.0),
            ("--policy-beta", policy_beta, 2.0),
            ("--staleness-bound", staleness_bound, None),
            ("--async-updates", async_updates, None)] if val != default]
        if ignored:
            print(f"# --workload: {', '.join(ignored)} ignored — the "
                  f"workload preset owns problem shape, objective and "
                  f"policy; use repro_torch.workloads.Workload.run(**cfg) for "
                  f"fine-grained control")
        problems = (ProblemAxis.from_workload(workload, preset),)
        strategy_axes = tuple(StrategyAxis(name=s, encoder=encoder, k=k)
                              for s in strategies)
    else:
        problems = (ProblemAxis.synthetic(n, p, noise=noise, lam=lam, h=h),)
        strategy_axes = tuple(
            StrategyAxis(name=s, encoder=encoder, policy=policy, k=k,
                         deadline=deadline, policy_beta=policy_beta,
                         staleness_bound=staleness_bound,
                         async_updates=async_updates)
            for s in strategies)
    spec = ExperimentSpec(
        problems=problems, strategies=strategy_axes,
        delays=DelayAxis(delays=tuple(delays), m=m,
                         compute_time=compute_time),
        trials=TrialsAxis(trials=trials, eval_every=eval_every, seed=seed),
        placement=PlacementAxis(mode=placement), steps=steps)
    return execute(plan(spec), device=device).records


def main(argv: Sequence[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="repro_torch.runtime.compare",
        description="strategy x delay-model wall-clock comparison harness "
                    "(legacy front-end over repro_torch.experiments)")
    from repro_torch.experiments.run import add_axis_flags
    add_axis_flags(ap, encoder="hadamard", policy="fastest-k")
    ap.add_argument("--workload", default=None,
                    help="run a paper-§5 workload from repro_torch.workloads "
                         "(ridge/lasso/logistic/mf) instead of the default "
                         "synthetic quadratic; cells score the workload's "
                         "paper metric")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "bench", "paper"],
                    help="workload scale preset (with --workload)")
    ap.add_argument("--device", default=None,
                    help="device the cells run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--out", default="runs/compare")
    ap.add_argument("--formats", default="json,csv")
    args = ap.parse_args(argv)

    records = run_matrix(
        [s.strip() for s in args.strategies.split(",") if s.strip()],
        [d.strip() for d in args.delays.split(",") if d.strip()],
        n=args.n, p=args.p, m=args.m, k=args.k, steps=args.steps,
        lam=args.lam, h=args.h, encoder=args.encoder, policy=args.policy,
        compute_time=args.compute_time, seed=args.seed,
        staleness_bound=args.staleness_bound,
        async_updates=args.async_updates,
        deadline=args.deadline, policy_beta=args.policy_beta,
        noise=args.noise, workload=args.workload, preset=args.preset,
        trials=args.trials, eval_every=args.eval_every,
        placement=args.placement, device=args.device)

    os.makedirs(args.out, exist_ok=True)
    formats = {f.strip() for f in args.formats.split(",")}
    if "json" in formats:
        write_json(records, os.path.join(args.out, "compare.json"))
    if "csv" in formats:
        write_csv(records, os.path.join(args.out, "compare.csv"))
    print_table(records)
    print(f"wrote {sorted(formats)} to {args.out}/")
    return records


if __name__ == "__main__":
    main()
