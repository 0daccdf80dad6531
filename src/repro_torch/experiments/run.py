"""``python -m repro_torch.experiments.run`` — the unified experiment CLI.

Port of ``repro.experiments.run``: the reference's flags plus ``--device``
(unset: the CUDA card; ``--device cpu`` runs the kernels' plain PyTorch
versions on the host).  One command for every strategy x delay x workload
x trials x placement cell the paper's §5 protocol needs:

    # synthetic quadratic (the runtime.compare matrix)
    PYTHONPATH=src python -m repro_torch.experiments.run \\
        --strategies coded-gd,uncoded,async --delays bimodal,power_law

    # workload matrix (the workloads.run matrix), on the host
    PYTHONPATH=src python -m repro_torch.experiments.run --device cpu \\
        --workloads ridge,logistic --strategies coded,uncoded --trials 8

Argv is parsed into an :class:`ExperimentSpec`, compiled with ``plan`` and
run with ``execute`` — the path the legacy ``runtime.compare`` and
``workloads.run`` CLIs delegate to.  ``--plan-only`` prints the resolved
cell list (including pre-materialized skips) without running.  ``--train``
plans like the reference's, and ``execute`` refuses it until coded SGD is
ported.
"""
from __future__ import annotations

import argparse
import os
from typing import Sequence

from .execute import ExperimentResult, execute
from .plan import plan
from .spec import (DelayAxis, ExperimentSpec, ObsAxis, PlacementAxis,
                   ProblemAxis, StrategyAxis, TrialsAxis)

__all__ = ["build_spec", "main"]


def _csv_list(s: str | None) -> list[str]:
    return [x.strip() for x in (s or "").split(",") if x.strip()]


def build_spec(args: argparse.Namespace) -> ExperimentSpec:
    """An ``ExperimentSpec`` from parsed CLI args (shared by this CLI and
    the legacy front-ends)."""
    delays = tuple(_csv_list(args.delays))
    train = _csv_list(getattr(args, "train", None))
    if train:
        problems = tuple(
            ProblemAxis.train(a, preset=args.preset,
                              seq_len=getattr(args, "seq_len", 64))
            for a in train)
        if not delays:
            delays = ("bimodal",)     # train cells need an explicit model
    elif args.workloads:
        problems = tuple(ProblemAxis.from_workload(w, args.preset)
                         for w in _csv_list(args.workloads))
    else:
        problems = (ProblemAxis.synthetic(args.n, args.p, noise=args.noise,
                                          lam=args.lam, h=args.h),)
        if not delays:
            delays = ("bimodal", "power_law", "exponential")
    # --code only means something to train-kind coded-sgd cells; other
    # strategies would reject the unknown kwarg
    code_opts = ((("code", args.code),)
                 if train and getattr(args, "code", None) else ())
    strategies = tuple(
        StrategyAxis(name=s, encoder=args.encoder, policy=args.policy,
                     k=args.k, deadline=args.deadline,
                     policy_beta=args.policy_beta,
                     staleness_bound=args.staleness_bound,
                     async_updates=args.async_updates,
                     degrade=getattr(args, "degrade", None),
                     options=code_opts)
        for s in _csv_list(args.strategies))
    # the legacy front-ends share build_spec but not the obs flags, hence
    # getattr defaults — their specs get the all-off ObsAxis
    obs = ObsAxis(trace=getattr(args, "trace", None),
                  profile=getattr(args, "profile", None),
                  metrics=bool(getattr(args, "metrics_out", None)
                               or getattr(args, "metrics", False)))
    return ExperimentSpec(
        problems=problems, strategies=strategies,
        delays=DelayAxis(delays=delays, m=args.m,
                         compute_time=args.compute_time,
                         faults=getattr(args, "faults", None)),
        trials=TrialsAxis(trials=args.trials, eval_every=args.eval_every,
                          seed=args.seed),
        placement=PlacementAxis(mode=args.placement,
                                cell_batch=getattr(args, "cell_batch",
                                                   False)),
        steps=args.steps, obs=obs)


def add_axis_flags(ap: argparse.ArgumentParser, *,
                   strategies: str = "coded-gd,uncoded,replication,async",
                   delays: str | None = "bimodal,power_law,exponential",
                   encoder: str | None = None,
                   policy: str | None = None) -> None:
    """The axis flags shared by this CLI and the legacy front-ends (their
    historical defaults differ, hence the parameters)."""
    from repro_torch.core.encoding import available_encoders
    from repro_torch.runtime.strategies import available_strategies
    ap.add_argument("--strategies", default=strategies,
                    help=f"comma list from {available_strategies()}; with "
                         f"--workloads, 'coded' resolves per workload")
    ap.add_argument("--delays", default=delays,
                    help="comma list of delay models (empty with "
                         "--workloads: each workload's native model)")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--p", type=int, default=128)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--h", default="l2", choices=["l2", "l1", "none"])
    ap.add_argument("--m", type=int, default=None,
                    help="workers (default 16; workload presets own this)")
    ap.add_argument("--k", type=int, default=None,
                    help="fastest-k (default 3m/4 / preset k)")
    ap.add_argument("--steps", type=int, default=None,
                    help="iteration budget (default 200; workload presets "
                         "own this)")
    ap.add_argument("--encoder", default=encoder,
                    help=f"encoder for coded strategies, from "
                         f"{available_encoders()} (operator encoders are "
                         f"matrix-free)")
    ap.add_argument("--policy", default=policy,
                    choices=["fastest-k", "adaptive-k", "deadline",
                             "adversarial"])
    ap.add_argument("--compute-time", type=float, default=0.05)
    ap.add_argument("--deadline", type=float, default=1.0,
                    help="time budget for --policy deadline (sim seconds)")
    ap.add_argument("--policy-beta", type=float, default=2.0,
                    help="overlap beta for --policy adaptive-k")
    ap.add_argument("--staleness-bound", type=int, default=None)
    ap.add_argument("--async-updates", type=int, default=None)
    ap.add_argument("--trials", type=int, default=1,
                    help="delay realizations per cell (the Monte-Carlo "
                         "axis)")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="record the objective every s steps (s | steps); "
                         "0 records the final objective only")
    ap.add_argument("--placement", default="vmap",
                    choices=["single", "vmap", "sharded"],
                    help="how the realization axis executes: host loop / "
                         "one device loop / spread over the devices (one "
                         "device in the port)")
    ap.add_argument("--seed", type=int, default=0)


def main(argv: Sequence[str] | None = None) -> ExperimentResult:
    ap = argparse.ArgumentParser(
        prog="repro_torch.experiments.run",
        description="unified spec -> plan -> execute experiment harness")
    ap.add_argument("--workloads", default=None,
                    help="comma list of paper-§5 workloads "
                         "(ridge/lasso/logistic/mf); omit for the "
                         "synthetic quadratic")
    ap.add_argument("--train", default=None, metavar="ARCHS",
                    help="comma list of model-zoo architectures to train "
                         "with coded SGD (train-kind cells, e.g. "
                         "'deepseek-7b'); --strategies then picks from "
                         "coded-sgd/uncoded")
    ap.add_argument("--code", default=None,
                    help="gradient code for train-kind coded-sgd cells "
                         "(frc/cyclic/stochastic/uncoded; default frc)")
    ap.add_argument("--seq-len", type=int, default=64, dest="seq_len",
                    help="sequence length for train-kind cells")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "bench", "paper", "100m"],
                    help="workload scale preset (with --workloads), or the "
                         "train preset (smoke/100m) with --train")
    # --delays defaults to unset: synthetic matrices then get the compare
    # triple (in build_spec), workload matrices their native paper models —
    # while an EXPLICIT --delays always wins, workload or not
    add_axis_flags(ap, delays=None)
    ap.add_argument("--cell-batch", action="store_true",
                    help="stack compatible matrix cells (same problem/"
                         "strategy/shape, differing delay/policy/step size) "
                         "into one device loop (vmap placement only)")
    from repro_torch.runtime.faults import FAULT_PRESETS
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="fault-injection spec layered on every delay "
                         "model, e.g. 'crash:p=0.2,at=0.5;blackout:p=0.3,"
                         "dur=0.4;corrupt:p=0.05', or a named chaos "
                         f"preset from {sorted(FAULT_PRESETS)} as "
                         "'preset:<name>' (repro_torch.runtime.faults)")
    ap.add_argument("--degrade", default=None, metavar="SPEC",
                    help="sub-k degradation policy: 'renormalize' | "
                         "'hold[:shrink=S,k_min=K]' | 'backoff[:base=B,"
                         "retries=R]' (default: renormalized decode "
                         "weights)")
    ap.add_argument("--retries", type=int, default=0,
                    help="re-run a cell whose execution RAISED up to N "
                         "extra times (capped exponential backoff)")
    ap.add_argument("--retry-base", type=float, default=0.5,
                    help="first retry backoff in seconds")
    ap.add_argument("--resume", default=None, metavar="RUN_ID",
                    help="resume a killed matrix: replay the run store's "
                         "streamed cell records (run id, unique prefix, or "
                         "'latest') and execute only unfinished cells")
    ap.add_argument("--device", default=None,
                    help="device the cells run on (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--plan-only", action="store_true",
                    help="print the resolved cell list and exit")
    ap.add_argument("--out", default="runs/experiments")
    ap.add_argument("--formats", default="json,csv,summary")
    ap.add_argument("--trace", default=None, metavar="PREFIX",
                    help="write <PREFIX>.jsonl + <PREFIX>.perfetto.json "
                         "straggler traces (view with "
                         "repro_torch.obs.report / ui.perfetto.dev)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace per cell under "
                         "DIR (Chrome trace) plus device-memory high-water "
                         "marks")
    ap.add_argument("--metrics-out", default=None, metavar="CSV",
                    help="write the per-cell obs metrics CSV (miss-rate, "
                         "active-set, latency percentiles, compile vs "
                         "execute split)")
    args = ap.parse_args(argv)

    spec = build_spec(args)
    pl = plan(spec)
    if args.plan_only:
        print(pl.describe())
        return ExperimentResult(plan=pl, outcomes=[])
    result = execute(pl, device=args.device, retries=args.retries,
                     retry_base=args.retry_base, resume=args.resume)

    os.makedirs(args.out, exist_ok=True)
    formats = {f.strip() for f in args.formats.split(",")}
    artifacts: dict = {}
    if "json" in formats:
        artifacts["records_json"] = os.path.join(args.out,
                                                 "experiments.json")
        result.to_json(artifacts["records_json"])
    if "csv" in formats:
        artifacts["trace_csv"] = os.path.join(args.out, "experiments.csv")
        result.to_csv(artifacts["trace_csv"])
    if "summary" in formats:
        artifacts["summary_csv"] = os.path.join(args.out, "summary.csv")
        result.to_summary_csv(artifacts["summary_csv"])
    if args.metrics_out:
        d = os.path.dirname(args.metrics_out)
        if d:
            os.makedirs(d, exist_ok=True)
        result.to_metrics_csv(args.metrics_out)
        artifacts["metrics_csv"] = args.metrics_out
        print(f"wrote obs metrics to {args.metrics_out}")
    if args.trace:
        artifacts["trace_jsonl"] = f"{args.trace}.jsonl"
        artifacts["trace_perfetto"] = f"{args.trace}.perfetto.json"
        print(f"wrote obs trace to {args.trace}.jsonl / "
              f"{args.trace}.perfetto.json")
    if result.run_id is not None and artifacts:
        from repro_torch.obs.runstore import default_store
        store = default_store()
        if store is not None:
            store.attach_artifacts(result.run_id, artifacts)
    result.print_table()
    print(f"wrote {sorted(formats)} to {args.out}/")
    if result.run_id is not None:
        print(f"recorded run {result.run_id} "
              f"(diff with: python -m repro_torch.obs.diff latest latest~1)")
    return result


if __name__ == "__main__":
    main()
