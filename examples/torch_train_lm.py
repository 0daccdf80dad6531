"""End-to-end script on the PyTorch port (the counterpart of
``examples/train_lm.py``): train an LM with CODED data parallelism under
simulated stragglers, and compare against an uncoded no-straggler
baseline that waits for every worker.  Each coded step combines the
workers' gradients with one launch of the coded-combine kernel.

Both runs go through the spec -> plan -> execute harness, so each gets a
canonical record, obs metrics, and — when ``REPRO_RUNSTORE`` is set — a
run-store manifest, exactly like ``repro_torch.experiments.run`` cells.  The acceptance bar this script prints is the paper's: at EQUAL
steps, coded SGD under adversarial stragglers should land within 5% of
the uncoded baseline's loss while finishing each step after only the
fastest k arrivals.

  PYTHONPATH=src python examples/torch_train_lm.py            # the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu
  PYTHONPATH=src python examples/torch_train_lm.py --code cyclic --faults preset:ec2-tail
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 200
"""
import argparse
import json
import math
import os

import numpy as np

from repro_torch.experiments.execute import execute
from repro_torch.experiments.plan import plan
from repro_torch.experiments.spec import (DelayAxis, ExperimentSpec, ObsAxis,
                                    PlacementAxis, ProblemAxis, StrategyAxis,
                                    TrialsAxis)


def _spec(args, *, strategy, code, delays, policy, k, rows_per_worker,
          faults=None, beta=None):
    """One single-cell train-kind spec; lr/warmup/log_every ride in the
    StrategyAxis options escape hatch (run_coded_sgd kwargs)."""
    options = [("lr", args.lr), ("warmup", args.warmup),
               ("log_every", args.log_every)]
    if code is not None:
        options.append(("code", code))
    if beta is not None:
        options.append(("beta", beta))
    return ExperimentSpec(
        problems=(ProblemAxis.train(args.arch, preset=args.preset,
                                    seq_len=args.seq_len,
                                    rows_per_worker=rows_per_worker),),
        strategies=(StrategyAxis(name=strategy, policy=policy, k=k,
                                 options=tuple(options)),),
        delays=DelayAxis(delays=delays, m=args.m, faults=faults),
        trials=TrialsAxis(trials=1, eval_every=1, seed=args.seed),
        placement=PlacementAxis(mode="single"),
        steps=args.steps, obs=ObsAxis())


def _run(spec, device) -> dict:
    result = execute(plan(spec), device=device)
    rec = result.records[0]
    rec["run_id"] = result.run_id
    return rec


def _tail_loss(rec, steps: int) -> float:
    return float(np.mean(rec["objective"][-min(10, steps):]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--strategy", default="coded-sgd",
                    choices=["coded-sgd", "uncoded"])
    ap.add_argument("--code", default="frc",
                    help="gradient code: frc/cyclic/stochastic/uncoded")
    ap.add_argument("--policy", default="adversarial",
                    choices=["fastest-k", "adaptive-k", "deadline",
                             "adversarial"],
                    help="active-set policy for the straggler run "
                         "(adversarial = rotate the worst-case miss set)")
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--beta", type=int, default=2,
                    help="replication factor of the gradient code")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128, dest="seq_len")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--delays", default="bimodal")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="fault spec or chaos preset ('preset:ec2-tail', "
                         "'preset:zone-outage', ...) for the coded run")
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the uncoded no-straggler reference run")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="write the comparison summary as JSON (CI hook)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    # FRC with rows_per_worker=beta draws the SAME b*rows = m sequences per
    # step as the uncoded run (b = m/beta clusters), so with an exact decode
    # the two trajectories consume identical tokens and match to FP noise.
    # Non-FRC codes overlap groups across workers, so rows stay at 1.
    rows = args.beta if args.code == "frc" else 1
    options_beta = args.beta if args.strategy == "coded-sgd" else 1

    print(f"== {args.strategy} ({args.code}, beta={options_beta}, "
          f"{args.policy} k={args.k}/{args.m}) on {args.delays}"
          + (f" + faults '{args.faults}'" if args.faults else "") + " ==")
    spec = _spec(args, strategy=args.strategy,
                 code=args.code if args.strategy == "coded-sgd" else None,
                 delays=tuple(s.strip() for s in args.delays.split(",")
                              if s.strip()),
                 policy=args.policy, k=args.k, rows_per_worker=rows,
                 faults=args.faults,
                 beta=args.beta if args.strategy == "coded-sgd" else None)
    coded = _run(spec, args.device)
    coded_loss = _tail_loss(coded, args.steps)
    coded_time = float(coded["times"][-1])
    meta = coded["meta"]
    print(f"{args.strategy}: final loss {coded_loss:.4f}, sim wall-clock "
          f"{coded_time:.0f}s, exact decode on "
          f"{meta.get('exact_fraction', 0.0) * 100.0:.0f}% of steps, "
          f"mean active {meta.get('mean_active', args.m):.1f}/{args.m}")

    summary = {"coded": {"strategy": args.strategy, "code": args.code,
                         "loss": coded_loss, "sim_time_s": coded_time,
                         "losses": [float(v) for v in coded["objective"]],
                         "meta": meta, "run_id": coded.get("run_id")}}
    ok = math.isfinite(coded_loss)

    if not args.no_baseline:
        print(f"== uncoded no-straggler baseline (constant delays, "
              f"wait for all {args.m}) ==")
        base_spec = _spec(args, strategy="uncoded", code=None,
                          delays=("constant",), policy="fastest-k",
                          k=args.m, rows_per_worker=1)
        base = _run(base_spec, args.device)
        base_loss = _tail_loss(base, args.steps)
        base_time = float(base["times"][-1])
        ratio = coded_loss / base_loss if base_loss else float("inf")
        gap = ratio - 1.0
        verdict = "PASS" if gap <= 0.05 else "WARN"
        ok = ok and math.isfinite(base_loss) and verdict == "PASS"
        print(f"uncoded: final loss {base_loss:.4f}, sim wall-clock "
              f"{base_time:.0f}s")
        print(f"loss ratio coded/uncoded at equal steps: {ratio:.4f} "
              f"({gap:+.2%} vs the 5% acceptance bar) -> {verdict}")
        if coded_time:
            print(f"speedup over waiting for all under stragglers: the "
                  f"coded run finishes each step after the fastest "
                  f"{args.k} arrivals")
        summary["baseline"] = {"loss": base_loss, "sim_time_s": base_time,
                               "losses": [float(v)
                                          for v in base["objective"]],
                               "run_id": base.get("run_id")}
        summary["ratio"] = ratio
        summary["verdict"] = verdict
    summary["ok"] = bool(ok)

    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote summary to {args.out}")
    return summary


if __name__ == "__main__":
    main()
