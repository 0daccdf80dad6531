"""The paper's headline comparison (§5) on the PyTorch port, through the
experiment API (the counterpart of ``examples/strategy_comparison.py``):
the ridge workload (encoded L-BFGS vs uncoded vs replication vs async
stale-gradient SGD) under three delay distributions, measured in SIMULATED
WALL-CLOCK (not iterations) and scored with the workload's paper metric,
the suboptimality gap against the closed-form ground truth.  The whole
matrix is ONE declarative ``ExperimentSpec``.

Sync strategies pay the fastest-k barrier per iteration; async pays per
arrival, so async takes many more (stale) steps in the same span of time.
The table answers: who reaches a small gap EARLIEST in wall-clock?

Run:  PYTHONPATH=src python examples/torch_strategy_comparison.py
      [--device cpu]   (unset: the CUDA card)
"""
import argparse

import numpy as np

from repro_torch.experiments import (DelayAxis, ExperimentSpec, ProblemAxis,
                                     StrategyAxis, run)

STRATEGIES = ["coded", "uncoded", "replication", "async"]
DELAYS = ["bimodal", "power_law", "exponential"]

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
device = ap.parse_args().device

spec = ExperimentSpec(
    problems=(ProblemAxis.from_workload("ridge", "smoke"),),
    strategies=tuple(StrategyAxis(s) for s in STRATEGIES),
    delays=DelayAxis(delays=tuple(DELAYS)))
records = run(spec, device=device).records

# time (simulated seconds) for each strategy to first push the
# suboptimality gap below 1.1x the best final gap under that delay model
print(f"{'delay':12s} {'strategy':13s} {'final gap':>10s} {'wall_s':>9s} "
      f"{'t_to_best':>10s}")
for delay in DELAYS:
    cell = [r for r in records if r["delay"] == delay and "skipped" not in r]
    target = 1.1 * min(max(r["final_metric"], 1e-12) for r in cell)
    for r in cell:
        gap = np.asarray(r["metric"])
        hit = np.nonzero(gap <= target)[0]
        t_hit = f"{r['metric_times'][hit[0]]:10.2f}" if hit.size \
            else "       inf"
        print(f"{delay:12s} {r['strategy']:13s} {r['final_metric']:10.2e} "
              f"{r['wallclock_s']:9.2f} {t_hit}")
