"""Quickstart on the PyTorch port: encoded distributed ridge regression via
the experiment API (the counterpart of ``examples/quickstart.py``).

The master waits for the fastest k of m workers every iteration; the
Hadamard encoding makes the fastest-k gradient a faithful estimate of the
full gradient regardless of WHICH workers straggle.  One declarative
``ExperimentSpec`` names the whole cell (problem, strategy, delay model,
cluster shape) and ``run`` compiles it to a plan and executes it on the
device, each step one launch of the fused masked-gradient kernel.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(unset, ``--device`` is the CUDA card, and the script raises without one).
"""
import argparse

import torch

from repro_torch.core import (identity_encoder, make_encoded_problem,
                              original_objective)
from repro_torch.experiments import (DelayAxis, ExperimentSpec, ProblemAxis,
                                     StrategyAxis, run)
from repro_torch.runtime import ProblemSpec

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
device = ap.parse_args().device

m, k = 16, 12           # 16 workers, wait for the fastest 12

# 1. the ORIGINAL problem every strategy solves (ridge, lam = 0.05)
ps = ProblemSpec.synthetic(n=512, p=128, noise=0.5, lam=0.05, seed=0)

# 2. one declarative spec: that problem + encoded gradient descent on a
#    simulated cluster with bimodal delays (paper §5.3, barrier accounting)
spec = ExperimentSpec(
    problems=(ProblemAxis.from_spec(ps),),
    strategies=(StrategyAxis("coded-gd", encoder="hadamard", k=k),),
    delays=DelayAxis.of("bimodal", m=m),
    steps=200)

# 3. plan + execute; the single cell's outcome carries both the JSON-ready
#    record and the raw RunResult (trace, final iterate), oblivious to the
#    erasures
res = run(spec, device=device).outcomes[0].result

# 4. compare against the exact ridge solution
w_star = ps.w_star()
prob = make_encoded_problem(ps.X, ps.y, identity_encoder(ps.n), m,
                            lam=ps.lam, device=device)
f_star = float(original_objective(
    prob, torch.as_tensor(w_star, dtype=torch.float32, device=prob.device),
    h="l2"))
f0 = float(original_objective(prob, torch.zeros(ps.p, device=prob.device),
                              h="l2"))
print(f"f(w_0)   = {f0:.4f}")
print(f"f(w_1)   = {res.objective[0]:.4f}   (trace[t] = f after update t+1)")
print(f"f(w_T)   = {res.final_objective:.4f}   "
      f"(encoded, {m - k} stragglers/step)")
print(f"f(w*)    = {f_star:.4f}   (exact optimum)")
print(f"suboptimality: {res.final_objective / f_star - 1:.2%}")
print(f"simulated wall-clock: {res.wallclock:.1f}s for {len(res.objective)} "
      f"iterations")
assert res.final_objective < 1.05 * f_star
print("OK: converged within the paper's kappa-ball of the optimum")
