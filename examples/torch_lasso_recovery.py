"""LASSO sparsity recovery under stragglers (paper §5.4, Fig 14) on the
PyTorch port (the counterpart of ``examples/lasso_recovery.py``): encoded
proximal gradient (ISTA) vs the uncoded fastest-k baseline, under an
ADVERSARIAL erasure schedule, through the workloads API, so the dataset,
the FISTA ground truth and the F1 metric are the library's.

  PYTHONPATH=src python examples/torch_lasso_recovery.py [--device cpu]
  (unset, ``--device`` is the CUDA card)
"""
import argparse

from repro_torch.runtime import AdversarialRotation
from repro_torch.workloads import get_workload

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
device = ap.parse_args().device

wl = get_workload("lasso")
ps = wl.preset("smoke")
data = wl.build(ps)
engine = wl.default_engine(ps)

print(f"n={ps.dims['n']} p={ps.dims['p']} support={ps.dims['sparse']} "
      f"m={ps.m} adversarial k={ps.k}")
for strategy, encoder in [("uncoded", None), ("replication", None),
                          ("coded-prox", "steiner"),
                          ("coded-prox", "hadamard")]:
    cfg = {"encoder": encoder} if encoder else {}
    res = wl.run(strategy, engine, preset=ps, data=data,
                 policy=AdversarialRotation(ps.k), device=device, **cfg)
    label = encoder or strategy
    print(f"{label:12s} F1={res.final_metric:.3f} "
          f"final_obj={res.final_objective:.4f} "
          f"(gap to FISTA f*: {res.meta['final_subopt_gap']:.2e})")
