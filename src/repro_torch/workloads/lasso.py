"""Sparse-recovery LASSO workload (paper §5.4, Fig 14).

Lowers to a data-parallel ``ProblemSpec`` (h='l1'); every data-parallel
registry strategy runs the proximal (ISTA) path on it.  Canonical coded
scheme: encoded proximal gradient.  Metric: F1 of the recovered support
against the planted sparse ground truth — it needs the iterate, so the run
is driven in chunks (exact same trajectory for these stateless strategies)
and F1 is recorded at each chunk boundary.

Port of ``src/repro/workloads/lasso.py``.  On the card every ISTA step is
one fused-gradient launch; each chunk re-encodes the problem on the host,
as the reference does (``base.run_strategy_chunked``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.paper_native import PAPER_LASSO
from repro_torch.data import lsq_dataset
from repro_torch.obs.trace import span as _obs_span
from repro_torch.runtime.strategies import ProblemSpec

from .base import (Preset, Workload, WorkloadRunResult, register_workload,
                   run_strategy_chunked)
from . import ground_truth as gt


@dataclasses.dataclass(frozen=True)
class LassoData:
    spec: ProblemSpec
    w_true: np.ndarray          # planted sparse signal (the F1 reference)
    w_star: np.ndarray          # FISTA optimum of the composite objective
    f_star: float
    lipschitz: float            # smoothness of the data-fit term, once


_CFG = PAPER_LASSO


@register_workload("lasso")
class Lasso(Workload):
    metric_name = "support_f1"
    metric_goal = "max"
    paper_config = _CFG
    canonical_coded = "coded-prox"
    # lam: the paper's 0.6 belongs to its (130k x 100k, sigma=40) scale; the
    # scaled presets keep the same sparsity regime (~8% support) with lam
    # re-tuned so ISTA recovers the support within the step budget.
    presets = {
        "smoke": Preset("smoke", m=16, k=12, steps=240, lam=0.08,
                        delay=_CFG.delay_model,
                        dims={"n": 512, "p": 256, "sparse": 20,
                              "noise": 0.4, "records": 8}),
        "bench": Preset("bench", m=32, k=24, steps=250, lam=0.08,
                        delay=_CFG.delay_model,
                        dims={"n": 1024, "p": 512, "sparse": 40,
                              "noise": 0.4, "records": 10}),
        "paper": Preset("paper", m=_CFG.m, k=80, steps=500, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"n": _CFG.n, "p": _CFG.p, "sparse": 7695,
                              "noise": 40.0, "records": 20}),
    }

    def build(self, preset) -> LassoData:
        ps = self.preset(preset)
        with _obs_span("workload:data", workload=self.name):
            X, y, w_true = lsq_dataset(ps.dims["n"], ps.dims["p"],
                                       noise=ps.dims["noise"],
                                       sparse=ps.dims["sparse"], seed=ps.seed)
            spec = ProblemSpec(X=X, y=y, lam=ps.lam, h="l1")
            lipschitz = spec.lipschitz()
        with _obs_span("workload:ground_truth", workload=self.name):
            w_star = gt.lasso_fista(X, y, ps.lam)
            f_star = gt.lasso_objective(X, y, ps.lam, w_star)
        return LassoData(spec, w_true, w_star, f_star, lipschitz)

    def supports(self, strategy):
        if strategy == "coded-lbfgs":
            return "encoded L-BFGS assumes the smooth ridge objective " \
                   "(paper Thm 4); l1 is non-smooth"
        if strategy == "async":
            return "the async stale-gradient baseline covers smooth " \
                   "objectives only"
        if strategy == "coded-bcd":
            return "bcd solves the unregularized lifted problem; it cannot " \
                   "express the l1 penalty"
        return None

    def _run(self, strategy, engine, ps, data: LassoData, *, device,
             **cfg) -> WorkloadRunResult:
        cfg.setdefault("k", ps.k)
        # same formula as strategies._auto_step, but from the cached L so
        # the chunk loop does not redo the O(p^3) eig once per chunk
        cfg.setdefault("step_size",
                       1.0 / (1.3 * data.lipschitz + ps.lam))
        steps = cfg.pop("steps", ps.steps)
        records = cfg.pop("records", ps.dims["records"])
        times, objective, recs, result = run_strategy_chunked(
            strategy, data.spec, engine, steps=steps, records=records,
            device=device, **cfg)
        with _obs_span("workload:score", workload=self.name):
            metric_times = np.asarray([t for t, _ in recs])
            f1 = np.asarray([gt.support_f1(w, data.w_true) for _, w in recs])
            return WorkloadRunResult(
                workload=self.name, strategy=strategy, preset=ps.name,
                metric_name=self.metric_name,
                times=times, objective=objective,
                metric_times=metric_times, metric=f1, w=recs[-1][1],
                meta={**result.meta, "f_star": data.f_star,
                      "final_subopt_gap": float(max(
                          objective[-1] - data.f_star, 0.0)),
                      "support_size": int((np.abs(data.w_true) > 0).sum())})
