"""Ridge regression workload (paper §5.1, Fig 7).

Lowers to a data-parallel ``ProblemSpec`` (h='l2') and runs any registry
strategy as-is; the canonical coded scheme is encoded L-BFGS, exactly the
paper's Fig-7 solver.  Metric: suboptimality gap f(w_t) - f* against the
closed-form ground truth — derivable from the objective trace, so the
metric trace has full per-iteration resolution.

Port of ``src/repro/workloads/ridge.py``.  On the card, ``coded-lbfgs``
combines its worker gradients with the combine kernel (and encodes with
the SRHT kernel under ``encoder="fast-hadamard"``); the ``uncoded`` and
``replication`` GD arms take one fused-gradient launch a step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.paper_native import PAPER_RIDGE
from repro_torch.data import lsq_dataset
from repro_torch.device import resolve_device
from repro_torch.obs.trace import span as _obs_span
from repro_torch.runtime.strategies import ProblemSpec, get_strategy

from .base import Preset, Workload, WorkloadRunResult, register_workload
from . import ground_truth as gt


@dataclasses.dataclass(frozen=True)
class RidgeData:
    spec: ProblemSpec
    w_star: np.ndarray
    f_star: float


_CFG = PAPER_RIDGE


@register_workload("ridge")
class Ridge(Workload):
    metric_name = "subopt_gap"
    metric_goal = "min"
    paper_config = _CFG
    canonical_coded = "coded-lbfgs"
    presets = {
        "smoke": Preset("smoke", m=8, k=6, steps=40, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"n": 256, "p": 64, "noise": 1.0}),
        "bench": Preset("bench", m=_CFG.m, k=24, steps=40, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"n": 1024, "p": 512, "noise": 1.0}),
        # the published Fig-7 dimensions; k = 24 is the paper's middle cell
        "paper": Preset("paper", m=_CFG.m, k=24, steps=100, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"n": _CFG.n, "p": _CFG.p, "noise": 1.0}),
    }

    def build(self, preset) -> RidgeData:
        ps = self.preset(preset)
        with _obs_span("workload:data", workload=self.name):
            X, y, _ = lsq_dataset(ps.dims["n"], ps.dims["p"],
                                  noise=ps.dims["noise"], seed=ps.seed)
            spec = ProblemSpec(X=X, y=y, lam=ps.lam, h="l2")
        with _obs_span("workload:ground_truth", workload=self.name):
            w_star = gt.ridge_solution(X, y, ps.lam)
            f_star = gt.ridge_objective(X, y, ps.lam, w_star)
        return RidgeData(spec, w_star, f_star)

    def supports(self, strategy):
        if strategy in ("coded-prox",):
            return "coded-prox requires the l1 objective (use the lasso " \
                   "workload)"
        if strategy in ("coded-bcd",):
            return "bcd reports the unregularized lifted objective phi, " \
                   "not the ridge objective (use the logistic workload)"
        return None

    def _score(self, strategy, ps, data: RidgeData, result) -> \
            WorkloadRunResult:
        with _obs_span("workload:score", workload=self.name):
            gap = np.maximum(np.asarray(result.objective) - data.f_star, 0.0)
            return WorkloadRunResult(
                workload=self.name, strategy=strategy, preset=ps.name,
                metric_name=self.metric_name,
                times=np.asarray(result.times),
                objective=np.asarray(result.objective),
                metric_times=np.asarray(result.times), metric=gap,
                w=result.w,
                meta={**result.meta, "f_star": data.f_star,
                      "final_rel_subopt": float(
                          gap[-1] / max(abs(data.f_star), 1e-12))})

    @staticmethod
    def _cell_cfg(strategy, ps, cfg) -> tuple[int, dict]:
        cfg.setdefault("k", ps.k)
        if strategy == "async":
            cfg.pop("k", None)
        return cfg.pop("steps", ps.steps), cfg

    def _run(self, strategy, engine, ps, data: RidgeData, *, device,
             **cfg) -> WorkloadRunResult:
        steps, cfg = self._cell_cfg(strategy, ps, cfg)
        result = get_strategy(strategy).run(data.spec, engine, steps=steps,
                                            device=device, **cfg)
        return self._score(strategy, ps, data, result)

    def run_trials(self, strategy, engine=None, *, preset="smoke", data=None,
                   trials=1, eval_every=1, placement="vmap", device=None,
                   **cfg):
        """Monte-Carlo path: ridge lowers to ONE strategy run, so the whole
        realization stack goes through ``Strategy.run_batched`` (one
        encode, one (R, T, m) schedule draw, one batched device loop — or,
        for ``coded-lbfgs``, whose two-loop memory is host state, the
        realizations one after the other on that encode) and each
        realization is scored independently."""
        strategy = self._resolve_checked(strategy)
        device = resolve_device(device)
        ps = self.preset(preset)
        if engine is None:
            engine = self.default_engine(ps)
        if data is None:
            data = self.build(ps)
        steps, cfg = self._cell_cfg(strategy, ps, dict(cfg))
        batched = get_strategy(strategy).run_batched(
            data.spec, engine, steps=steps, trials=trials,
            eval_every=eval_every, placement=placement, device=device, **cfg)
        return [self._score(strategy, ps, data, batched.realization(r))
                for r in range(trials)]
