"""Matrix-factorization workload: MovieLens-protocol alternating coded
least squares (paper §5.2, Tables 2-3).

ALS over biased factors ``[U | bu]``, ``[V | bv]`` (ratings centered at
3.0): each half-step is ONE joint ridge regression over every observed
rating, lowered to a data-parallel ``ProblemSpec`` and dispatched through
the strategy registry — so every half-step routes through the
``ClusterEngine`` with a FRESH delay realization, exactly like the paper's
coded L-BFGS inner solver on EC2.  The result trace records the realized
per-iteration active sets of every half-step (``extras['half_steps']``).

Metric: held-out (test) RMSE after each half-step; the objective trace is
the penalized ALS objective, which warm-started monotone inner solvers
decrease monotonically under full participation.

Port of ``src/repro/workloads/matrix_factorization.py``.  The design, the
warm start and every half-step's ``w0`` stay host numpy, as in the
reference; on the card each ``coded-lbfgs`` inner step combines its worker
gradients with the combine kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.paper_native import PAPER_MF
from repro_torch.data import mf_ratings_dataset
from repro_torch.obs.trace import span as _obs_span
from repro_torch.runtime.strategies import ProblemSpec, get_strategy

from .base import (Preset, Workload, WorkloadRunResult, register_workload,
                   sub_engine)
from . import ground_truth as gt


@dataclasses.dataclass(frozen=True)
class MFData:
    R: np.ndarray
    train: np.ndarray
    test: np.ndarray


_CFG = PAPER_MF


def _half_step_design(Rc, mask, fixed, side):
    """Joint ridge design for one ALS half-step, vectorized.

    One row per observed training rating; solving side ``side`` ('u'|'v')
    with the other side ``fixed`` = (n_other, rank+1) ``[factors | bias]``
    held constant.  The fixed bias moves into the target, so the LS solution
    is the exact biased-ALS update.  Returns (A, target).
    """
    rank = fixed.shape[1] - 1
    idx = np.argwhere(mask)                              # (nobs, 2) = (i, j)
    ent = idx[:, 0] if side == "u" else idx[:, 1]
    oth = idx[:, 1] if side == "u" else idx[:, 0]
    n_ent = mask.shape[0] if side == "u" else mask.shape[1]
    nobs = idx.shape[0]
    cells = nobs * n_ent * (rank + 1)
    if cells > 500_000_000:     # ~2 GiB of float32 — refuse before the OOM
        raise MemoryError(
            f"dense joint ALS design would be {nobs} x {n_ent * (rank + 1)} "
            f"(~{cells * 4 / 2**30:.0f} GiB); the 'paper' preset records the "
            f"published protocol — run 'smoke'/'bench', or shrink "
            f"users/movies/density")
    feat = np.concatenate([fixed[oth, :rank], np.ones((nobs, 1))], axis=1)
    targ = Rc[idx[:, 0], idx[:, 1]] - fixed[oth, rank]
    A = np.zeros((nobs, n_ent * (rank + 1)), np.float32)
    cols = ent[:, None] * (rank + 1) + np.arange(rank + 1)[None, :]
    A[np.arange(nobs)[:, None], cols] = feat
    return A, targ.astype(np.float32)


@register_workload("mf")
class MatrixFactorization(Workload):
    metric_name = "test_rmse"
    metric_goal = "min"
    paper_config = _CFG
    canonical_coded = "coded-lbfgs"
    # Preset.steps = inner solver iterations per half-step; dims['epochs']
    # counts full (u, v) alternations.
    presets = {
        "smoke": Preset("smoke", m=8, k=6, steps=12, lam=0.3,
                        delay=_CFG.delay_model,
                        dims={"users": 48, "movies": 36, "rank": 3,
                              "density": 0.25, "epochs": 2}),
        "bench": Preset("bench", m=8, k=4, steps=15, lam=0.3,
                        delay=_CFG.delay_model,
                        dims={"users": 120, "movies": 90, "rank": 4,
                              "density": 0.08, "epochs": 2}),
        # published protocol: MovieLens-1M dims, p=15 embedding, m=24.
        # Reference settings — the dense joint-design code targets
        # smoke/bench scale and refuses (clear MemoryError) at these dims.
        "paper": Preset("paper", m=_CFG.m, k=12, steps=25, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"users": 6040, "movies": 3706, "rank": 15,
                              "density": 0.045, "epochs": 10}),
    }

    def build(self, preset) -> MFData:
        ps = self.preset(preset)
        with _obs_span("workload:data", workload=self.name):
            R, train, test = mf_ratings_dataset(
                ps.dims["users"], ps.dims["movies"], rank=ps.dims["rank"],
                density=ps.dims["density"], seed=ps.seed)
        return MFData(R, train, test)

    def supports(self, strategy):
        if strategy == "coded-prox":
            return "the ALS half-steps are ridge solves (l2); coded-prox " \
                   "requires l1"
        if strategy == "coded-bcd":
            return "bcd returns lifted block parameters, not the ridge " \
                   "iterate the ALS outer loop needs"
        if strategy == "async":
            return "each ALS half-step is a fresh problem; the async " \
                   "per-arrival stream assumes one persistent problem"
        return None

    def _run(self, strategy, engine, ps, data: MFData, *, device,
             **cfg) -> WorkloadRunResult:
        rank = ps.dims["rank"]
        epochs = cfg.pop("epochs", ps.dims["epochs"])
        inner_steps = cfg.pop("steps", ps.steps)
        lam = cfg.pop("lam", ps.lam)
        cfg.setdefault("k", ps.k)

        users, movies = data.R.shape
        rng = np.random.default_rng(ps.seed + 1)
        Ub = np.concatenate([rng.standard_normal((users, rank)) * 0.1,
                             np.zeros((users, 1))], axis=1).astype(np.float32)
        Vb = np.concatenate([rng.standard_normal((movies, rank)) * 0.1,
                             np.zeros((movies, 1))], axis=1).astype(np.float32)
        Rc = data.R - 3.0

        def predict():
            return (3.0 + Ub[:, :rank] @ Vb[:, :rank].T
                    + Ub[:, rank:] + Vb[:, rank:].T)

        times, objective, metric, half_steps = [], [], [], []
        now = 0.0
        step = 0
        for epoch in range(epochs):
            for side in ("u", "v"):
                fixed = Vb if side == "u" else Ub
                A, targ = _half_step_design(Rc, data.train, fixed, side)
                spec = ProblemSpec(X=A, y=targ, lam=lam, h="l2")
                w0 = (Ub if side == "u" else Vb).reshape(-1)
                res = get_strategy(strategy).run(
                    spec, sub_engine(engine, step), steps=inner_steps,
                    w0=w0, device=device, **dict(cfg))
                w = np.asarray(res.w, np.float32).reshape(-1, rank + 1)
                if side == "u":
                    Ub = w
                else:
                    Vb = w
                t0, now = now, now + res.wallclock
                with _obs_span("workload:score", workload=self.name):
                    pred = predict()
                    # penalized ALS objective: fit + l2 on BOTH factor
                    # blocks — constant in the fixed side, so exact/monotone
                    # inner solves make it non-increasing across half-steps.
                    fit = 0.5 * np.sum((pred[data.train]
                                        - data.R[data.train]) ** 2) \
                        / A.shape[0]
                    als_obj = float(fit + 0.5 * lam * (np.sum(Ub ** 2)
                                                       + np.sum(Vb ** 2)))
                    train_rmse = gt.masked_rmse(pred, data.R, data.train)
                    test_rmse = gt.masked_rmse(pred, data.R, data.test)
                times.append(now)
                objective.append(als_obj)
                metric.append(test_rmse)
                half_steps.append({
                    "epoch": epoch, "side": side,
                    "t_start": float(t0), "t_end": float(now),
                    "active_sets": [ev.active.tolist()
                                    for ev in res.schedule.events],
                    "train_rmse": train_rmse, "test_rmse": test_rmse,
                    "als_objective": als_obj,
                })
                step += 1
        times = np.asarray(times)
        return WorkloadRunResult(
            workload=self.name, strategy=strategy, preset=ps.name,
            metric_name=self.metric_name,
            times=times, objective=np.asarray(objective),
            metric_times=times, metric=np.asarray(metric),
            w=np.concatenate([Ub.reshape(-1), Vb.reshape(-1)]),
            meta={"encoder": res.meta.get("encoder", ""),
                  "rank": rank, "epochs": epochs,
                  "inner_steps": inner_steps, "lam": lam,
                  "train_rmse": half_steps[-1]["train_rmse"],
                  "objective": "penalized ALS objective"},
            extras={"half_steps": half_steps})
