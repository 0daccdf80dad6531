"""rcv1-style logistic regression workload (paper §5.3, Figs 10-13).

Lowers to the lifted MODEL-parallel path: the feature dimension is encoded
(``make_lifted_problem`` + ``phi_logistic``) and every scheme — coded,
uncoded, replication — is a choice of feature encoder running encoded block
coordinate descent.  Data-parallel strategies (coded-gd/prox/lbfgs, async)
implement the quadratic loss only, so they are skip-with-reason here.

Metric: held-out classification error.  It needs the decoded iterate
w = S^T v, so the schedule is driven in chunks (v threaded through, one
fresh delay realization per chunk) and the error is recorded at each chunk
boundary.  The objective trace is the train logistic loss phi from the
device runner, at full per-iteration resolution.

Port of ``src/repro/workloads/logistic.py``.  The lifted blocks, the
labels and ``v`` live on the run's device.  Under
``encoder="fast-hadamard"`` the lift runs the SRHT kernel and each chunk's
decode the FWHT kernel where ``v`` lies; a dense encoder decodes on the
host, as the reference does.  Either way ``w`` comes to the host once a
chunk.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.paper_native import PAPER_LOGISTIC
from repro_torch.core.encoding import make_encoder
from repro_torch.core.model_parallel import make_lifted_problem, phi_logistic
from repro_torch.core.operators import FastHadamardEncoder
from repro_torch.data import logreg_dataset
from repro_torch.obs.trace import span as _obs_span
from repro_torch.runtime.engine import FastestK
from repro_torch.runtime.runners import scan_bcd

from .base import (Preset, Workload, WorkloadRunResult, register_workload,
                   chunk_sizes, sub_engine)
from . import ground_truth as gt


@dataclasses.dataclass(frozen=True)
class LogisticData:
    X_train: np.ndarray
    y_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray


_CFG = PAPER_LOGISTIC

# strategy name -> (encoder registry name, redundancy beta)
_ENCODER_OF = {
    "coded-bcd": ("hadamard", 2.0),
    "uncoded": ("uncoded", 1.0),
    "replication": ("replication", 2.0),
}

_DATA_PARALLEL = ("coded-gd", "coded-prox", "coded-lbfgs", "async")


def _decode(enc, v: torch.Tensor) -> np.ndarray:
    """w = S^T v as a host vector: the fast-Hadamard decode runs where v
    lies (the FWHT kernel on the card); a dense S^T multiplies on the host,
    as the reference's does."""
    G = v.reshape(-1, 1)
    if isinstance(enc, FastHadamardEncoder):
        return enc.decode_t(G)[:, 0].cpu().numpy()
    return np.asarray(enc.decode_t(G.cpu().numpy()))[:, 0]


@register_workload("logistic")
class Logistic(Workload):
    metric_name = "test_error"
    metric_goal = "min"
    paper_config = _CFG
    canonical_coded = "coded-bcd"
    presets = {
        "smoke": Preset("smoke", m=8, k=6, steps=80, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"n": 512, "p": 128, "density": 0.1,
                              "noise": 0.7, "test_frac": 0.2,
                              "records": 8}),
        "bench": Preset("bench", m=16, k=12, steps=120, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"n": 640, "p": 256, "density": 0.1,
                              "noise": 0.7, "test_frac": 0.2,
                              "records": 10}),
        # published §5.3 dims; k = 80 is the paper's middle cell
        "paper": Preset("paper", m=_CFG.m, k=80, steps=300, lam=_CFG.lam,
                        delay=_CFG.delay_model,
                        dims={"n": _CFG.n, "p": _CFG.p, "density": 0.1,
                              "noise": 0.3, "test_frac": 0.2,
                              "records": 20}),
    }

    def build(self, preset) -> LogisticData:
        ps = self.preset(preset)
        n, p = ps.dims["n"], ps.dims["p"]
        n_test = int(round(n * ps.dims["test_frac"]))
        with _obs_span("workload:data", workload=self.name):
            X, labels, _ = logreg_dataset(n, p, density=ps.dims["density"],
                                          noise=ps.dims["noise"],
                                          seed=ps.seed)
        return LogisticData(X[:-n_test], labels[:-n_test],
                            X[-n_test:], labels[-n_test:])

    def supports(self, strategy):
        if strategy in _DATA_PARALLEL:
            return "logistic lowers to the lifted BCD path; the " \
                   "data-parallel strategies implement the quadratic loss " \
                   "only"
        if strategy not in _ENCODER_OF:
            return f"no BCD lowering for '{strategy}'"
        return None

    def _run(self, strategy, engine, ps, data: LogisticData, *, device,
             **cfg) -> WorkloadRunResult:
        X, labels = data.X_train, data.y_train
        n, p = X.shape
        enc_default, beta_default = _ENCODER_OF[strategy]
        enc = make_encoder(cfg.pop("encoder", enc_default), p,
                           beta=cfg.pop("beta", beta_default),
                           seed=cfg.pop("encoder_seed", 0)).with_workers(
                               engine.m)
        val, grad = phi_logistic(labels, device=device)
        prob = make_lifted_problem(X, enc, engine.m, val, grad,
                                   device=device)
        # Hessian of phi is X^T D X / n with D <= 1/4; lifting multiplies the
        # spectral bound by beta (||S||^2 = beta for tight frames).
        L = float(np.linalg.eigvalsh(X.T @ X / n).max()) / 4.0
        step_size = cfg.pop("step_size", None) or 0.9 / (L * float(enc.beta))
        k = cfg.pop("k", ps.k)
        policy = cfg.pop("policy", None) or FastestK(k)
        steps = cfg.pop("steps", ps.steps)
        records = cfg.pop("records", ps.dims["records"])

        v = torch.zeros((engine.m, prob.XS.shape[-1]), dtype=torch.float32,
                        device=device)
        times, objective, metric_times, metric = [], [], [], []
        mean_active, now = [], 0.0
        for c, chunk in enumerate(chunk_sizes(steps, records)):
            sched = sub_engine(engine, c).sample_schedule(chunk, policy)
            v, tr = scan_bcd(prob, sched.masks, step_size, v)
            times.extend((now + sched.times).tolist())
            # tr[t+1] = phi AFTER commit t — aligns with sched.times
            objective.extend(tr[1:].cpu().numpy().tolist())
            now += float(sched.times[-1])
            w = _decode(enc, v)
            metric_times.append(now)
            with _obs_span("workload:score", workload=self.name):
                metric.append(gt.classification_error(data.X_test,
                                                      data.y_test, w))
            mean_active.append(float(sched.masks.sum(1).mean()))
        with _obs_span("workload:score", workload=self.name):
            train_error = gt.classification_error(X, labels, w)
        return WorkloadRunResult(
            workload=self.name, strategy=strategy, preset=ps.name,
            metric_name=self.metric_name,
            times=np.asarray(times), objective=np.asarray(objective),
            metric_times=np.asarray(metric_times), metric=np.asarray(metric),
            w=w,
            meta={"encoder": enc.name, "beta": float(enc.beta),
                  "step_size": float(step_size), "k": k,
                  "objective": "train logistic loss phi",
                  "train_error": train_error,
                  "mean_active": float(np.mean(mean_active))})
