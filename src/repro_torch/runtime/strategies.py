"""Strategy interface + registry for the straggler-mitigation schemes
(port of ``src/repro/runtime/strategies.py``).

``coded-gd`` / ``coded-prox`` (the paper's Algorithm 1), ``coded-lbfgs``
(Thm 4), ``coded-bcd`` (model parallelism, §2.2), ``uncoded``,
``replication`` and the ``async`` stale-gradient baseline build the
worker-resident problem for a shared ``ProblemSpec``, ask the
``ClusterEngine`` for a delay realization, run the device loop of
``runtime.runners`` (or ``core.lbfgs``) and return a wall-clock-vs-objective
``RunResult`` / ``TrialsResult``; ``coded-sgd`` trains an LM of the model
zoo on a ``train.TrainProblem`` (``train.coded``).  Every entry point takes ``device``: CUDA
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any

import numpy as np
import torch

from repro_torch.core.data_parallel import make_encoded_problem
from repro_torch.core.encoding import LinearEncoder, make_encoder
from repro_torch.core import operators  # noqa: F401  (registers matrix-free encoders)
from repro_torch.core.lbfgs import run_encoded_lbfgs
from repro_torch.core.model_parallel import make_lifted_problem, phi_quadratic
from repro_torch.device import resolve_device
from repro_torch.obs.trace import span as _obs_span

from .engine import (ActiveSetPolicy, AsyncTrace, ClusterEngine, FastestK,
                     _policy_k_min)
from .faults import make_degrade
from .runners import (batched_scan_async, batched_scan_bcd, batched_scan_gd,
                      batched_scan_prox, scan_async, scan_bcd, scan_gd,
                      scan_prox, sharded_scan_async, sharded_scan_gd,
                      sharded_scan_prox)

__all__ = [
    "ProblemSpec", "RunResult", "TrialsResult", "Strategy",
    "register_strategy", "get_strategy", "available_strategies",
    "json_safe_meta", "summary_stats", "check_trials", "resolve_eval_every",
]


def json_safe_meta(meta: dict) -> dict:
    """JSON-serializable view of a meta dict: primitives pass through,
    everything else (arrays, policies, ...) is stringified."""
    return {k: (v if isinstance(v, (int, float, str, bool)) else str(v))
            for k, v in meta.items()}


# ---------------------------------------------------------------------------
# Shared problem description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """The ORIGINAL (uncoded) problem every strategy is solving:
    f(w) = 1/(2n) ||X w - y||^2 + lam * h(w)."""
    X: np.ndarray
    y: np.ndarray
    lam: float = 0.05
    h: str = "l2"            # "l2" (ridge), "l1" (lasso), "none"

    @staticmethod
    def synthetic(n: int = 512, p: int = 128, *, noise: float = 0.5,
                  sparse: int = 0, lam: float = 0.05, h: str = "l2",
                  seed: int = 0) -> "ProblemSpec":
        from repro_torch.data import lsq_dataset
        X, y, _ = lsq_dataset(n, p, noise=noise, sparse=sparse, seed=seed)
        return ProblemSpec(X=X, y=y, lam=lam, h=h)

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def p(self) -> int:
        return self.X.shape[1]

    def lipschitz(self) -> float:
        """Smoothness constant of the data-fit term, max eig of X^T X / n."""
        return float(np.linalg.eigvalsh(self.X.T @ self.X / self.n).max())

    def w_star(self) -> np.ndarray:
        """Closed-form ridge optimum (h == 'l2' only)."""
        if self.h != "l2":
            raise ValueError("closed form only for the ridge objective")
        p = self.p
        return np.linalg.solve(self.X.T @ self.X / self.n +
                               self.lam * np.eye(p), self.X.T @ self.y / self.n)


@dataclasses.dataclass
class RunResult:
    """Wall-clock-vs-objective trace for one (strategy, delay model) cell."""
    strategy: str
    times: np.ndarray       # (T,) elapsed simulated seconds per record point
    objective: np.ndarray   # (T,) objective at each record point
    w: np.ndarray | None = None
    meta: dict = dataclasses.field(default_factory=dict)
    # The realized engine Schedule behind this run; host-side object,
    # deliberately NOT serialized by ``to_record``.
    schedule: Any = None

    @property
    def final_objective(self) -> float:
        return float(self.objective[-1])

    @property
    def wallclock(self) -> float:
        return float(self.times[-1])

    def to_record(self) -> dict:
        """JSON-serializable record (traces included, iterate omitted)."""
        return {
            "strategy": self.strategy,
            "times": np.asarray(self.times, dtype=float).tolist(),
            "objective": np.asarray(self.objective, dtype=float).tolist(),
            "final_objective": self.final_objective,
            "wallclock_s": self.wallclock,
            "meta": json_safe_meta(self.meta),
        }


def summary_stats(values) -> dict:
    """mean/p50/p95 of a per-realization vector (the Monte-Carlo summary
    attached to every batched record)."""
    a = np.asarray(values, dtype=float)
    return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95))}


@dataclasses.dataclass
class TrialsResult:
    """R delay realizations of one (strategy, delay model) cell, run as one
    device loop.  ``times``/``objective`` carry the per-realization traces
    stacked along the leading trial axis."""
    strategy: str
    times: np.ndarray       # (R, T') elapsed simulated seconds per record
    objective: np.ndarray   # (R, T') objective at each record point
    w: np.ndarray | None = None     # (R, p) final iterates
    meta: dict = dataclasses.field(default_factory=dict)
    # The realized ScheduleBatch; host-side, NOT serialized.
    schedules: Any = None

    @property
    def trials(self) -> int:
        return self.times.shape[0]

    @property
    def final_objective(self) -> np.ndarray:
        return np.asarray(self.objective)[:, -1]

    @property
    def wallclock(self) -> np.ndarray:
        return np.asarray(self.times)[:, -1]

    def realization(self, r: int) -> RunResult:
        """Realization r as a plain single-trial RunResult."""
        sched = None
        if self.schedules is not None:
            sched = self.schedules.realization(r)
        return RunResult(
            strategy=self.strategy, times=np.asarray(self.times)[r],
            objective=np.asarray(self.objective)[r],
            w=None if self.w is None else np.asarray(self.w)[r],
            meta=dict(self.meta), schedule=sched)

    def summary(self) -> dict:
        return {"trials": int(self.trials),
                "wallclock_s": summary_stats(self.wallclock),
                "final_objective": summary_stats(self.final_objective)}

    def to_record(self) -> dict:
        """JSON record: per-realization traces + the Monte-Carlo summary."""
        return {
            "strategy": self.strategy,
            "trials": int(self.trials),
            "times": np.asarray(self.times, dtype=float).tolist(),
            "objective": np.asarray(self.objective, dtype=float).tolist(),
            "final_objective": float(self.final_objective.mean()),
            "wallclock_s": float(self.wallclock.mean()),
            "summary": self.summary(),
            "meta": json_safe_meta(self.meta),
        }


# Every cell solving the same y on one device shares one phi pair, so its
# float32 copy of y is made once.  Bounded: each entry pins that copy.
@lru_cache(maxsize=8)
def _phi_quadratic_cached(y_bytes: bytes, dtype: str, shape: tuple,
                          device: str):
    return phi_quadratic(np.frombuffer(y_bytes, dtype=dtype).reshape(shape),
                         device=device)


def _phi_quadratic(y, device: torch.device) -> tuple:
    a = np.ascontiguousarray(np.asarray(y))
    return _phi_quadratic_cached(a.tobytes(), str(a.dtype), a.shape,
                                 str(device))


def _auto_step(spec: ProblemSpec) -> float:
    """Safe GD step for the (possibly encoded, eps<=0.3) smooth part."""
    return 1.0 / (1.3 * spec.lipschitz() + spec.lam)


def _default_k(m: int) -> int:
    return max(1, (3 * m) // 4)


def _resolve_encoder(encoder, n: int, *, beta: float, seed: int,
                     m: int) -> LinearEncoder:
    """Accept an encoder by registry name OR as a LinearEncoder instance,
    bound to the engine's worker count."""
    if isinstance(encoder, LinearEncoder):
        if encoder.n != n:
            raise ValueError(f"encoder dim {encoder.n} != problem dim {n}")
        return encoder.with_workers(m)
    return make_encoder(encoder, n, beta=beta, seed=seed).with_workers(m)


def _host(t: torch.Tensor) -> np.ndarray:
    """The one device-to-host copy of a run's result."""
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type["Strategy"]] = {}


def register_strategy(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> "Strategy":
    if name not in _REGISTRY:
        raise KeyError(f"unknown strategy '{name}'; have "
                       f"{available_strategies()}")
    return _REGISTRY[name]()


def available_strategies() -> list[str]:
    return sorted(_REGISTRY)


class Strategy:
    """One straggler-mitigation scheme. Subclasses implement ``run`` and
    (for the Monte-Carlo protocol) ``run_batched``."""

    name = "?"

    def run(self, spec: ProblemSpec, engine: ClusterEngine, *,
            steps: int = 200, device=None, **cfg: Any) -> RunResult:
        raise NotImplementedError

    def run_batched(self, spec: ProblemSpec, engine: ClusterEngine, *,
                    steps: int = 200, trials: int = 1, eval_every: int = 1,
                    placement: str = "vmap", device=None,
                    **cfg: Any) -> TrialsResult:
        """R delay realizations of this cell, one after the other (the
        fallback of schemes with host-side outer loops, and the
        ``placement='single'`` path): realization r is
        ``run(spec, engine.trial(r), ...)``."""
        check_trials(steps, trials, eval_every)
        stride_every = resolve_eval_every(steps, eval_every)
        results = [self.run(spec, engine.trial(r), steps=steps,
                            device=device, **dict(cfg))
                   for r in range(trials)]
        stride = slice(stride_every - 1, None, stride_every)
        return TrialsResult(
            strategy=self.name,
            times=np.stack([np.asarray(r.times) for r in results])[:, stride],
            objective=np.stack([np.asarray(r.objective)
                                for r in results])[:, stride],
            w=np.stack([np.asarray(r.w) for r in results]),
            meta={**results[0].meta, "trials": trials,
                  "eval_every": eval_every, "batched": False})


def check_trials(steps: int, trials: int, eval_every: int) -> None:
    """Validate a (steps, trials, eval_every) combination up front.

    ``eval_every=0`` is accepted and means "record the final objective
    only" (callers resolve it to ``steps`` via ``resolve_eval_every``).
    """
    if trials < 1:
        raise ValueError("trials must be >= 1")
    if eval_every < 0:
        raise ValueError(f"eval_every={eval_every} must be >= 0 "
                         f"(0 = final objective only)")
    if eval_every and steps % eval_every:
        raise ValueError(
            f"eval_every={eval_every} must divide steps={steps} "
            f"(steps % eval_every == {steps % eval_every}); use "
            f"eval_every=0 to record the final objective only")


def resolve_eval_every(steps: int, eval_every: int) -> int:
    """The effective record stride: ``eval_every=0`` ("final objective
    only") becomes a stride of the full schedule length."""
    return steps if eval_every == 0 else eval_every


# ---------------------------------------------------------------------------
# Synchronous data-parallel family (encoded / uncoded / replication)
# ---------------------------------------------------------------------------

def _resolve_degrade(policy: ActiveSetPolicy, cfg: dict):
    """Pop + parse the ``degrade`` config key; an unset ``k_min`` is bound
    to the policy's decode threshold (``runtime.faults``)."""
    deg = make_degrade(cfg.pop("degrade", None))
    if deg is not None and deg.k_min is None:
        deg = dataclasses.replace(deg, k_min=_policy_k_min(policy))
    return deg


def _fault_meta(engine: ClusterEngine, policy, degrade, masks) -> dict:
    """Fault-lane record fields: injected fault spec, degrade mode, and the
    realized sub-k iteration fraction (empty when faults are off)."""
    meta: dict = {}
    if degrade is not None:
        meta["degrade"] = degrade.mode
    if getattr(engine, "faults", None) is not None:
        meta["faults"] = engine.faults.spec
        k_floor = (degrade.k_min if degrade is not None
                   and degrade.k_min is not None else _policy_k_min(policy))
        meta["subk_fraction"] = float(
            (np.asarray(masks).sum(-1) < k_floor).mean())
    return meta


class _SyncGradientStrategy(Strategy):
    """Common machinery: encode rows, realize a schedule, run the loop."""

    encoder_name = "hadamard"
    encoder_beta = 2.0

    def _policy(self, engine: ClusterEngine, cfg: dict) -> ActiveSetPolicy:
        policy = cfg.pop("policy", None)
        k = cfg.pop("k", None)
        if policy is not None:
            return policy
        return FastestK(k if k is not None else _default_k(engine.m))

    def _problem(self, spec: ProblemSpec, engine: ClusterEngine, cfg: dict,
                 device):
        with _obs_span("encode", strategy=self.name, n=spec.n, m=engine.m):
            enc = _resolve_encoder(cfg.pop("encoder", self.encoder_name),
                                   spec.n,
                                   beta=cfg.pop("beta", self.encoder_beta),
                                   seed=cfg.pop("encoder_seed", 0),
                                   m=engine.m)
            prob = make_encoded_problem(spec.X, spec.y, enc, engine.m,
                                        lam=spec.lam, device=device)
        return enc, prob

    def run(self, spec, engine, *, steps=200, device=None, **cfg):
        device = resolve_device(device)
        policy = self._policy(engine, cfg)
        degrade = _resolve_degrade(policy, cfg)
        enc, prob = self._problem(spec, engine, cfg, device)
        step_size = cfg.pop("step_size", None) or _auto_step(spec)
        w0 = torch.as_tensor(np.asarray(cfg.pop("w0", np.zeros(spec.p))),
                             dtype=torch.float32, device=device)
        sched = engine.sample_schedule(steps, policy, degrade=degrade)
        masks = torch.as_tensor(sched.masks, device=device)
        if spec.h == "l1":
            w, tr = scan_prox(prob, masks, step_size, w0, degrade=degrade)
        else:
            w, tr = scan_gd(prob, masks, step_size, w0, h=spec.h,
                            degrade=degrade)
        return RunResult(
            strategy=self.name, times=sched.times, objective=_host(tr),
            w=_host(w),
            meta={"encoder": enc.name, "beta": enc.beta,
                  "policy": type(policy).__name__, "step_size": step_size,
                  "mean_active": float(sched.masks.sum(1).mean()),
                  **_fault_meta(engine, policy, degrade, sched.masks)},
            schedule=sched)

    def run_batched(self, spec, engine, *, steps=200, trials=1, eval_every=1,
                    placement="vmap", device=None, **cfg):
        """R realizations as ONE device loop: encode once, draw the
        (R, T, m) schedule stack, run the batched runner.
        ``placement='single'`` takes the sequential host loop instead;
        ``'sharded'`` spreads the realizations over the visible cards
        (``runners.sharded_scan_gd``) and records their count."""
        if placement == "single":
            return Strategy.run_batched(self, spec, engine, steps=steps,
                                        trials=trials, eval_every=eval_every,
                                        device=device, **cfg)
        device = resolve_device(device)
        check_trials(steps, trials, eval_every)
        stride_every = resolve_eval_every(steps, eval_every)
        policy = self._policy(engine, cfg)
        degrade = _resolve_degrade(policy, cfg)
        enc, prob = self._problem(spec, engine, cfg, device)
        step_size = cfg.pop("step_size", None) or _auto_step(spec)
        w0 = torch.as_tensor(np.asarray(cfg.pop("w0", np.zeros(spec.p))),
                             dtype=torch.float32, device=device)
        w0 = w0[None].repeat(trials, 1)
        batch = engine.sample_schedules(steps, policy, trials,
                                        degrade=degrade)
        masks = torch.as_tensor(batch.masks, device=device)
        meta = {"encoder": enc.name, "beta": enc.beta,
                "policy": type(policy).__name__, "step_size": step_size,
                "trials": trials, "eval_every": eval_every,
                "batched": True,
                "mean_active": float(batch.masks.sum(-1).mean()),
                **_fault_meta(engine, policy, degrade, batch.masks)}
        if placement == "sharded":
            if spec.h == "l1":
                w, tr, ndev = sharded_scan_prox(prob, masks, step_size, w0,
                                                eval_every=stride_every,
                                                degrade=degrade)
            else:
                w, tr, ndev = sharded_scan_gd(prob, masks, step_size, w0,
                                              h=spec.h,
                                              eval_every=stride_every,
                                              degrade=degrade)
            meta.update(placement="sharded", placement_devices=ndev)
        elif spec.h == "l1":
            w, tr = batched_scan_prox(prob, masks, step_size, w0,
                                      eval_every=stride_every,
                                      degrade=degrade)
        else:
            w, tr = batched_scan_gd(prob, masks, step_size, w0, h=spec.h,
                                    eval_every=stride_every, degrade=degrade)
        return TrialsResult(
            strategy=self.name,
            times=batch.times[:, stride_every - 1::stride_every],
            objective=_host(tr), w=_host(w), meta=meta, schedules=batch)

    def run_cellbatched(self, spec, engines, *, steps=200, trials=1,
                        eval_every=1, cfgs=None, device=None):
        """C compatible cells of a matrix as ONE device loop.

        ``engines[ci]`` / ``cfgs[ci]`` carry cell ci's cluster and config;
        cells may differ in policy, delay and ``step_size`` but share the
        problem, encoder config, worker count and step budget.  The problem
        is encoded ONCE, the C x R schedule stacks are concatenated along
        the realization axis, and one batched runner call runs them all
        with a per-realization step vector.  Returns one ``TrialsResult``
        per cell (meta gains ``cell_batched: C``), equal bit for bit to the
        cell's own ``run_batched``.
        """
        device = resolve_device(device)
        C = len(engines)
        cfgs = [dict(c) for c in (cfgs if cfgs is not None else [{}] * C)]
        if len(cfgs) != C:
            raise ValueError(f"{C} engines but {len(cfgs)} cfgs")
        check_trials(steps, trials, eval_every)
        stride_every = resolve_eval_every(steps, eval_every)
        ms = {e.m for e in engines}
        if len(ms) > 1:
            raise ValueError(f"cell batch mixes worker counts {sorted(ms)}")
        policies = [self._policy(e, cfg) for e, cfg in zip(engines, cfgs)]
        degrades = [_resolve_degrade(pol, cfg)
                    for pol, cfg in zip(policies, cfgs)]
        # the runner's degrade config is shared by the whole stacked run,
        # so a batch must be degrade-homogeneous
        if len({d for d in degrades}) > 1:
            raise ValueError("cell batch mixes degrade policies "
                             f"{sorted({str(d) for d in degrades})}")
        degrade = degrades[0]
        enc, prob = self._problem(spec, engines[0], cfgs[0], device)
        for cfg in cfgs[1:]:     # the shared encode consumed cfgs[0]'s keys
            for key in ("encoder", "beta", "encoder_seed"):
                cfg.pop(key, None)
        step_sizes = [cfg.pop("step_size", None) or _auto_step(spec)
                      for cfg in cfgs]
        w0s = [torch.as_tensor(np.asarray(cfg.pop("w0", np.zeros(spec.p))),
                               dtype=torch.float32, device=device)
               for cfg in cfgs]
        batches = [e.sample_schedules(steps, pol, trials, degrade=degrade)
                   for e, pol in zip(engines, policies)]
        masks = torch.as_tensor(np.concatenate([b.masks for b in batches]),
                                device=device)
        w0 = torch.cat([w[None].repeat(trials, 1) for w in w0s])
        step_vec = torch.as_tensor(step_sizes, dtype=torch.float32,
                                   device=device).repeat_interleave(trials)
        if spec.h == "l1":
            w, tr = batched_scan_prox(prob, masks, step_vec, w0,
                                      eval_every=stride_every,
                                      degrade=degrade)
        else:
            w, tr = batched_scan_gd(prob, masks, step_vec, w0, h=spec.h,
                                    eval_every=stride_every, degrade=degrade)
        w, tr = _host(w), _host(tr)
        results = []
        for ci in range(C):
            sl = slice(ci * trials, (ci + 1) * trials)
            batch = batches[ci]
            results.append(TrialsResult(
                strategy=self.name,
                times=batch.times[:, stride_every - 1::stride_every],
                objective=tr[sl], w=w[sl],
                meta={"encoder": enc.name, "beta": enc.beta,
                      "policy": type(policies[ci]).__name__,
                      "step_size": step_sizes[ci], "trials": trials,
                      "eval_every": eval_every, "batched": True,
                      "cell_batched": C,
                      "mean_active": float(batch.masks.sum(-1).mean()),
                      **_fault_meta(engines[ci], policies[ci], degrade,
                                    batch.masks)},
                schedules=batch))
        return results


@register_strategy("coded-gd")
class CodedGD(_SyncGradientStrategy):
    """Encoded gradient descent / ISTA (paper §2.1, Algorithms 1-2)."""


@register_strategy("coded-prox")
class CodedProx(_SyncGradientStrategy):
    """Encoded proximal gradient for the l1 objective (paper Thm 5)."""

    def run(self, spec, engine, *, steps=200, **cfg):
        if spec.h != "l1":
            raise ValueError("coded-prox requires an l1 ProblemSpec")
        return super().run(spec, engine, steps=steps, **cfg)

    def run_batched(self, spec, engine, *, steps=200, trials=1, eval_every=1,
                    **cfg):
        if spec.h != "l1":
            raise ValueError("coded-prox requires an l1 ProblemSpec")
        return super().run_batched(spec, engine, steps=steps, trials=trials,
                                   eval_every=eval_every, **cfg)

    def run_cellbatched(self, spec, engines, *, steps=200, trials=1,
                        eval_every=1, cfgs=None, device=None):
        if spec.h != "l1":
            raise ValueError("coded-prox requires an l1 ProblemSpec")
        return super().run_cellbatched(spec, engines, steps=steps,
                                       trials=trials, eval_every=eval_every,
                                       cfgs=cfgs, device=device)


@register_strategy("uncoded")
class UncodedSync(_SyncGradientStrategy):
    """Synchronous uncoded baseline: S = I, fastest-k drops data (§5)."""
    encoder_name = "uncoded"
    encoder_beta = 1.0


@register_strategy("replication")
class Replication(_SyncGradientStrategy):
    """beta-fold data replication baseline: S = [I; ...; I] (§5)."""
    encoder_name = "replication"
    encoder_beta = 2.0


def _reject_hold(name: str, degrade, why: str) -> None:
    if degrade is not None and degrade.mode == "hold":
        raise ValueError(f"{name} supports renormalize/backoff degrade only "
                         f"({why}; see DESIGN.md §14)")


def _w0(cfg: dict, device):
    w0 = cfg.pop("w0", None)
    return None if w0 is None else torch.as_tensor(
        np.asarray(w0), dtype=torch.float32, device=device)


@register_strategy("coded-lbfgs")
class CodedLBFGS(_SyncGradientStrategy):
    """Encoded L-BFGS (paper Thm 4); Python-loop outer iteration (the
    two-loop memory is host state), masks/wall-clock from the engine.
    ``encoder=`` covers Fig. 7's uncoded, replication and Hadamard arms."""

    _why_no_hold = "the two-loop memory is host state"

    def run(self, spec, engine, *, steps=200, device=None, **cfg):
        if spec.h != "l2":
            raise ValueError("coded-lbfgs requires the ridge objective")
        device = resolve_device(device)
        policy = self._policy(engine, cfg)
        degrade = _resolve_degrade(policy, cfg)
        _reject_hold("coded-lbfgs", degrade, self._why_no_hold)
        enc, prob = self._problem(spec, engine, cfg, device)
        memory = cfg.pop("memory", 10)
        w0 = _w0(cfg, device)
        sched = engine.sample_schedule(steps, policy, degrade=degrade)
        with _obs_span("runner:lbfgs", steps=steps):
            w, tr = run_encoded_lbfgs(prob, sched.masks, memory=memory,
                                      w0=w0)
        return RunResult(
            strategy=self.name, times=sched.times, objective=_host(tr),
            w=_host(w),
            meta={"encoder": enc.name, "beta": enc.beta, "memory": memory,
                  "policy": type(policy).__name__,
                  **_fault_meta(engine, policy, degrade, sched.masks)},
            schedule=sched)

    def run_batched(self, spec, engine, *, steps=200, trials=1, eval_every=1,
                    placement="vmap", device=None, **cfg):
        """The two-loop memory is host state, so realizations run one after
        the other whatever ``placement`` asks; the encode and the schedule
        stack are built once, and the trace is strided like the other
        runners'."""
        if spec.h != "l2":
            raise ValueError("coded-lbfgs requires the ridge objective")
        device = resolve_device(device)
        check_trials(steps, trials, eval_every)
        stride_every = resolve_eval_every(steps, eval_every)
        policy = self._policy(engine, cfg)
        degrade = _resolve_degrade(policy, cfg)
        _reject_hold("coded-lbfgs", degrade, self._why_no_hold)
        enc, prob = self._problem(spec, engine, cfg, device)
        memory = cfg.pop("memory", 10)
        w0 = _w0(cfg, device)
        batch = engine.sample_schedules(steps, policy, trials,
                                        degrade=degrade)
        ws, trs = [], []
        for r in range(trials):
            with _obs_span("runner:lbfgs", steps=steps, realization=r):
                w, tr = run_encoded_lbfgs(prob, batch.masks[r],
                                          memory=memory, w0=w0)
            ws.append(w)
            trs.append(tr)
        stride = slice(stride_every - 1, None, stride_every)
        return TrialsResult(
            strategy=self.name, times=batch.times[:, stride],
            objective=_host(torch.stack(trs))[:, stride],
            w=_host(torch.stack(ws)),
            meta={"encoder": enc.name, "beta": enc.beta, "memory": memory,
                  "policy": type(policy).__name__, "trials": trials,
                  "eval_every": eval_every, "batched": False,
                  **_fault_meta(engine, policy, degrade, batch.masks)},
            schedules=batch)


@register_strategy("coded-bcd")
class CodedBCD(_SyncGradientStrategy):
    """Encoded block coordinate descent (model parallelism, paper §2.2).

    Encodes the FEATURE dimension and minimizes phi(Xw) = 1/(2n)||Xw - y||^2
    (no regularizer — the lifted geometry is exact, Thm 6); the reported
    objective is phi, noted in ``meta``.
    """

    _why_no_hold = "an erased block simply holds its coordinates"

    def _lifted(self, spec, engine, cfg, device):
        with _obs_span("encode", strategy=self.name, p=spec.p, m=engine.m):
            enc = _resolve_encoder(cfg.pop("encoder", "hadamard"), spec.p,
                                   beta=cfg.pop("beta", 2.0),
                                   seed=cfg.pop("encoder_seed", 0),
                                   m=engine.m)
            val, grad = _phi_quadratic(spec.y, device)
            prob = make_lifted_problem(spec.X, enc, engine.m, val, grad,
                                       device=device)
        # the lifted quadratic's Hessian S X^T X S^T / n has norm <= beta L
        step_size = cfg.pop("step_size", None) or \
            0.9 / (spec.lipschitz() * float(enc.beta))
        return enc, prob, step_size

    def run(self, spec, engine, *, steps=200, device=None, **cfg):
        device = resolve_device(device)
        policy = self._policy(engine, cfg)
        degrade = _resolve_degrade(policy, cfg)
        _reject_hold("coded-bcd", degrade, self._why_no_hold)
        enc, prob, step_size = self._lifted(spec, engine, cfg, device)
        v0 = torch.zeros((engine.m, prob.XS.shape[-1]), device=device)
        sched = engine.sample_schedule(steps, policy, degrade=degrade)
        v, tr = scan_bcd(prob, sched.masks, step_size, v0)
        # align: tr[t+1] is the objective AFTER commit t (length T+1)
        return RunResult(
            strategy=self.name, times=sched.times,
            objective=_host(tr)[1:], w=_host(v),
            meta={"encoder": enc.name, "beta": enc.beta,
                  "objective": "phi(Xw) (unregularized, exact-optimum family)",
                  "step_size": step_size,
                  **_fault_meta(engine, policy, degrade, sched.masks)},
            schedule=sched)

    def run_batched(self, spec, engine, *, steps=200, trials=1, eval_every=1,
                    placement="vmap", device=None, **cfg):
        if placement == "single":
            return Strategy.run_batched(self, spec, engine, steps=steps,
                                        trials=trials, eval_every=eval_every,
                                        device=device, **cfg)
        device = resolve_device(device)
        check_trials(steps, trials, eval_every)
        stride_every = resolve_eval_every(steps, eval_every)
        policy = self._policy(engine, cfg)
        degrade = _resolve_degrade(policy, cfg)
        _reject_hold("coded-bcd", degrade, self._why_no_hold)
        enc, prob, step_size = self._lifted(spec, engine, cfg, device)
        batch = engine.sample_schedules(steps, policy, trials,
                                        degrade=degrade)
        v0 = torch.zeros((trials, engine.m, prob.XS.shape[-1]),
                         device=device)
        v, tr = batched_scan_bcd(prob, batch.masks, step_size, v0,
                                 eval_every=stride_every)
        meta = {"encoder": enc.name, "beta": enc.beta,
                "objective": "phi(Xw) (unregularized, exact-optimum family)",
                "step_size": step_size, "trials": trials,
                "eval_every": eval_every, "batched": True,
                **_fault_meta(engine, policy, degrade, batch.masks)}
        if placement == "sharded":
            # the lifted problem carries host phi callables; realizations
            # stay on one device, as the reference keeps them vmapped
            meta.update(placement="vmap",
                        placement_fallback="sharded unsupported for the "
                                           "lifted BCD problem")
        # batched bcd traces are post-commit (== scan_bcd's tr[1:] at s=1)
        return TrialsResult(
            strategy=self.name,
            times=batch.times[:, stride_every - 1::stride_every],
            objective=_host(tr), w=_host(v), meta=meta, schedules=batch)


# ---------------------------------------------------------------------------
# Coded SGD on the neural model zoo (train-kind cells)
# ---------------------------------------------------------------------------

@register_strategy("coded-sgd")
class CodedSGD(Strategy):
    """Gradient-coded data-parallel SGD training a real LM (train/coded.py).

    ``spec`` is a ``repro_torch.train.TrainProblem`` (not a
    ``ProblemSpec``); the ``objective`` trace is the decoded training loss,
    times come from the engine schedule.  cfg: code ("frc" | "cyclic" |
    "stochastic" | "uncoded"), beta, policy/k, lr, warmup, degrade,
    log_every.  The train module is imported lazily so registry load never
    pulls the model zoo.
    """

    def run(self, spec, engine, *, steps=100, device=None, **cfg):
        from repro_torch.train.coded import run_coded_sgd
        return run_coded_sgd(spec, engine, steps=steps, device=device, **cfg)

    def run_batched(self, spec, engine, *, steps=100, trials=1, eval_every=1,
                    placement="vmap", device=None, **cfg):
        """Sequential trial loop; the base implementation would stack the
        absent iterate."""
        check_trials(steps, trials, eval_every)
        stride_every = resolve_eval_every(steps, eval_every)
        results = [self.run(spec, engine.trial(r), steps=steps,
                            device=device, **dict(cfg))
                   for r in range(trials)]
        stride = slice(stride_every - 1, None, stride_every)
        return TrialsResult(
            strategy=self.name,
            times=np.stack([np.asarray(r.times) for r in results])[:, stride],
            objective=np.stack([np.asarray(r.objective)
                                for r in results])[:, stride],
            w=None,
            meta={**results[0].meta, "trials": trials,
                  "eval_every": eval_every, "batched": False})


# ---------------------------------------------------------------------------
# Asynchronous stale-gradient SGD
# ---------------------------------------------------------------------------

@register_strategy("async")
class AsyncSGD(Strategy):
    """Asynchronous stale-gradient SGD with bounded staleness (paper §5).

    Uncoded row partition; every arriving worker gradient is applied
    immediately (per-arrival wall-clock — no barrier), computed at the iterate
    that worker last read (per-worker parameter timestamps).  Gradients staler
    than ``staleness_bound`` are discarded by the engine, so the device runner
    only ever sees bounded staleness.
    """

    def _problem(self, spec, engine, device):
        m = engine.m
        with _obs_span("encode", strategy=self.name, n=spec.n, m=m):
            enc = make_encoder("uncoded", spec.n, beta=1.0).with_workers(m)
            return make_encoded_problem(spec.X, spec.y, enc, m, lam=spec.lam,
                                        device=device)

    def run(self, spec, engine, *, steps=200, device=None, **cfg):
        if spec.h == "l1":
            raise ValueError("async baseline covers smooth objectives only")
        device = resolve_device(device)
        m = engine.m
        # per-arrival accounting has no barrier to degrade: crashed workers
        # simply stop contributing and corrupt arrivals are discarded by
        # the engine, so any requested degrade mode is a no-op here
        cfg.pop("degrade", None)
        bound = int(cfg.pop("staleness_bound", 2 * m))
        updates = int(cfg.pop("updates", steps * m))
        step_size = (cfg.pop("step_size", None) or _auto_step(spec)) / m
        prob = self._problem(spec, engine, device)
        trace: AsyncTrace = engine.sample_async(updates, bound)
        w0 = torch.as_tensor(np.asarray(cfg.pop("w0", np.zeros(spec.p))),
                             dtype=torch.float32, device=device)
        w, tr = scan_async(prob, trace.workers, trace.staleness, step_size,
                           w0, buffer_size=bound + 1, h=spec.h)
        meta = {"staleness_bound": bound, "updates": updates,
                "dropped": trace.dropped,
                "mean_staleness": float(trace.staleness.mean()),
                "max_staleness": int(trace.staleness.max()),
                "step_size": step_size}
        if engine.faults is not None:
            meta["faults"] = engine.faults.spec
            meta["corrupted"] = int(trace.corrupted)
        return RunResult(
            strategy=self.name, times=trace.times, objective=_host(tr),
            w=_host(w), meta=meta, schedule=trace)

    def run_batched(self, spec, engine, *, steps=200, trials=1, eval_every=1,
                    placement="vmap", device=None, **cfg):
        if spec.h == "l1":
            raise ValueError("async baseline covers smooth objectives only")
        m = engine.m
        cfg.pop("degrade", None)       # no barrier to degrade (see run())
        bound = int(cfg.pop("staleness_bound", 2 * m))
        updates = int(cfg.pop("updates", steps * m))
        check_trials(updates, trials, eval_every)
        stride_every = resolve_eval_every(updates, eval_every)
        if placement == "single":
            results = [self.run(spec, engine.trial(r), steps=steps,
                                staleness_bound=bound, updates=updates,
                                device=device, **dict(cfg))
                       for r in range(trials)]
            stride = slice(stride_every - 1, None, stride_every)
            return TrialsResult(
                strategy=self.name,
                times=np.stack([np.asarray(r.times)
                                for r in results])[:, stride],
                objective=np.stack([np.asarray(r.objective)
                                    for r in results])[:, stride],
                w=np.stack([np.asarray(r.w) for r in results]),
                meta={**results[0].meta, "trials": trials,
                      "eval_every": eval_every, "batched": False})
        device = resolve_device(device)
        step_size = (cfg.pop("step_size", None) or _auto_step(spec)) / m
        prob = self._problem(spec, engine, device)
        batch = engine.sample_asyncs(updates, bound, trials)
        w0 = torch.as_tensor(np.asarray(cfg.pop("w0", np.zeros(spec.p))),
                             dtype=torch.float32, device=device)
        w0 = w0[None].repeat(trials, 1)
        meta = {"staleness_bound": bound, "updates": updates,
                "dropped": [int(d) for d in batch.dropped],
                "mean_staleness": float(batch.staleness.mean()),
                "max_staleness": int(batch.staleness.max()),
                "step_size": step_size, "trials": trials,
                "eval_every": eval_every, "batched": True}
        if engine.faults is not None:
            meta["faults"] = engine.faults.spec
            if batch.corrupted is not None:
                meta["corrupted"] = [int(c) for c in batch.corrupted]
        kw = dict(buffer_size=bound + 1, h=spec.h, eval_every=stride_every)
        if placement == "sharded":
            w, tr, ndev = sharded_scan_async(prob, batch.workers,
                                             batch.staleness, step_size, w0,
                                             **kw)
            meta.update(placement="sharded", placement_devices=ndev)
        else:
            w, tr = batched_scan_async(prob, batch.workers, batch.staleness,
                                       step_size, w0, **kw)
        return TrialsResult(
            strategy=self.name,
            times=batch.times[:, stride_every - 1::stride_every],
            objective=_host(tr), w=_host(w), meta=meta, schedules=batch)
