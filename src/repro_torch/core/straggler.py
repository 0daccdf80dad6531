"""Straggler / delay models and active-set sampling (paper §5).

The paper's master waits for the fastest ``k`` of ``m`` workers per iteration.
On a bulk-synchronous TPU mesh we realize the same erasure semantics with a
per-step mask (see DESIGN.md §3).  This module provides:

  * the paper's delay distributions (bimodal Gaussian mixture §5.3,
    power-law background tasks §5.3, exponential §5.2, multimodal §5.4),
  * fastest-k active-set sampling and adversarial set sequences,
  * simulated wall-clock accounting (k-th order statistic per iteration),

all host-side numpy — masks are fed into jitted steps as inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

__all__ = [
    "DelayModel", "bimodal_delays", "power_law_delays", "exponential_delays",
    "multimodal_delays", "constant_delays", "fastest_k", "active_mask",
    "adversarial_sets", "WallClock", "simulate_run",
]

DelayModel = Callable[[np.random.Generator, int], np.ndarray]


def bimodal_delays(q: float = 0.5, mu1: float = 0.5, sig1: float = 0.2,
                   mu2: float = 20.0, sig2: float = 5.0) -> DelayModel:
    """Gaussian mixture delay (paper §5.3 logistic regression, model 1)."""
    def sample(rng: np.random.Generator, m: int) -> np.ndarray:
        slow = rng.random(m) > q
        d = rng.normal(mu1, sig1, size=m)
        d[slow] = rng.normal(mu2, sig2, size=slow.sum())
        return np.maximum(d, 0.0)
    return sample


def power_law_delays(alpha: float = 1.5, cap: int = 50,
                     per_task: float = 0.35) -> DelayModel:
    """#background tasks ~ power law (cap 50), delay ∝ tasks (paper §5.3 model 2)."""
    def sample(rng: np.random.Generator, m: int) -> np.ndarray:
        tasks = np.minimum(rng.pareto(alpha, size=m) + 1.0, cap)
        return per_task * tasks
    return sample


def exponential_delays(scale: float = 0.010) -> DelayModel:
    """exp(10ms) communication latency (paper §5.2 matrix factorization)."""
    def sample(rng: np.random.Generator, m: int) -> np.ndarray:
        return rng.exponential(scale, size=m)
    return sample


def multimodal_delays() -> DelayModel:
    """Three-component mixture used for LASSO (paper §5.4)."""
    qs = np.array([0.8, 0.1, 0.1])
    mus = np.array([0.2, 0.6, 1.0])
    sigs = np.array([0.1, 0.2, 0.4])
    def sample(rng: np.random.Generator, m: int) -> np.ndarray:
        comp = rng.choice(3, size=m, p=qs)
        return np.maximum(rng.normal(mus[comp], sigs[comp]), 0.0)
    return sample


def constant_delays(value: float = 1.0) -> DelayModel:
    def sample(rng: np.random.Generator, m: int) -> np.ndarray:
        return np.full(m, value)
    return sample


def fastest_k(delays: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k smallest delays (the active set A_t).

    ``k`` is clamped into [0, m]: k <= 0 selects nobody (the empty active
    set the fault-degradation paths must survive) and k >= m selects
    everyone — both without tripping ``argpartition``'s bounds."""
    m = delays.shape[0]
    if k <= 0:
        return np.zeros(0, dtype=np.intp)
    if k >= m:
        return np.arange(m)
    return np.argpartition(delays, k - 1)[:k]


def active_mask(m: int, active: np.ndarray) -> np.ndarray:
    mask = np.zeros(m, dtype=np.float32)
    mask[np.asarray(active)] = 1.0
    return mask


def adversarial_sets(m: int, k: int, steps: int) -> Iterator[np.ndarray]:
    """Deterministic worst-case rotation: the erased set sweeps all workers.

    Exercises the paper's 'arbitrary / adversarial {A_t}' guarantee — every
    worker is repeatedly erased, with maximal churn between iterations.
    """
    drop = m - k
    for t in range(steps):
        start = (t * drop) % m
        erased = (start + np.arange(drop)) % m
        keep = np.setdiff1d(np.arange(m), erased)
        yield keep


def adaptive_k(delays: np.ndarray, prev_active: np.ndarray | None,
               beta: float, k_min: int) -> np.ndarray:
    """Paper §3.3: the smallest fastest-k whose overlap with A_{t-1} exceeds
    m/beta — guarantees the L-BFGS overlap matrix S̆_t is full rank (eq. 7).

    Returns the active set (sorted worker indices).
    """
    m = delays.shape[0]
    order = np.argsort(delays)
    need = int(np.floor(m / beta)) + 1
    if prev_active is None:
        # first iteration: make the overlap condition satisfiable next step
        return np.sort(order[:max(k_min, need)])
    prev = set(np.asarray(prev_active).tolist())
    overlap = 0
    for k, w in enumerate(order, start=1):
        if int(w) in prev:
            overlap += 1
        if k >= k_min and overlap >= need:
            return np.sort(order[:k])
    return np.sort(order)  # worst case: wait for everyone


@dataclasses.dataclass
class WallClock:
    """Simulated wall-clock: each iteration costs the k-th order statistic of
    per-worker (delay + compute) plus a master overhead."""
    compute_time: float = 0.05
    master_overhead: float = 0.01
    elapsed: float = 0.0

    def tick(self, delays: np.ndarray, k: int) -> float:
        total = np.sort(delays + self.compute_time)[k - 1] + self.master_overhead
        self.elapsed += float(total)
        return self.elapsed


def simulate_run(model: DelayModel, m: int, k: int, steps: int, seed: int = 0,
                 compute_time: float = 0.05):
    """Yield (t, active_set, elapsed_seconds) for a straggler realization."""
    rng = np.random.default_rng(seed)
    clock = WallClock(compute_time=compute_time)
    for t in range(steps):
        d = model(rng, m)
        A = fastest_k(d, k)
        yield t, np.sort(A), clock.tick(d, k)
