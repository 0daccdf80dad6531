"""Gradient codes for coded data parallelism (port of
``repro.core.gradient_coding``; DESIGN §4, §15).  Host numpy only: the
assignments and decode weights equal the reference's bit for bit.

The paper's data-parallel theory encodes (X, y) inside a quadratic loss.  For
non-quadratic losses (e.g. LM cross-entropy) the gradient is still LINEAR in
per-group loss weights, so the paper's erasure-robustness transfers to the
microbatch->worker ASSIGNMENT: worker i computes

    g_i = sum_j  B[i, j] * grad l_j(w)

for a coefficient matrix B (m workers x b microbatch groups) and the master
combines  g~ = (1/b) sum_{i in A_t} c_i(A_t) g_i  with decode weights c
(``decode_weights``) chosen so g~ reproduces — exactly or in expectation —
the full-batch mean gradient.  The mask-as-erasure convention is DESIGN §3:
``mask[i] == 0`` means worker i's result never reaches the combine.

Three code families behind one :class:`GradientCode` surface:

  * :class:`FRCode` — FRACTIONAL REPETITION (Tandon et al., arXiv
    1612.03301 §III; the block layout matching the paper's Steiner §4.2.1):
    b = m/beta disjoint clusters, replicas carry identical data.  Exact
    whenever every cluster keeps >= 1 survivor, i.e. under ANY
    (beta-1)-per-group erasure pattern — and because replicas are
    bit-identical the decoded gradient is bit-for-bit the full-batch one.
  * :class:`CyclicRepetitionCode` — Tandon's cyclic code: b = m groups,
    worker i carries groups {i, .., i+beta-1} (mod m) with the randomized
    coefficient construction of arXiv 1612.03301 Alg. 1 (rows of B span the
    all-ones vector from ANY m-(beta-1) survivors).  Exact under any
    <= beta-1 TOTAL erasures, graceful (least-squares) beyond.
  * :class:`StochasticCode` — pair-wise balanced random assignment per
    Bitar et al. (arXiv 1905.05383): worker i carries ``beta`` of the m
    groups drawn uniformly, pair-inclusion probability q = beta/m, decode
    weight 1/(|A_t| q) per survivor.  Never exact, but an UNBIASED
    estimator of the full-batch gradient over the assignment randomness
    for every fixed mask, with variance bounded by
    sum_j ||grad_j||^2 / (b^2 |A_t| q) per coordinate (property-tested).
    ``at_step(t)`` re-draws the assignment per step (the SGC convention).

``make_code(name, m, beta)`` is the registry factory ("frc" | "cyclic" |
"stochastic" | "uncoded"); ``coded_weights`` is the FRC closed form the
train step and data pipeline use, in host float32 arithmetic with the
reference's order of operations.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GradientCode", "FRCode", "CyclicRepetitionCode",
           "StochasticCode", "GRADIENT_CODES", "make_code", "make_frc",
           "make_cyclic", "make_stochastic", "coded_weights",
           "decode_exact_possible", "assignment_matrix",
           "coded_microbatch_index"]


class GradientCode:
    """Shared surface of every gradient code (DESIGN §15).

    A code is (a) an assignment of ``num_groups`` data groups to ``m``
    workers with per-slot combine coefficients, and (b) a decode rule
    mapping an erasure mask to per-worker weights.  The aggregation
    contract every consumer relies on::

        g~ = (1/num_groups) * sum_i  decode_weights(mask)[i] * g_i,
        g_i = sum_s worker_coeffs[i, s] * grad(group worker_groups[i, s])

    equals the full-batch mean gradient exactly (exact codes, above their
    erasure threshold) or in expectation (stochastic codes).
    """

    codename = "?"
    stochastic = False       # True -> re-draw the assignment per step

    # -- assignment -----------------------------------------------------

    @property
    def num_groups(self) -> int:
        raise NotImplementedError

    @property
    def worker_groups(self) -> np.ndarray:
        """(m, g) group ids worker i computes (g slots per worker)."""
        raise NotImplementedError

    @property
    def worker_coeffs(self) -> np.ndarray:
        """(m, g) combine coefficient of each slot (B[i, group])."""
        raise NotImplementedError

    # -- decode ---------------------------------------------------------

    def decode_weights(self, mask: np.ndarray) -> np.ndarray:
        """Per-worker decode weights c (m,) for one erasure mask."""
        raise NotImplementedError

    def decode_exact_possible(self, mask: np.ndarray) -> bool:
        """True iff this mask is inside the code's exact-recovery region."""
        raise NotImplementedError

    def at_step(self, t: int) -> "GradientCode":
        """The code used at step t (stochastic codes re-draw; exact codes
        are static)."""
        return self


@dataclasses.dataclass(frozen=True)
class FRCode(GradientCode):
    m: int        # workers (data-axis shards)
    beta: int     # replication degree
    clusters: np.ndarray  # (m,) cluster id of each worker

    codename = "frc"

    @property
    def num_clusters(self) -> int:
        return self.m // self.beta

    @property
    def num_groups(self) -> int:
        return self.num_clusters

    @property
    def worker_groups(self) -> np.ndarray:
        return np.asarray(self.clusters, dtype=int)[:, None]

    @property
    def worker_coeffs(self) -> np.ndarray:
        return np.ones((self.m, 1), dtype=np.float32)

    def decode_weights(self, mask: np.ndarray) -> np.ndarray:
        return coded_weights(self, np.asarray(mask, np.float32))

    def decode_exact_possible(self, mask: np.ndarray) -> bool:
        return decode_exact_possible(self, mask)


def make_frc(m: int, beta: int = 2) -> FRCode:
    if m % beta:
        raise ValueError(f"m={m} not divisible by beta={beta}")
    # Interleaved assignment: replicas of a cluster are far apart in the mesh
    # (worker i -> cluster i mod b), so correlated failures of neighbouring
    # hosts do not take out both replicas.
    b = m // beta
    return FRCode(m, beta, np.arange(m) % b)


def assignment_matrix(code: GradientCode) -> np.ndarray:
    """B (m x b): combine coefficients of each (worker, group) pair.

    For the FRC this is the historical 0/1 cluster one-hot; for the cyclic
    code the Tandon coefficient matrix; for the stochastic code the 0/1
    random membership."""
    if isinstance(code, CyclicRepetitionCode):
        return np.asarray(code.B, dtype=float).copy()
    G = np.zeros((code.m, code.num_groups))
    wg, wc = code.worker_groups, code.worker_coeffs
    for i in range(code.m):
        np.add.at(G[i], wg[i], np.asarray(wc[i], dtype=float))
    return G


def decode_exact_possible(code, mask: np.ndarray) -> bool:
    """True iff every cluster has at least one active replica (FRC), or —
    for the other code families — the mask is inside their exact region."""
    if not isinstance(code, FRCode):
        return code.decode_exact_possible(mask)
    active_per_cluster = np.zeros(code.num_clusters)
    np.add.at(active_per_cluster, code.clusters, np.asarray(mask, float))
    return bool((active_per_cluster > 0).all())


def coded_weights(code, mask) -> np.ndarray:
    """Per-worker decode weights c_i(A_t), shape (m,), float32.

    FRC keeps the historical closed form: c_i = mask_i / (#active replicas
    in cluster(i)); fully-erased clusters get 0 and the result is rescaled
    by  b / #surviving_clusters  so the aggregate stays an unbiased mean
    over surviving data.  Every step is one float32 operation in the
    reference's order (its replica counts are sums of 0/1 values, exact in
    float32), so the weights equal the reference's bit for bit.  Other code
    families dispatch to their (host-side) ``decode_weights``.
    """
    if not isinstance(code, FRCode):
        return np.asarray(code.decode_weights(np.asarray(mask)), np.float32)
    f32 = np.float32
    mask = np.asarray(mask, f32)
    onehot = np.eye(code.num_clusters, dtype=f32)[code.clusters]   # (m, b)
    active = onehot.T @ mask                               # (b,) replicas alive
    alive = active > 0
    per_cluster = np.where(alive, f32(1.0) / np.maximum(active, f32(1.0)),
                           f32(0.0)).astype(f32)
    c = mask * (onehot @ per_cluster)                      # (m,)
    surviving = np.maximum(alive.sum(dtype=f32), f32(1.0))
    return c * (f32(code.num_clusters) / surviving)


def coded_microbatch_index(code: FRCode) -> np.ndarray:
    """For worker i, the cluster (data shard) index it loads: (m,).

    The data pipeline uses this to hand replica workers identical microbatches
    (data/pipeline.py); with the assigned shapes the global batch is
    interpreted as beta x effective-batch coded slots (DESIGN §4)."""
    return code.clusters.copy()


# ---------------------------------------------------------------------------
# Cyclic repetition code (Tandon et al., arXiv 1612.03301 Alg. 1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CyclicRepetitionCode(GradientCode):
    """b = m groups; worker i carries groups {i, .., i+beta-1} (mod m) with
    randomized coefficients B such that any m-(beta-1) rows of B span the
    all-ones row — so the master can solve  c^T B_A = 1^T  exactly under
    any <= beta-1 TOTAL erasures.  Note the contrast with the FRC: the
    cyclic support overlap buys a denser layout (b == m groups) at a
    STRICTER threshold (total, not per-group, erasures); naive 0/1 cyclic
    coefficients are NOT exactly decodable, hence the solved B."""
    m: int
    beta: int
    B: np.ndarray          # (m, m) Tandon coefficient matrix
    supports: np.ndarray   # (m, beta) group ids of worker i (cyclic window)

    codename = "cyclic"

    @property
    def num_groups(self) -> int:
        return self.m

    @property
    def worker_groups(self) -> np.ndarray:
        return np.asarray(self.supports, dtype=int)

    @property
    def worker_coeffs(self) -> np.ndarray:
        return np.take_along_axis(
            np.asarray(self.B, np.float32), self.worker_groups, axis=1)

    def decode_weights(self, mask: np.ndarray) -> np.ndarray:
        mask = np.asarray(mask, float).ravel()
        active = np.nonzero(mask > 0)[0]
        c = np.zeros(self.m, dtype=np.float32)
        if active.size == 0:
            return c
        # min ||B_A^T a - 1||: exact (residual ~0) whenever |erased| <=
        # beta-1 by the spanning property; the least-squares projection
        # degrades gracefully beyond.
        a, *_ = np.linalg.lstsq(np.asarray(self.B, float)[active].T,
                                np.ones(self.m), rcond=None)
        c[active] = a.astype(np.float32)
        return c

    def decode_exact_possible(self, mask: np.ndarray) -> bool:
        mask = np.asarray(mask, float).ravel()
        return bool((mask > 0).sum() >= self.m - (self.beta - 1))


def make_cyclic(m: int, beta: int = 2, seed: int = 0,
                _tries: int = 8) -> CyclicRepetitionCode:
    """Tandon's randomized construction: H (s x m) random normal with zero
    row sums (so 1 is in its null space), row i of B supported on the
    cyclic window {i, .., i+s} with the head coefficient pinned to 1 and
    the tail solving  H[:, tail] x = -H[:, head]  — making every row of B
    orthogonal to H, hence any m-s rows of B a basis of null(H) ∋ 1."""
    if not 1 <= beta <= m:
        raise ValueError(f"beta={beta} must be in [1, m={m}]")
    s = beta - 1
    supports = (np.arange(m)[:, None] + np.arange(s + 1)[None, :]) % m
    if s == 0:
        return CyclicRepetitionCode(m, beta, np.eye(m), supports)
    for attempt in range(_tries):
        rng = np.random.default_rng([seed, attempt, m, beta, 0xC7C11C])
        H = rng.standard_normal((s, m))
        H[:, -1] = -H[:, :-1].sum(axis=1)
        B = np.zeros((m, m))
        try:
            for i in range(m):
                head, tail = supports[i, 0], supports[i, 1:]
                B[i, head] = 1.0
                B[i, tail] = -np.linalg.solve(H[:, tail], H[:, head])
        except np.linalg.LinAlgError:   # singular window: re-draw H
            continue
        if np.isfinite(B).all():
            return CyclicRepetitionCode(m, beta, B, supports)
    raise RuntimeError(f"cyclic code construction failed for m={m}, "
                       f"beta={beta} after {_tries} draws")


# ---------------------------------------------------------------------------
# Stochastic (pair-wise balanced) code (Bitar et al., arXiv 1905.05383)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StochasticCode(GradientCode):
    """b = m groups; worker i carries ``beta`` groups drawn uniformly
    without replacement (pair-inclusion probability q = beta/m, the
    pair-wise balanced flavor of Bitar et al.).  Decode needs NO solve:
    every survivor is weighted  1/(|A_t| q), so for any FIXED mask

        E_code[ g~ ]  =  (1/b) sum_j E[#active holders of j]/(|A| q) grad_j
                      =  mean_j grad_j

    exactly — unbiased whatever the (even adversarial) erasure pattern,
    because the mask cannot depend on the fresh per-step assignment.
    Per-coordinate variance is bounded by sum_j grad_j^2 / (b^2 |A| q)
    (holders are Bernoulli(q) independent across workers, negatively
    correlated across groups)."""
    m: int
    beta: int
    groups: np.ndarray     # (m, beta) group ids of worker i
    seed: int = 0

    codename = "stochastic"
    stochastic = True

    @property
    def num_groups(self) -> int:
        return self.m

    @property
    def worker_groups(self) -> np.ndarray:
        return np.asarray(self.groups, dtype=int)

    @property
    def worker_coeffs(self) -> np.ndarray:
        return np.ones((self.m, self.beta), dtype=np.float32)

    def decode_weights(self, mask: np.ndarray) -> np.ndarray:
        mask = np.asarray(mask, np.float32).ravel()
        n_act = float((mask > 0).sum())
        if n_act == 0:
            return np.zeros(self.m, dtype=np.float32)
        q = self.beta / self.m
        return (mask / (n_act * q)).astype(np.float32)

    def decode_exact_possible(self, mask: np.ndarray) -> bool:
        return False          # approximate by design (unbiased, not exact)

    def at_step(self, t: int) -> "StochasticCode":
        return make_stochastic(self.m, self.beta, seed=self.seed, step=t)


def make_stochastic(m: int, beta: int = 2, seed: int = 0,
                    step: int = 0) -> StochasticCode:
    if not 1 <= beta <= m:
        raise ValueError(f"beta={beta} must be in [1, m={m}]")
    rng = np.random.default_rng([seed, step, m, beta, 0x5C0DE])
    groups = np.stack([rng.choice(m, size=beta, replace=False)
                       for _ in range(m)])
    return StochasticCode(m, beta, groups, seed=seed)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class _UncodedCode(FRCode):
    """Identity assignment (beta=1 FRC) under its own codename, so records
    and bench rows report the baseline as 'uncoded', not 'frc'."""
    codename = "uncoded"


def _make_uncoded(m: int, beta: int = 1, seed: int = 0) -> FRCode:
    base = make_frc(m, 1)     # identity assignment, no redundancy
    return _UncodedCode(m=base.m, beta=base.beta, clusters=base.clusters)


GRADIENT_CODES = {
    "frc": lambda m, beta=2, seed=0: make_frc(m, beta),
    "cyclic": lambda m, beta=2, seed=0: make_cyclic(m, beta, seed=seed),
    "stochastic": lambda m, beta=2, seed=0: make_stochastic(m, beta,
                                                            seed=seed),
    "bernoulli": lambda m, beta=2, seed=0: make_stochastic(m, beta,
                                                           seed=seed),
    "uncoded": _make_uncoded,
}


def make_code(name, m: int, beta: int = 2, seed: int = 0) -> GradientCode:
    """Build a gradient code by registry name; passes GradientCode
    instances through unchanged."""
    if isinstance(name, GradientCode):
        return name
    key = str(name).strip().lower()
    if key not in GRADIENT_CODES:
        raise KeyError(f"unknown gradient code '{name}'; have "
                       f"{sorted(GRADIENT_CODES)}")
    return GRADIENT_CODES[key](m, beta=beta, seed=seed)
