"""Encoding operators for encoded distributed optimization (paper §4).

Convention used throughout this repo
------------------------------------
An encoder for data dimension ``n`` with redundancy ``beta`` is a linear
OPERATOR whose action is that of a tall matrix ``S`` of shape
``(beta * n, n)``, normalized so that a *tight frame* satisfies

    S.T @ S = beta * I_n            (exactly, for ETF / Hadamard / Haar / FRC)

and a generic (e.g. Gaussian) encoder satisfies it approximately.  With this
convention the Block-RIP condition (paper Def. 1) reads: for every worker
subset ``A`` of fraction ``eta``,

    (1 - eps) I  <=  (1 / (eta * beta)) S_A.T S_A  <=  (1 + eps) I .

Encoders expose ``encode`` (S @ X), ``decode_t`` (the adjoint S.T @ G),
``worker_block`` (rows of S X owned by one worker), and ``materialize``
(the dense S, for tests and spectrum diagnostics) — see ``LinearEncoder``.
Consumers never form S themselves: the dense constructions in this module
carry an explicit matrix, while the matrix-free operators in
``core.operators`` (fast Hadamard / block-diagonal) compute the same maps
in O(N log N) / per-shard time and unlock ``n`` where ``(beta*n, n)``
cannot even be allocated.

Row blocks are assigned to ``m`` workers contiguously (``with_workers`` /
``partition_rows``).  Dense constructions are host-side numpy; iteration
code consumes torch tensors.
"""
from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np

__all__ = [
    "LinearEncoder",
    "Encoder",
    "DenseEncoder",
    "as_dense",
    "gaussian_encoder",
    "hadamard_encoder",
    "haar_encoder",
    "paley_etf_encoder",
    "steiner_etf_encoder",
    "replication_encoder",
    "identity_encoder",
    "partition_rows",
    "pad_rows",
    "brip_constant",
    "subset_spectrum",
    "hadamard_matrix",
    "hadamard_ensemble",
    "make_encoder",
    "register_encoder",
    "available_encoders",
]


class LinearEncoder:
    """A matrix-free encoding operator S of shape ``(rows, n)``.

    Subclasses provide ``name``, ``n``, ``rows``, ``beta``, ``tight`` and the
    linear maps; this base supplies the worker-partition machinery.  The
    operator is *unpartitioned* until ``with_workers(m)`` binds it to ``m``
    workers (zero-padding the row count to a multiple of ``m`` — zero rows
    carry no data, so S^T S, tightness and BRIP are unchanged).

    ``encode``/``decode_t``/``worker_block`` accept 1-D ``(n,)`` or 2-D
    ``(n, q)`` inputs and return numpy arrays or torch tensors depending on the
    backing implementation — callers that need host arrays ``np.asarray``
    the result.
    """

    # subclasses define ``name`` (str); worker partition state below.  Plain
    # class attributes (not annotated) so the dataclass machinery of dense
    # subclasses does not absorb them as implicit field defaults.
    m = None                 # worker count once partitioned
    _pad = 0                 # trailing zero rows added by with_workers

    # -- shape/metadata (subclass responsibility) ---------------------------
    @property
    def n(self) -> int:
        raise NotImplementedError

    @property
    def rows(self) -> int:
        raise NotImplementedError

    # -- linear maps (subclass responsibility) ------------------------------
    def encode(self, X):
        """S @ X: (n, q) -> (rows, q)."""
        raise NotImplementedError

    def decode_t(self, G):
        """Adjoint S.T @ G: (rows, q) -> (n, q)."""
        raise NotImplementedError

    def worker_block_local(self, i: int, X_local):
        """Worker ``i``'s rows of S X, given only ``X[input_slice(i)]``.

        Default delegates to ``encode`` on the (full-slice) input and takes
        the worker's row window; implementations with structure (block
        diagonal, aligned FWHT) override with a cheaper per-block map.
        """
        lo, hi = self.worker_rows(i)
        out = self.encode(X_local)
        return out[lo:hi]

    def materialize(self) -> np.ndarray:
        """The dense ``(rows, n)`` matrix — tests / spectrum tools only."""
        return np.asarray(self.encode(np.eye(self.n)), dtype=np.float64)

    # -- worker partition ---------------------------------------------------
    def with_workers(self, m: int) -> "LinearEncoder":
        """Bind the operator to ``m`` workers (idempotent), zero-padding the
        row count to a multiple of ``m``."""
        if self.m == m:
            return self
        if self.m is not None:
            raise ValueError(
                f"encoder already partitioned for m={self.m}, asked m={m}")
        new = copy.copy(self)
        new._pad = self._pad + ((-self.rows) % m)
        new.m = int(m)
        return new

    def _require_workers(self) -> int:
        if self.m is None:
            raise ValueError("encoder not partitioned; call with_workers(m)")
        return self.m

    @property
    def rows_per_worker(self) -> int:
        return self.rows // self._require_workers()

    def worker_rows(self, i: int) -> tuple[int, int]:
        """Contiguous encoded-row range [lo, hi) owned by worker ``i``."""
        r = self.rows_per_worker
        return i * r, (i + 1) * r

    def input_slice(self, i: int) -> slice:
        """The input coordinates worker ``i``'s rows depend on.  Structured
        encoders narrow this (block-diagonal: one shard) so data can be
        streamed in worker-by-worker; dense/FWHT mixing needs everything."""
        return slice(0, self.n)

    def worker_block(self, i: int, X):
        """Worker ``i``'s rows of S X from the FULL data array."""
        return self.worker_block_local(i, X[self.input_slice(i)])

    def encode_partitioned(self, X) -> list:
        """All m worker blocks of S X — the bulk entry the problem builders
        use.  Default builds each block via ``worker_block`` (shard-local
        for structured encoders, so nothing global is redone);
        implementations whose per-block map repeats global work (the
        misaligned FWHT fallback) override with one full-encode pass."""
        m = self._require_workers()
        return [self.worker_block(i, X) for i in range(m)]

    # -- shared small helpers ----------------------------------------------
    @staticmethod
    def _as_2d(X):
        if getattr(X, "ndim", None) == 1:
            return X[:, None], True
        return X, False


@dataclasses.dataclass(frozen=True)
class Encoder(LinearEncoder):
    """A realized (dense) encoding matrix together with its metadata.

    The reference ``LinearEncoder`` implementation: every current
    construction (Gaussian / Hadamard / Haar / Paley / Steiner / replication
    / identity) materializes S and wraps it here.  ``DenseEncoder`` is an
    alias for this class.
    """

    name: str
    S: np.ndarray  # (beta*n, n), float64
    beta: float    # redundancy factor = rows / cols
    tight: bool    # whether S.T S == beta I exactly
    m: int | None = None  # worker partition (set by with_workers)

    @property
    def n(self) -> int:
        return self.S.shape[1]

    @property
    def rows(self) -> int:
        return self.S.shape[0]

    def encode(self, X):
        return self.S @ np.asarray(X)

    def decode_t(self, G):
        return self.S.T @ np.asarray(G)

    def worker_block_local(self, i: int, X_local):
        lo, hi = self.worker_rows(i)
        return self.S[lo:hi] @ np.asarray(X_local)

    def materialize(self) -> np.ndarray:
        return self.S

    def with_workers(self, m: int) -> "Encoder":
        if self.m == m:
            return self
        if self.m is not None:
            raise ValueError(
                f"encoder already partitioned for m={self.m}, asked m={m}")
        pad = (-self.rows) % m
        S = (np.concatenate([self.S, np.zeros((pad, self.n))], axis=0)
             if pad else self.S)
        return Encoder(self.name, S, self.beta, self.tight, m=int(m))


DenseEncoder = Encoder


def as_dense(enc: LinearEncoder) -> Encoder:
    """Dense-matrix view of any operator (equivalence tests, diagnostics)."""
    if isinstance(enc, Encoder):
        return enc
    return Encoder(enc.name, enc.materialize(), enc.beta, enc.tight, m=enc.m)


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix with +-1 entries; n must be a power of two."""
    if n & (n - 1) or n <= 0:
        raise ValueError(f"Hadamard order must be a power of two, got {n}")
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def gaussian_encoder(n: int, beta: float = 2.0, seed: int = 0) -> Encoder:
    """i.i.d. Gaussian ensemble (paper §4.1 'random matrices')."""
    rows = int(round(beta * n))
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((rows, n)) / math.sqrt(n)
    return Encoder("gaussian", S, rows / n, tight=False)


def hadamard_ensemble(n: int, beta: float, seed: int):
    """The randomized-Hadamard draws (N, cols, signs) — the ONE sampling
    used by both the dense ``hadamard_encoder`` and the matrix-free
    ``FastHadamardEncoder``, so the two are the same matrix by
    construction, not by parallel rng bookkeeping."""
    N = _next_pow2(int(round(beta * n)))
    rng = np.random.default_rng(seed)
    cols = rng.choice(N, size=n, replace=False)
    signs = rng.choice([-1.0, 1.0], size=n)
    return N, cols, signs


def hadamard_encoder(n: int, beta: float = 2.0, seed: int = 0) -> Encoder:
    """Column-subsampled (randomized) Hadamard ensemble (paper §4.2.2, FWHT).

    S = H_N[:, cols] * D / sqrt(n), N = next_pow2(beta*n), |cols| = n, D random
    signs.  Equivalent to inserting zero rows into the data then FWHT-ing.
    """
    N, cols, signs = hadamard_ensemble(n, beta, seed)
    H = hadamard_matrix(N)
    S = H[:, cols] * signs[None, :] / math.sqrt(n)
    # S.T S = (N / n) I exactly -> rescale to beta = N/n convention.
    return Encoder("hadamard", S, N / n, tight=True)


def haar_encoder(n: int, beta: float = 2.0, seed: int = 0) -> Encoder:
    """Column-subsampled Haar wavelet matrix (paper §4.2.1, sparse)."""
    N = _next_pow2(int(round(beta * n)))
    # Recursive orthonormal Haar: H_{2k} = 1/sqrt(2) [[H_k (x) [1,1]], [I_k (x) [1,-1]]]
    H = np.array([[1.0]])
    while H.shape[0] < N:
        k = H.shape[0]
        top = np.kron(H, np.array([[1.0, 1.0]]))
        bot = np.kron(np.eye(k), np.array([[1.0, -1.0]]))
        H = np.concatenate([top, bot], axis=0) / math.sqrt(2.0)
    rng = np.random.default_rng(seed)
    cols = rng.choice(N, size=n, replace=False)
    S = H[:, cols] * math.sqrt(N / n)  # make S.T S = (N/n) I
    return Encoder("haar", S, N / n, tight=True)


def _jacobsthal(p: int) -> np.ndarray:
    """Jacobsthal matrix Q_ij = chi(i - j) for prime p (quadratic character)."""
    residues = set((x * x) % p for x in range(1, p))
    chi = np.zeros(p)
    for a in range(1, p):
        chi[a] = 1.0 if a in residues else -1.0
    idx = np.arange(p)
    return chi[(idx[:, None] - idx[None, :]) % p]


def is_prime(x: int) -> bool:
    if x < 2:
        return False
    for d in range(2, int(math.isqrt(x)) + 1):
        if x % d == 0:
            return False
    return True


def paley_etf_encoder(n: int, seed: int = 0) -> Encoder:
    """Real Paley ETF with redundancy beta = 2 (paper §4.1, Paley 1933).

    Needs a prime p with p ≡ 1 (mod 4) and (p+1)/2 >= n; the frame lives in
    R^{(p+1)/2} and has p+1 vectors.  We build the conference-matrix projection
    P = (I + C / sqrt(p)) / 2 (rank (p+1)/2), take an orthonormal column basis
    U of P ((p+1) x (p+1)/2), and subsample n columns.  Rows of sqrt(2) U form
    a unit-norm tight frame; the column-subsampled version stays tight.
    """
    p = 2 * n - 1
    while not (is_prime(p) and p % 4 == 1):
        p += 2
    q = _jacobsthal(p)
    C = np.zeros((p + 1, p + 1))
    C[0, 1:] = 1.0
    C[1:, 0] = 1.0
    C[1:, 1:] = q
    # Symmetric conference matrix: C^T C = p I, diag 0.
    P = (np.eye(p + 1) + C / math.sqrt(p)) / 2.0
    evals, evecs = np.linalg.eigh(P)
    U = evecs[:, evals > 0.5]  # eigenvalue-1 eigenspace, (p+1) x (p+1)/2
    rng = np.random.default_rng(seed)
    cols = rng.choice(U.shape[1], size=n, replace=False)
    # Columns of U are orthonormal, so (sqrt(2) U_cols)^T (sqrt(2) U_cols) = 2I.
    # Rescale to the repo convention S^T S = beta I with beta = rows/n.
    beta = (p + 1) / n
    S = math.sqrt(beta) * U[:, cols]
    return Encoder("paley", S, beta, tight=True)


def steiner_etf_encoder(n: int, v: int | None = None) -> Encoder:
    """Steiner ETF from (2,2,v)-Steiner systems (paper §4.2.1, Fickus et al.).

    S is v^2 x v(v-1)/2 with redundancy beta = 2v/(v-1); each 'block' (v rows
    arising from one row of the incidence matrix V) holds v-1 distinct
    (non-constant) columns of the order-v Hadamard matrix, scaled 1/sqrt(v-1).
    If ``n`` is given, v is chosen so v(v-1)/2 >= n and columns subsampled.
    """
    if v is None:
        v = 4
        while v * (v - 1) // 2 < n:
            v *= 2
    H = hadamard_matrix(v)
    ncols = v * (v - 1) // 2
    pairs = [(a, b) for a in range(v) for b in range(a + 1, v)]
    S = np.zeros((v * v, ncols))
    # ones_in_row[r] enumerates columns whose pair contains r, in order.
    counter = np.zeros(v, dtype=int)
    for j, (a, b) in enumerate(pairs):
        for r in (a, b):
            ell = counter[r]
            counter[r] += 1
            S[r * v:(r + 1) * v, j] = H[:, ell + 1]  # skip all-ones column h_1
    S /= math.sqrt(v - 1)
    if n is not None and n < ncols:
        cols = np.random.default_rng(0).choice(ncols, size=n, replace=False)
        S = S[:, np.sort(cols)]
    # Column subsampling preserves S^T S = beta I with the FRAME constant
    # beta = 2v/(v-1) (column norm^2); storage redundancy rows/n can be larger.
    beta = 2.0 * v / (v - 1.0)
    return Encoder("steiner", S, beta, tight=True)


def replication_encoder(n: int, beta: int = 2) -> Encoder:
    """beta-fold replication: S = [I; I; ...] (baseline, paper §5)."""
    S = np.concatenate([np.eye(n)] * int(beta), axis=0)
    return Encoder("replication", S, float(beta), tight=True)


def identity_encoder(n: int) -> Encoder:
    """Uncoded baseline: S = I."""
    return Encoder("uncoded", np.eye(n), 1.0, tight=True)


_FACTORIES = {
    "gaussian": gaussian_encoder,
    "hadamard": hadamard_encoder,
    "haar": haar_encoder,
    "paley": lambda n, beta=2.0, seed=0: paley_etf_encoder(n, seed),
    "steiner": lambda n, beta=2.0, seed=0: steiner_etf_encoder(n),
    "replication": lambda n, beta=2.0, seed=0: replication_encoder(n, int(beta)),
    "uncoded": lambda n, beta=1.0, seed=0: identity_encoder(n),
    # core.operators registers the matrix-free entries ('fast-hadamard',
    # 'block-diagonal') on import — see register_encoder below.
}


def register_encoder(name: str, factory) -> None:
    """Register an encoder factory ``f(n, beta=..., seed=..., **kw)``."""
    _FACTORIES[name] = factory


def make_encoder(name: str, n: int, beta: float = 2.0, seed: int = 0,
                 **kw) -> LinearEncoder:
    """Build an encoder by registry name.

    Dense constructions return an ``Encoder``; the matrix-free operators
    registered by ``core.operators`` ('fast-hadamard', 'block-diagonal')
    return their ``LinearEncoder`` implementations.  Extra keyword arguments
    are passed to the factory (e.g. ``block_size=`` for 'block-diagonal').
    """
    if name not in _FACTORIES:
        raise KeyError(f"unknown encoder '{name}'; have {sorted(_FACTORIES)}")
    return _FACTORIES[name](n, beta=beta, seed=seed, **kw)


def available_encoders() -> list[str]:
    return sorted(_FACTORIES)


def pad_rows(enc: LinearEncoder, m: int) -> LinearEncoder:
    """Zero-pad with extra rows so m divides the row count, binding the
    worker partition (alias of ``enc.with_workers(m)``).

    Zero rows carry no data (a worker block just has a few dead rows);
    S^T S — and hence tightness/BRIP — is unchanged.
    """
    return enc.with_workers(m)


def partition_rows(enc: LinearEncoder, m: int) -> np.ndarray:
    """Split S row-wise into m contiguous worker blocks, shape (m, rows/m, n).

    Materializes the operator — diagnostics and tests only; production
    consumers use ``worker_block`` and never form S.
    """
    rows = enc.rows
    if rows % m:
        raise ValueError(f"{rows} encoded rows not divisible by m={m}")
    return enc.materialize().reshape(m, rows // m, enc.n)


def subset_spectrum(enc: LinearEncoder, m: int, k: int, trials: int = 50,
                    seed: int = 0) -> np.ndarray:
    """Eigenvalues of (1/(eta*beta)) S_A^T S_A over random k-subsets (Fig 5-6).

    Accepts dense and matrix-free encoders alike (rows auto-padded to m)."""
    if enc.rows % m and enc.m is None:
        enc = enc.with_workers(m)
    blocks = partition_rows(enc, m)
    eta = k / m
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(trials):
        A = rng.choice(m, size=k, replace=False)
        SA = blocks[A].reshape(-1, enc.n)
        G = SA.T @ SA / (eta * enc.beta)
        out.append(np.linalg.eigvalsh(G))
    return np.asarray(out)


def brip_constant(enc: LinearEncoder, m: int, k: int, trials: int = 50,
                  seed: int = 0) -> float:
    """Empirical BRIP epsilon over sampled subsets: max |eig - 1|."""
    ev = subset_spectrum(enc, m, k, trials=trials, seed=seed)
    return float(np.max(np.abs(ev - 1.0)))
