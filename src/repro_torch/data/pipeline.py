"""Synthetic data: LM token batches laid out for coded data parallelism
(the synthetic Zipf + motif token stream, the FRC ``CodedBatcher`` and the
any-code ``GroupBatcher``), and for the paper-native problems least squares
(ridge / LASSO), rcv1-like sparse logistic regression, MovieLens-protocol
ratings and the worker-by-worker streaming encode (paper §4.2).

Own copy of the reference's generators (``repro/data/pipeline.py``): the
same numpy generators, the same draws, so every batch and dataset equals
the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gradient_coding import (FRCode, GradientCode,
                                              coded_weights)

__all__ = ["TokenStream", "CodedBatcher", "GroupBatcher", "lsq_dataset",
           "lsq_rows", "logreg_dataset", "logreg_rows", "mf_ratings_dataset",
           "stream_worker_blocks"]


@dataclasses.dataclass
class TokenStream:
    """Zipf + motif synthetic token stream (deterministic per seed)."""
    vocab: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._motifs = rng.integers(0, self.vocab,
                                    (self.n_motifs, self.motif_len))

    def sample(self, rng: np.random.Generator, n: int, seq: int) -> np.ndarray:
        toks = rng.choice(self.vocab, size=(n, seq + 1), p=self._probs)
        # Insert learnable motifs with 50% probability per sequence —
        # vectorized (one fancy-indexed write for the whole batch; the
        # per-sequence Python loop dominated CodedBatcher hot paths).
        L = min(self.motif_len, seq + 1)
        insert = rng.random(n) < 0.5
        motif_ids = rng.integers(0, self.n_motifs, size=n)
        starts = rng.integers(0, seq + 2 - L, size=n)
        rows = np.nonzero(insert)[0]
        if rows.size:
            cols = starts[rows, None] + np.arange(L)[None, :]
            toks[rows[:, None], cols] = self._motifs[motif_ids[rows], :L]
        return toks.astype(np.int32)


@dataclasses.dataclass
class CodedBatcher:
    """Yields (tokens, labels, weights) with FRC-coded worker layout.

    tokens: (m * rows, seq) — worker i owns rows [i*rows, (i+1)*rows);
    replicas of a cluster carry identical rows.  weights: (m * rows,) decode
    weights (uniform 1 when mask is all-ones).
    """
    stream: TokenStream
    code: FRCode
    rows_per_worker: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def next_batch(self, mask: np.ndarray):
        b = self.code.num_clusters
        cluster_data = self.stream.sample(
            self._rng, b * self.rows_per_worker, self.seq_len)
        cluster_data = cluster_data.reshape(b, self.rows_per_worker, -1)
        per_worker = cluster_data[self.code.clusters]     # (m, rows, seq+1)
        toks = per_worker.reshape(-1, self.seq_len + 1)
        w = np.asarray(coded_weights(self.code, mask))    # (m,)
        weights = np.repeat(w, self.rows_per_worker).astype(np.float32)
        return toks[:, :-1], toks[:, 1:], weights


@dataclasses.dataclass
class GroupBatcher:
    """Group-major batches for ANY :class:`GradientCode` (DESIGN §15).

    Where :class:`CodedBatcher` bakes in the FRC replica layout and folds
    decode weights into per-sample loss weights, ``GroupBatcher`` keeps the
    two stages of the coded train step separate: it draws the
    ``num_groups * rows`` data rows ONCE per step and lays them out
    worker-major by the code's assignment —

      tokens/labels: (m, slots * rows, seq)  where worker i's slots are its
        ``worker_groups[i]`` (replicas/overlaps share bit-identical rows);
      coeff: (m, slots * rows) float32 combine coefficients
        (``worker_coeffs`` repeated over rows) — the B[i, j] each worker
        applies LOCALLY before the decode-weighted combine.

    Decode weights are NOT applied here: the trainer gets them from
    ``code.decode_weights(mask)`` per step so the same batch serves any
    erasure pattern.  Stochastic codes pass their per-step re-draw via the
    ``code=`` override; the data draw count is identical either way, so
    trajectories across codes with equal (num_groups, rows) consume the
    same token stream.
    """
    stream: TokenStream
    code: GradientCode
    rows_per_worker: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def next_batch(self, code: GradientCode | None = None):
        code = self.code if code is None else code
        b, rows = code.num_groups, self.rows_per_worker
        data = self.stream.sample(self._rng, b * rows, self.seq_len)
        data = data.reshape(b, rows, -1)
        per_worker = data[code.worker_groups]      # (m, slots, rows, seq+1)
        m = per_worker.shape[0]
        per_worker = per_worker.reshape(m, -1, self.seq_len + 1)
        coeff = np.repeat(np.asarray(code.worker_coeffs, np.float32),
                          rows, axis=1)            # (m, slots * rows)
        return (per_worker[..., :-1], per_worker[..., 1:], coeff)


def lsq_dataset(n: int, p: int, *, noise: float = 0.1, sparse: int = 0,
                seed: int = 0):
    """Least-squares data for the paper-native problems (ridge / LASSO)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    if sparse:
        w = np.zeros(p)
        idx = rng.choice(p, size=sparse, replace=False)
        w[idx] = rng.standard_normal(sparse) * 2.0
    else:
        w = rng.standard_normal(p)
    y = X @ w + noise * rng.standard_normal(n)
    return X, y, w


_LSQ_CHUNK = 4096  # virtual-dataset chunk size; any row range assembles from
                   # whole chunks, so generation is deterministic per (seed,
                   # chunk) regardless of access order or range boundaries.


def lsq_rows(lo: int, hi: int, p: int, *, noise: float = 0.1,
             sparse: int = 0, seed: int = 0):
    """Rows [lo, hi) of a VIRTUAL least-squares dataset, in O(hi - lo) memory.

    Every ``_LSQ_CHUNK``-row chunk gets its own counter-keyed generator, so
    any shard of an arbitrarily large dataset can be produced independently.
    Returns (X_rows, y_rows, w) with the SAME ground-truth w for every call.
    """
    rng_w = np.random.default_rng([seed, 0])
    if sparse:
        w = np.zeros(p)
        idx = rng_w.choice(p, size=sparse, replace=False)
        w[idx] = rng_w.standard_normal(sparse) * 2.0
    else:
        w = rng_w.standard_normal(p)
    xs, ys = [], []
    for c in range(lo // _LSQ_CHUNK, -(-hi // _LSQ_CHUNK) if hi > lo else 0):
        rng = np.random.default_rng([seed, 1 + c])
        Xc = rng.standard_normal((_LSQ_CHUNK, p))
        yc = Xc @ w + noise * rng.standard_normal(_LSQ_CHUNK)
        a = max(lo - c * _LSQ_CHUNK, 0)
        b = min(hi - c * _LSQ_CHUNK, _LSQ_CHUNK)
        xs.append(Xc[a:b])
        ys.append(yc[a:b])
    if not xs:
        return np.zeros((0, p)), np.zeros(0), w
    return np.concatenate(xs), np.concatenate(ys), w


def logreg_rows(lo: int, hi: int, p: int, *, density: float = 0.1,
                noise: float = 0.1, seed: int = 0):
    """Rows [lo, hi) of a VIRTUAL rcv1-like sparse logistic dataset.

    Same chunk-deterministic convention as ``lsq_rows``: every
    ``_LSQ_CHUNK``-row chunk gets its own counter-keyed generator, so any
    shard can be produced independently of access order.  Features are
    sparse-exponential (density ``density``), row-normalized to unit norm;
    labels are ``sign(X w + noise * eps)`` in {-1, +1} for a fixed
    ground-truth ``w``.  Returns (X_rows, labels_rows, w).
    """
    rng_w = np.random.default_rng([seed, 0])
    w = rng_w.standard_normal(p)
    xs, ls = [], []
    for c in range(lo // _LSQ_CHUNK, -(-hi // _LSQ_CHUNK) if hi > lo else 0):
        rng = np.random.default_rng([seed, 1 + c])
        Xc = ((rng.random((_LSQ_CHUNK, p)) < density)
              * rng.exponential(1.0, (_LSQ_CHUNK, p)))
        Xc = Xc / np.maximum(np.linalg.norm(Xc, axis=1, keepdims=True), 1e-9)
        lc = np.sign(Xc @ w + noise * rng.standard_normal(_LSQ_CHUNK))
        lc[lc == 0] = 1.0
        a = max(lo - c * _LSQ_CHUNK, 0)
        b = min(hi - c * _LSQ_CHUNK, _LSQ_CHUNK)
        xs.append(Xc[a:b])
        ls.append(lc[a:b])
    if not xs:
        return np.zeros((0, p)), np.zeros(0), w
    return np.concatenate(xs), np.concatenate(ls), w


def logreg_dataset(n: int, p: int, *, density: float = 0.1,
                   noise: float = 0.1, seed: int = 0):
    """Sparse logistic-regression data (rcv1-like) for the paper's §5.3
    workload; thin whole-dataset wrapper over ``logreg_rows``."""
    return logreg_rows(0, n, p, density=density, noise=noise, seed=seed)


_MF_USER_CHUNK = 512  # user-chunk size for deterministic ratings generation


def mf_ratings_dataset(users: int, movies: int, *, rank: int = 4,
                       density: float = 0.08, train_frac: float = 0.8,
                       noise: float = 0.3, seed: int = 0):
    """MovieLens-protocol synthetic ratings (paper §5.2, Tables 2-3).

    Low-rank + user/movie bias + noise, rounded to half-stars and clipped to
    [1, 5]; ~``density`` of entries observed, split ``train_frac``/rest.
    Movie factors come from one counter-keyed stream and every
    ``_MF_USER_CHUNK`` block of users from its own — the same
    chunk-deterministic convention as ``lsq_rows``, so a prefix of users is
    stable under growth of ``users``.  Returns (R, train_mask, test_mask).
    """
    rng_v = np.random.default_rng([seed, 0])
    V = rng_v.standard_normal((movies, rank)) * 0.5
    bv = rng_v.standard_normal(movies) * 0.3
    R = np.zeros((users, movies))
    obs = np.zeros((users, movies), dtype=bool)
    train = np.zeros((users, movies), dtype=bool)
    for c in range(-(-users // _MF_USER_CHUNK)):
        rng = np.random.default_rng([seed, 1 + c])
        rows = min(users - c * _MF_USER_CHUNK, _MF_USER_CHUNK)
        U = rng.standard_normal((_MF_USER_CHUNK, rank))[:rows] * 0.5
        bu = rng.standard_normal(_MF_USER_CHUNK)[:rows] * 0.3
        Rc = (3.0 + U @ V.T + bu[:, None] + bv[None, :]
              + noise * rng.standard_normal((_MF_USER_CHUNK, movies))[:rows])
        sl = slice(c * _MF_USER_CHUNK, c * _MF_USER_CHUNK + rows)
        R[sl] = np.clip(np.round(Rc * 2) / 2, 1.0, 5.0)
        obs[sl] = rng.random((_MF_USER_CHUNK, movies))[:rows] < density
        train[sl] = obs[sl] & (
            rng.random((_MF_USER_CHUNK, movies))[:rows] < train_frac)
    return R, train, obs & ~train


def stream_worker_blocks(enc, m: int, rows_fn):
    """Encode worker-by-worker without ever holding the full dataset.

    ``enc`` is any ``LinearEncoder``; ``rows_fn(lo, hi)`` returns the raw
    data rows [lo, hi) as an ``(hi - lo, q)`` array.  For each worker the
    generator materializes ONLY the input coordinates that worker's encoded
    rows depend on (``enc.input_slice``) and yields ``(i, S_i X)`` as a
    host array.  With a block-diagonal encoder each worker touches one
    shard, so peak memory is one shard + one encoded block — data whose
    dense encoding matrix (or even X itself) exceeds host memory streams
    through.  Mixing encoders (dense, fast-hadamard) declare a full-width
    input slice and degrade to whole-dataset pulls; the fast-Hadamard
    encoder computes its block on its device (SRHT / FWHT kernels on the
    card) and the block is copied back.
    """
    enc = enc.with_workers(m)
    for i in range(m):
        sl = enc.input_slice(i)
        block = enc.worker_block_local(i, rows_fn(sl.start, sl.stop))
        if isinstance(block, torch.Tensor):
            block = block.detach().cpu().numpy()
        yield i, np.asarray(block)
