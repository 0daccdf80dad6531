"""Synthetic data for the paper-native problems: least squares (ridge /
LASSO), rcv1-like sparse logistic regression, MovieLens-protocol ratings,
and the worker-by-worker streaming encode (paper §4.2).

Own copy of the reference's generators (``repro/data/pipeline.py``): the
same numpy generators, the same draws, so a dataset equals the
reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["lsq_dataset", "lsq_rows", "logreg_dataset", "logreg_rows",
           "mf_ratings_dataset", "stream_worker_blocks"]


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
