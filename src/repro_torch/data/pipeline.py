"""Least-squares data for the paper-native problems (ridge / LASSO).

Own copy of the reference's ``lsq_dataset`` and ``lsq_rows``
(``repro/data/pipeline.py``): the same numpy generators, the same draws.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lsq_dataset", "lsq_rows"]


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
