"""Matrix-free encoders: fast Hadamard and block-diagonal ETF (paper §4.2.2).

Port of ``src/repro/core/operators.py``.  Both implement the
``LinearEncoder`` protocol without forming the ``(beta*n, n)`` matrix:

* ``FastHadamardEncoder`` — S = H_N[:, cols] diag(signs) / sqrt(n).  Encode
  is one pass of the SRHT kernel (scatter + sign-flip + FWHT + row window,
  ``kernels/encode.py``); ``decode_t`` and the aligned ``worker_block`` run
  the FWHT kernel.  Works on torch tensors: numpy inputs are moved to the
  encoder's device (CUDA unless ``device="cpu"``), tensor inputs stay where
  they are.  Same column/sign sampling as the dense ``hadamard_encoder``,
  so ``materialize()`` reproduces it exactly.
* ``BlockDiagonalEncoder`` — a small base ETF S_b tiled block-diagonally,
  S = I_B (x) S_b, in host numpy (its per-tile einsum has no TPU kernel).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device

from .encoding import (LinearEncoder, hadamard_ensemble, hadamard_matrix,
                       make_encoder, register_encoder)

__all__ = ["FastHadamardEncoder", "BlockDiagonalEncoder"]


def _hadamard_row(i: int, m: int) -> np.ndarray:
    """Row i of the order-m Sylvester Hadamard matrix: H[i, j] =
    (-1)^popcount(i & j).  O(m) — never forms H."""
    return np.array([1.0 - 2.0 * (bin(i & j).count("1") & 1)
                     for j in range(m)])


class FastHadamardEncoder(LinearEncoder):
    """SRHT-style randomized Hadamard encoder, computed by FWHT.

    Identical ensemble to ``hadamard_encoder`` (same rng draws for the
    column subset and signs), but the matrix is implicit: ``encode`` runs
    the SRHT kernel, ``decode_t`` uses H^T = H, and aligned
    ``worker_block`` calls use the Kronecker split
    H_N = H_m (x) H_r  (N = m * r, all powers of two): worker i's block is
    FWHT_r over a signed sum of the m input chunks.
    """

    name = "fast-hadamard"
    tight = True

    def __init__(self, n: int, beta: float = 2.0, seed: int = 0, *,
                 device=None):
        self._n = int(n)
        self.N, self.cols, self.signs = hadamard_ensemble(n, beta, seed)
        self.beta = self.N / n
        self.seed = seed
        self.device = device

    @property
    def n(self) -> int:
        return self._n

    @property
    def rows(self) -> int:
        return self.N + self._pad

    # -- helpers ------------------------------------------------------------
    def _tensor(self, X) -> torch.Tensor:
        """float32 tensor of X: tensors stay on their device, host arrays
        go to the encoder's device."""
        if isinstance(X, torch.Tensor):
            return X.float()
        return torch.as_tensor(np.asarray(X), dtype=torch.float32,
                               device=resolve_device(self.device))

    def _signs(self, device) -> torch.Tensor:
        return torch.as_tensor(self.signs, dtype=torch.float32, device=device)

    def _scatter_signed(self, X2: torch.Tensor) -> torch.Tensor:
        """(N, q) transform input: sign-flipped data at its padded slots."""
        out = torch.zeros((self.N, X2.shape[1]), dtype=torch.float32,
                          device=X2.device)
        out[torch.as_tensor(self.cols, device=X2.device)] = (
            X2 * self._signs(X2.device)[:, None])
        return out

    def _append_pad(self, out2: torch.Tensor) -> torch.Tensor:
        if self._pad:
            out2 = torch.cat([out2, out2.new_zeros((self._pad,
                                                    out2.shape[1]))])
        return out2

    # -- LinearEncoder protocol ---------------------------------------------
    def encode(self, X):
        from repro_torch.kernels.ops import srht_encode
        X2, squeeze = self._as_2d(self._tensor(X))
        out = self._append_pad(srht_encode(X2, self.cols, self.signs, self.N))
        return out[:, 0] if squeeze else out

    def decode_t(self, G):
        from repro_torch.kernels.ops import fwht
        G2, squeeze = self._as_2d(self._tensor(G))
        HG = fwht(G2[:self.N], axis=0)               # pad rows of S are zero
        cols = torch.as_tensor(self.cols, device=HG.device)
        out = HG[cols] * self._signs(HG.device)[:, None] / math.sqrt(self.n)
        return out[:, 0] if squeeze else out

    def worker_block_local(self, i: int, X_local):
        from repro_torch.kernels.ops import fwht, srht_encode
        m = self._require_workers()
        X2, squeeze = self._as_2d(self._tensor(X_local))
        lo, hi = self.worker_rows(i)
        live_hi = min(hi, self.N)                     # rows >= N are padding
        if lo >= self.N:
            out = X2.new_zeros((hi - lo, X2.shape[1]))
            return out[:, 0] if squeeze else out
        if self._pad == 0 and (m & (m - 1)) == 0 and m <= self.N:
            # Kronecker split: rows [i*r, (i+1)*r) of H_N x equal
            # H_r @ sum_j H_m[i, j] x_chunk_j  for x reshaped (m, r, q).
            r = self.N // m
            chunks = self._scatter_signed(X2).reshape(m, r, X2.shape[1])
            hrow = torch.as_tensor(_hadamard_row(i, m), dtype=torch.float32,
                                   device=X2.device)
            combined = torch.tensordot(hrow, chunks, dims=1)   # (r, q)
            out = fwht(combined, axis=0) / math.sqrt(self.n)
        else:
            out = srht_encode(X2, self.cols, self.signs, self.N, lo=lo,
                              hi=live_hi)
            if hi > live_hi:
                out = torch.cat([out, out.new_zeros((hi - live_hi,
                                                     out.shape[1]))])
        return out[:, 0] if squeeze else out

    def encode_partitioned(self, X) -> list:
        """One fused full transform, sliced into worker blocks (views of one
        (rows, q) result): the bulk build costs one SRHT pass instead of m
        per-block transforms."""
        m = self._require_workers()
        out = self.encode(X)                 # pad rows already appended
        r = self.rows_per_worker
        return [out[i * r:(i + 1) * r] for i in range(m)]

    def materialize(self) -> np.ndarray:
        S = (hadamard_matrix(self.N)[:, self.cols] * self.signs[None, :]
             / math.sqrt(self.n))
        if self._pad:
            S = np.concatenate([S, np.zeros((self._pad, self.n))], axis=0)
        return S


class BlockDiagonalEncoder(LinearEncoder):
    """Block-diagonal composition of a small base frame: S = I_B (x) S_b.

    ``block_size`` picks the base dimension n_b (must divide n; default the
    largest power-of-two divisor capped at 64); ``base`` names any dense
    construction in the registry.  Worker i's rows depend only on the input
    shards of the tiles it overlaps (``input_slice``).
    """

    name = "block-diagonal"

    def __init__(self, n: int, beta: float = 2.0, seed: int = 0, *,
                 base: str = "hadamard", block_size: int | None = None):
        nb = block_size or self._default_block(n)
        if n % nb:
            raise ValueError(f"block_size {nb} does not divide n={n}")
        self.base = make_encoder(base, nb, beta=beta, seed=seed)
        if not isinstance(self.base.S, np.ndarray):  # pragma: no cover
            raise TypeError("base encoder must be dense")
        self._n = int(n)
        self.B = n // nb
        self.beta = self.base.beta
        self.tight = self.base.tight
        self.seed = seed

    @staticmethod
    def _default_block(n: int) -> int:
        for cand in (64, 32, 16, 8, 4, 2):
            if n % cand == 0:
                return cand
        return n  # odd n: degenerate single tile

    @property
    def n(self) -> int:
        return self._n

    @property
    def base_rows(self) -> int:
        return self.base.rows

    @property
    def rows(self) -> int:
        return self.B * self.base.rows + self._pad

    # -- LinearEncoder protocol ---------------------------------------------
    def _tile_encode(self, X2, Sb) -> np.ndarray:
        """Apply one (rb, nb) map per tile of X2 ((B', nb, q) flattened)."""
        nb, q = Sb.shape[1], X2.shape[1]
        shards = np.asarray(X2).reshape(-1, nb, q)
        return np.einsum("rk,bkq->brq", Sb, shards).reshape(-1, q)

    def encode(self, X):
        X2, squeeze = self._as_2d(X)
        out = self._tile_encode(X2, self.base.S)
        if self._pad:
            out = np.concatenate(
                [out, np.zeros((self._pad, out.shape[1]), out.dtype)])
        return out[:, 0] if squeeze else out

    def decode_t(self, G):
        G2, squeeze = self._as_2d(G)
        G2 = np.asarray(G2)[:self.B * self.base.rows]
        rb, q = self.base.rows, G2.shape[1]
        tiles = G2.reshape(self.B, rb, q)
        out = np.einsum("rk,brq->bkq", self.base.S, tiles).reshape(-1, q)
        return out[:, 0] if squeeze else out

    def _tile_range(self, i: int) -> tuple[int, int, int, int]:
        """(lo, hi, j0, j1): worker row window and overlapped tile range."""
        lo, hi = self.worker_rows(i)
        rb, live = self.base.rows, self.B * self.base.rows
        j0 = min(lo // rb, self.B)
        j1 = min(-(-min(hi, live) // rb), self.B)
        return lo, hi, j0, j1

    def input_slice(self, i: int) -> slice:
        _, _, j0, j1 = self._tile_range(i)
        nb = self.base.n
        return slice(j0 * nb, j1 * nb)

    def worker_block_local(self, i: int, X_local):
        X2, squeeze = self._as_2d(X_local)
        lo, hi, j0, j1 = self._tile_range(i)
        rb = self.base.rows
        if j1 <= j0:                                  # pure padding rows
            out = np.zeros((hi - lo, X2.shape[1]))
        else:
            enc = self._tile_encode(X2, self.base.S)  # tiles j0..j1
            out = enc[lo - j0 * rb: hi - j0 * rb]
            if out.shape[0] < hi - lo:                # trailing pad rows
                out = np.concatenate(
                    [out, np.zeros((hi - lo - out.shape[0], out.shape[1]))])
        return out[:, 0] if squeeze else out

    def materialize(self) -> np.ndarray:
        S = np.kron(np.eye(self.B), self.base.S)
        if self._pad:
            S = np.concatenate([S, np.zeros((self._pad, self.n))], axis=0)
        return S


register_encoder(
    "fast-hadamard",
    lambda n, beta=2.0, seed=0, **kw: FastHadamardEncoder(n, beta=beta,
                                                          seed=seed, **kw))
register_encoder(
    "block-diagonal",
    lambda n, beta=2.0, seed=0, **kw: BlockDiagonalEncoder(n, beta=beta,
                                                           seed=seed, **kw))
