"""Public wrappers around the kernels (counterpart of
``src/repro/kernels/ops.py``).

Each call goes to the CUDA kernel for tensors on the card and to the
kernel's plain PyTorch version for tensors on the CPU.  The TPU path's
row padding of the data-column axis (a whole number of Pallas row blocks)
has no counterpart: the CUDA kernels run one block per row.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .coded_reduce import coded_combine_call
from .encode import srht_encode_call, srht_operands
from .fused_step import fused_masked_gradient
from .fwht import fwht_kernel_call

__all__ = ["fwht", "srht_encode", "hadamard_encode", "fused_masked_gradient",
           "coded_combine"]


def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along ``axis`` (power-of-two length)."""
    x = torch.movedim(x, axis, -1)
    lead, n = x.shape[:-1], x.shape[-1]
    out = fwht_kernel_call(x.reshape(math.prod(lead), n).contiguous())
    return torch.movedim(out.reshape(lead + (n,)), -1, axis)


def srht_encode(X: torch.Tensor, cols: np.ndarray, signs: np.ndarray, N: int,
                lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """Rows [lo, hi) of  S X = H_N[:, cols] diag(signs) X / sqrt(n)  for data
    X (n, p) — the matrix-free SRHT encode (paper §4.2.2).  Returns
    (hi - lo, p), a transposed view of the kernel's (p, hi - lo) output;
    S is never formed."""
    n, p = X.shape
    hi = N if hi is None else hi
    cols = np.asarray(cols)
    if cols.shape != (n,) or cols.min(initial=0) < 0 or \
            cols.max(initial=0) >= N or np.unique(cols).size != n:
        raise ValueError(f"cols must be {n} distinct slots in [0, {N})")
    cols_t, signs_t, smap = srht_operands(cols, signs, N, X.device)
    out = srht_encode_call(X.t().contiguous(), cols_t, signs_t, N=N, lo=lo,
                           hi=hi, scale=1.0 / math.sqrt(n), smap=smap)
    return out.t()


def hadamard_encode(X: torch.Tensor, cols: np.ndarray, signs: np.ndarray,
                    N: int | None = None) -> torch.Tensor:
    """Encode data X (n, p) with the randomized Hadamard ensemble:

        S X = H_N[:, cols] diag(signs) X / sqrt(n)

    via the fused scatter + sign-flip + FWHT + window kernel.  Returns
    (N, p)."""
    n, p = X.shape
    N = N or 1 << (2 * n - 1).bit_length()  # default beta ~= 2 padding
    return srht_encode(X, cols, signs, N)


# Fused coded gradient combine: sum_i c_i g_i for (m, P) gradients and (m,)
# or (m, 1) weights, summed in float32, in g's dtype.  The kernel's own
# wrapper needs no layout work around it, so the op is that wrapper.
coded_combine = coded_combine_call
