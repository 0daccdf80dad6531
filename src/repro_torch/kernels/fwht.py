"""Fast Walsh-Hadamard transform: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the TPU kernel ``src/repro/kernels/fwht.py`` (``_fwht_body``).  On
a CUDA tensor the wrapper launches ``csrc/fwht.cu`` (one block per row,
the whole row on chip for all log2(n) stages); on a CPU tensor it runs the
plain version, the reshape-and-stack butterfly of the reference.
"""
from __future__ import annotations

import torch

from ._build import check, launches, load_library, stream_of

__all__ = ["fwht_kernel_call", "fwht_plain", "butterfly", "MAX_ONE_PASS"]

# one block holds the whole row in shared memory (128 KB of float32); longer
# transforms need the multi-pass form, which is not ported yet
MAX_ONE_PASS = 32768

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def butterfly(x: torch.Tensor, n: int) -> torch.Tensor:
    """All log2(n) FWHT butterfly stages over the trailing axis of a
    (rows, n) float32 tensor, in the reference's stage order."""
    rows = x.shape[0]
    h = 1
    while h < n:
        y = x.reshape(rows, n // (2 * h), 2, h)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2).reshape(rows, n)
        h *= 2
    return x


def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FWHT of a (rows, n) tensor, computed in float32 and
    returned in x's dtype."""
    return butterfly(x.float(), x.shape[1]).to(x.dtype)


def _check_length(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"FWHT length {n} is not a power of two")


def fwht_kernel_call(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised FWHT along the last axis of x: (rows, n) -> (rows, n).

    n must be a power of two.  CUDA tensors (float32 or bfloat16, contiguous,
    n <= 32768) go through the CUDA kernel; CPU tensors through the plain
    version.
    """
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, n) tensor, got {tuple(x.shape)}")
    rows, n = x.shape
    _check_length(n)
    if x.device.type == "cpu":
        return fwht_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if n > MAX_ONE_PASS:
        raise ValueError(f"FWHT length {n} exceeds the one-pass limit "
                         f"{MAX_ONE_PASS}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"FWHT kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("FWHT kernel needs a contiguous tensor")
    out = torch.empty_like(x)
    if rows:
        check(load_library().repro_fwht(x.data_ptr(), out.data_ptr(), rows,
                                        n, _DTYPES[x.dtype], stream_of(x)),
              "fwht")
        launches["fwht"] += 1
    return out
