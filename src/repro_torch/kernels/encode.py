"""Fused SRHT encode (scatter + sign-flip + FWHT + row window): the CUDA
kernel's wrapper and its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/encode.py`` (``_srht_body``)
and the scatter in front of it (``src/repro/kernels/ops.py``).  For data
columns as rows ``xt = X^T`` (p, n), the encode

    out[c] = FWHT_N(scatter(xt[c] * signs -> slots cols))[lo:hi] * scale

is rows [lo, hi) of S X (transposed) for S = H_N[:, cols] diag(signs) *
scale.  On a CUDA tensor the wrapper launches ``csrc/srht.cu``, which folds
the scatter into its load; on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

import torch

from ._build import check, launches, load_library, stream_of
from .fwht import MAX_ONE_PASS, butterfly

__all__ = ["srht_encode_call", "srht_encode_plain"]


def srht_encode_plain(xt: torch.Tensor, cols: torch.Tensor,
                      signs: torch.Tensor, *, N: int, lo: int, hi: int,
                      scale: float) -> torch.Tensor:
    """Plain PyTorch SRHT encode: explicit zero-padded scatter, then the
    reference butterfly, window and scale.  Returns (p, hi - lo)."""
    p = xt.shape[0]
    buf = torch.zeros((p, N), dtype=torch.float32, device=xt.device)
    buf[:, cols.long()] = xt.float() * signs.float()
    return (butterfly(buf, N)[:, lo:hi] * scale).to(xt.dtype)


def srht_encode_call(xt: torch.Tensor, cols: torch.Tensor,
                     signs: torch.Tensor, *, N: int, lo: int, hi: int,
                     scale: float) -> torch.Tensor:
    """Rows [lo, hi) of the SRHT encode of ``xt`` (p, n), transposed:
    returns (p, hi - lo).

    cols: (n,) distinct transform slots in [0, N) (int32 on the card);
    signs: (n,) float32 random signs; N a power of two.
    """
    if xt.dim() != 2 or cols.dim() != 1 or signs.dim() != 1:
        raise ValueError("expected xt (p, n), cols (n,), signs (n,)")
    p, n = xt.shape
    if cols.shape[0] != n or signs.shape[0] != n:
        raise ValueError(f"cols/signs length {cols.shape[0]}/"
                         f"{signs.shape[0]} != data length {n}")
    if N < 1 or N & (N - 1):
        raise ValueError(f"transform length {N} is not a power of two")
    if n > N:
        raise ValueError(f"data length {n} exceeds transform length {N}")
    if not (0 <= lo < hi <= N):
        raise ValueError(f"row window [{lo}, {hi}) outside [0, {N})")
    if xt.device.type == "cpu":
        return srht_encode_plain(xt, cols, signs, N=N, lo=lo, hi=hi,
                                 scale=scale)
    if xt.device.type != "cuda":
        raise ValueError(f"unsupported device {xt.device}")
    if N > MAX_ONE_PASS:
        raise ValueError(f"transform length {N} exceeds the one-pass limit "
                         f"{MAX_ONE_PASS}")
    if xt.dtype != torch.float32 or signs.dtype != torch.float32:
        raise TypeError("SRHT kernel takes float32 data and signs")
    if cols.dtype != torch.int32:
        raise TypeError("SRHT kernel takes int32 cols")
    for name, t in (("cols", cols), ("signs", signs)):
        if t.device != xt.device:
            raise ValueError(f"{name} on {t.device}, data on {xt.device}")
    if not (xt.is_contiguous() and cols.is_contiguous()
            and signs.is_contiguous()):
        raise ValueError("SRHT kernel needs contiguous tensors")
    out = torch.empty((p, hi - lo), dtype=xt.dtype, device=xt.device)
    if p:
        check(load_library().repro_srht_encode(
            xt.data_ptr(), cols.data_ptr(), signs.data_ptr(), out.data_ptr(),
            p, n, N, lo, hi, float(scale), stream_of(xt)), "srht_encode")
        launches["srht_encode"] += 1
    return out
