"""Fused SRHT encode (scatter + sign-flip + FWHT + row window): the CUDA
kernel's wrapper and its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/encode.py`` (``_srht_body``)
and the scatter in front of it (``src/repro/kernels/ops.py``).  For data
columns as rows ``xt = X^T`` (p, n), the encode

    out[c] = FWHT_N(scatter(xt[c] * signs -> slots cols))[lo:hi] * scale

is rows [lo, hi) of S X (transposed) for S = H_N[:, cols] diag(signs) *
scale.  On a CUDA tensor the wrapper launches ``csrc/srht.cu``, which folds
the scatter into its load: in one pass up to N = 32768, and past it in the
passes of ``fwht_passes(N)`` (the first gathers through ``srht_slot_map``,
the last scales and windows); on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

import torch

from ._build import check, launches, load_library, stream_of
from .fwht import MAX_ONE_PASS, butterfly, fwht_passes, strided_pass

__all__ = ["srht_encode_call", "srht_encode_plain", "srht_slot_map",
           "srht_chunk_rows", "CHUNK_BYTES"]

# the most a partial window's float32 intermediate may take beside the
# output: it holds this many bytes of whole N-slot frames at a time
CHUNK_BYTES = 1 << 30


def srht_encode_plain(xt: torch.Tensor, cols: torch.Tensor,
                      signs: torch.Tensor, *, N: int, lo: int, hi: int,
                      scale: float) -> torch.Tensor:
    """Plain PyTorch SRHT encode: explicit zero-padded scatter, then the
    reference butterfly, window and scale.  Returns (p, hi - lo)."""
    p = xt.shape[0]
    buf = torch.zeros((p, N), dtype=torch.float32, device=xt.device)
    buf[:, cols.long()] = xt.float() * signs.float()
    return (butterfly(buf, N)[:, lo:hi] * scale).to(xt.dtype)


def srht_slot_map(cols: torch.Tensor, N: int) -> torch.Tensor:
    """The data index of each of the N transform slots, int32, -1 for an
    empty slot: ``map[cols[j]] = j``.  Built on cols' device; the
    multi-pass kernel's first pass gathers through it."""
    out = torch.full((N,), -1, dtype=torch.int32, device=cols.device)
    out[cols.long()] = torch.arange(cols.shape[0], dtype=torch.int32,
                                    device=cols.device)
    return out


def srht_chunk_rows(p: int, N: int) -> int:
    """Data columns a partial window's multi-pass encode takes at a time:
    as many N-slot float32 frames as fit CHUNK_BYTES (at least one)."""
    return max(1, min(p, CHUNK_BYTES // (N * 4)))


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
    if p and N <= MAX_ONE_PASS:
        check(load_library().repro_srht_encode(
            xt.data_ptr(), cols.data_ptr(), signs.data_ptr(), out.data_ptr(),
            p, n, N, lo, hi, float(scale), stream_of(xt)), "srht_encode")
        launches["srht_encode"] += 1
    elif p:
        _multi_pass(xt, srht_slot_map(cols, N), signs, out, N=N, lo=lo,
                    hi=hi, scale=scale)
        launches["srht_encode"] += 1
    return out


def _multi_pass(xt, slot_map, signs, out, *, N, lo, hi, scale) -> None:
    """The encode past one pass: pass 1 gathers each 32768-slot segment
    through the slot map and transforms it, the strided passes finish the
    transform, and the last scales and windows into out.  The full window
    runs in place on out; a partial one through a float32 frame of
    ``srht_chunk_rows`` data columns at a time."""
    lib = load_library()
    p, n = xt.shape
    (seg, _), *later = fwht_passes(N)
    full = lo == 0 and hi == N
    rows = p if full else srht_chunk_rows(p, N)
    work = out if full else torch.empty((rows, N), dtype=torch.float32,
                                        device=xt.device)
    for c0 in range(0, p, rows):
        c1 = min(p, c0 + rows)
        w = work[:c1 - c0]
        check(lib.repro_srht_segments(
            xt[c0:c1].data_ptr(), slot_map.data_ptr(), signs.data_ptr(),
            w.data_ptr(), c1 - c0, n, N, seg, stream_of(xt)), "srht_encode")
        for j, (L, S) in enumerate(later):
            last = j == len(later) - 1
            strided_pass(lib, w, out[c0:c1] if last else w, N, L, S,
                         lo if last else 0, hi if last else N,
                         scale if last else 1.0)
