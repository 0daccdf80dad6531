"""Fused SRHT encode (scatter + sign-flip + FWHT + row window): the CUDA
kernel's wrapper and its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/encode.py`` (``_srht_body``)
and the scatter in front of it (``src/repro/kernels/ops.py``).  For data
columns as rows ``xt = X^T`` (p, n), the encode

    out[c] = FWHT_N(scatter(xt[c] * signs -> slots cols))[lo:hi] * scale

is rows [lo, hi) of S X (transposed) for S = H_N[:, cols] diag(signs) *
scale.  On a CUDA tensor the wrapper launches ``csrc/srht.cu`` along the
route of ``srht_plan``, each of which folds the scatter into its load:

* ``pruned`` - a window inside an aligned block of r' <= 32768 rows below
  N: the N / r' chunks of the signed column, gathered through the signed
  slot map, summed with the signs of H_{N/r'}'s row b, then an r'-point
  transform (one block a column);
* ``one-pass`` - N <= 8192: persistent blocks, each column staged by a
  bulk copy (TMA) while the previous one is transformed, its slots
  gathered through the signed slot map;
* ``cluster`` - N up to 2^18: a column across the shared memory of a
  thread-block cluster (``fwht.cluster_split``), scattered into it
  through distributed shared memory;
* ``passes`` - past that, the passes of ``fwht_passes(N)`` (the first
  gathers through the signed slot map, the last scales and windows).

The one-pass, pruned and passes routes gather through the signed slot map
of ``srht_signed_slot_map``: a caller that encodes with fixed (cols,
signs) builds it once and passes it in, so a call is one launch.  The
signs must be +-1: the map's builder raises on any other value, and a
call without a map builds one, on the CPU too.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ._build import launch, launches, load_library
from .fwht import (MAX_CLUSTER, MAX_ONE_PASS, Plan, butterfly, cluster_split,
                   fwht_passes, strided_pass)

__all__ = ["srht_encode_call", "srht_encode_plain", "srht_signed_slot_map",
           "srht_operands", "srht_plan", "srht_window_block",
           "srht_chunk_rows", "CHUNK_BYTES", "MAX_ONE_PASS_SRHT",
           "MIN_PRUNED"]

# the one-pass route's longest transform: a thread's 16 slots and their
# map entries stay in registers at 512 threads
MAX_ONE_PASS_SRHT = 8192
# the pruned route transforms at least this many points (one per thread of
# its 512-thread block); a smaller aligned block is widened to it
MIN_PRUNED = 512

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


def srht_signed_slot_map(cols: torch.Tensor, signs: torch.Tensor,
                         N: int) -> torch.Tensor:
    """The signed slot map through which the one-pass, pruned and passes
    routes gather (``csrc/srht.cu``), on cols' device: int32 (N,),
    ``(j << 1) | (signs[j] < 0)`` at slot ``cols[j]``, -1 at an empty slot.

    Raises ValueError unless cols lie in [0, N) and every sign is +-1 (the
    kernels keep only a sign's sign bit).  On a CUDA tensor the check reads
    one flag back from the card: build the map once where (cols, signs)
    are fixed, not once a call."""
    bad = ((signs != 1) & (signs != -1)).any() | (cols < 0).any() | \
        (cols >= N).any()
    if bool(bad):
        raise ValueError(f"SRHT needs slots in [0, {N}) and signs of +-1")
    out = torch.full((N,), -1, dtype=torch.int32, device=cols.device)
    out[cols.long()] = ((torch.arange(cols.shape[0], dtype=torch.int32,
                                      device=cols.device) << 1)
                        | (signs < 0).to(torch.int32))
    return out


def srht_operands(cols, signs, N: int, device) -> tuple[torch.Tensor, ...]:
    """(cols int32, signs float32, signed slot map) of host arrays on
    ``device``: the map built and the signs checked on the host, so the
    card gets three copies and no read-back."""
    cols_h = torch.as_tensor(np.asarray(cols).astype(np.int32))
    signs_h = torch.as_tensor(np.asarray(signs, np.float32))
    smap = srht_signed_slot_map(cols_h, signs_h, N)
    return tuple(t.to(device) for t in (cols_h, signs_h, smap))


def srht_window_block(N: int, lo: int, hi: int) -> tuple[int, int]:
    """(r', b): the smallest aligned power-of-two block [b r', (b+1) r')
    of [0, N) that holds the rows [lo, hi), widened to MIN_PRUNED rows (or
    N where N is smaller)."""
    rp = 1
    while lo // rp != (hi - 1) // rp:
        rp *= 2
    rp = max(rp, min(N, MIN_PRUNED))
    return rp, lo // rp


@functools.lru_cache(maxsize=None)
def srht_plan(n: int, N: int, lo: int, hi: int) -> Plan:
    """The route of one data column of n values encoded into rows [lo, hi)
    of N: ``pruned`` where the window's aligned block r' is below N and at
    most 32768, else ``one-pass`` up to N = 8192, ``cluster`` up to 2^18,
    ``passes`` past it.  ``stage``: the one-pass route stages each column
    by a bulk copy where n is a multiple of 4."""
    rp, b = srht_window_block(N, lo, hi)
    if rp < N and rp <= MAX_ONE_PASS:
        return Plan("pruned", 1, rp, rp, b)
    if N <= MAX_ONE_PASS_SRHT:
        return Plan("one-pass", 1, N, stage=n % 4 == 0)
    if N <= MAX_CLUSTER:
        return Plan("cluster", *cluster_split(N))
    return Plan("passes", 1, MAX_ONE_PASS)


def srht_chunk_rows(p: int, N: int) -> int:
    """Data columns a partial window's multi-pass encode takes at a time:
    as many N-slot float32 frames as fit CHUNK_BYTES (at least one)."""
    return max(1, min(p, CHUNK_BYTES // (N * 4)))


def srht_encode_call(xt: torch.Tensor, cols: torch.Tensor,
                     signs: torch.Tensor, *, N: int, lo: int, hi: int,
                     scale: float,
                     smap: torch.Tensor | None = None) -> torch.Tensor:
    """Rows [lo, hi) of the SRHT encode of ``xt`` (p, n), transposed:
    returns (p, hi - lo).

    cols: (n,) distinct transform slots in [0, N) (int32 on the card);
    signs: (n,) float32 random signs of +-1; N a power of two; smap:
    ``srht_signed_slot_map(cols, signs, N)`` on the data's device, built
    here (and the signs checked) where it is not given.  The card takes the
    route of ``srht_plan(n, N, lo, hi)`` in one launch; a launch the card
    refuses raises.
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
    dev = xt.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if cols.device != dev or signs.device != dev:
        raise ValueError(f"cols on {cols.device}, signs on {signs.device}, "
                         f"data on {dev}")
    if smap is None:
        smap = srht_signed_slot_map(cols, signs, N)
    if dev.type == "cpu":
        return srht_encode_plain(xt, cols, signs, N=N, lo=lo, hi=hi,
                                 scale=scale)
    if xt.dtype != torch.float32 or signs.dtype != torch.float32:
        raise TypeError("SRHT kernel takes float32 data and signs")
    if cols.dtype != torch.int32 or smap.dtype != torch.int32:
        raise TypeError("SRHT kernel takes int32 cols and slot map")
    if smap.shape != (N,) or smap.device != dev:
        raise ValueError(f"slot map {tuple(smap.shape)} on {smap.device}, "
                         f"expected ({N},) on {dev}")
    if not (xt.is_contiguous() and cols.is_contiguous()
            and signs.is_contiguous() and smap.is_contiguous()):
        raise ValueError("SRHT kernel needs contiguous tensors")
    out = torch.empty((p, hi - lo), dtype=xt.dtype, device=dev)
    if not p:
        return out
    plan = srht_plan(n, N, lo, hi)
    lib = load_library()
    if plan.route == "pruned":
        launch("srht_encode", lib.repro_srht_pruned, (xt, smap, out),
               xt.data_ptr(), smap.data_ptr(), out.data_ptr(), p, n, N,
               plan.rp, plan.b, lo, hi, float(scale))
    elif plan.route == "one-pass":
        # a bulk copy needs 16-byte aligned rows: n % 4 == 0 (in the plan)
        # and an aligned base
        bulk = int(plan.stage and xt.data_ptr() % 16 == 0)
        launch("srht_encode", lib.repro_srht_onepass, (xt, smap, out),
               xt.data_ptr(), smap.data_ptr(), out.data_ptr(), p, n, N, lo,
               hi, float(scale), bulk)
    elif plan.route == "cluster":
        launch("srht_encode", lib.repro_srht_cluster, (xt, cols, signs, out),
               xt.data_ptr(), cols.data_ptr(), signs.data_ptr(),
               out.data_ptr(), p, n, N, plan.C, lo, hi, float(scale))
    else:
        _multi_pass(xt, smap, out, N=N, lo=lo, hi=hi, scale=scale)
    launches["srht_encode"] += 1
    return out


def _multi_pass(xt, smap, out, *, N, lo, hi, scale) -> None:
    """The encode past a cluster: pass 1 gathers each 32768-slot segment
    through the signed slot map and transforms it, the strided passes
    finish the transform, and the last scales and windows into out.  The
    full window runs in place on out; a partial one through a float32
    frame of ``srht_chunk_rows`` data columns at a time."""
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
        launch("srht_encode", lib.repro_srht_segments, (xt, smap, w),
               xt[c0:c1].data_ptr(), smap.data_ptr(), w.data_ptr(), c1 - c0,
               n, N, seg)
        for j, (L, S) in enumerate(later):
            last = j == len(later) - 1
            strided_pass(lib, w, out[c0:c1] if last else w, N, L, S,
                         lo if last else 0, hi if last else N,
                         scale if last else 1.0)
