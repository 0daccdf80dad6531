"""Coded gradient combine ``out = sum_i c_i g_i``: the CUDA kernel's wrapper
and its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/coded_reduce.py``
(``_combine_body``): the master-side aggregation of a worker-stacked (m, P)
gradient block with decode weights c, summed in float32, the result in g's
dtype.  On a CUDA tensor the wrapper launches ``csrc/coded_reduce.cu`` (16
bytes of neighbouring columns a thread, 16-byte loads where P and
alignment allow, the m rows split over ``combine_row_groups(m)`` lane
groups of a warp whose partial sums a fixed shuffle tree adds); on a CPU
tensor it
runs the plain version, ``ref.coded_combine_ref``.

The reference's ``combine_layout`` (pad P to a block multiple, or snap the
block to a divisor of P) and its ``m <= 32`` worker limit exist only for the
TPU's (8, 128) lane tiling and have no counterpart here: the CUDA threads
mask the ragged edge themselves, and m is any count.
"""
from __future__ import annotations

import functools

import torch

from ._build import launch, launches, load_library
from .ref import coded_combine_ref

__all__ = ["coded_combine_call", "coded_combine_ref",
           "combine_row_groups"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUPS = 8


def combine_row_groups(m: int) -> int:
    """Row groups G the kernel splits the m worker rows into: the least
    power of two at or above min(m, 8) (1 for m <= 1).  Group y sums rows
    y, y + G, ... and a fixed shuffle tree adds the G partial sums, so each
    column's order of summation is fixed by m alone; the kernel makes the
    same choice."""
    return 1 if m <= 1 else min(_MAX_GROUPS, 1 << (m - 1).bit_length())


def coded_combine_call(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """g: (m, P) worker gradients; c: (m,) or (m, 1) weights -> (P,).

    CUDA tensors (g float32 or bfloat16; c of any float dtype, read as
    float32) go through the CUDA kernel, CPU tensors through the plain
    version.  The two shapes of c give the same result bit for bit.
    """
    if g.dim() != 2:
        raise ValueError(f"expected g (m, P), got {tuple(g.shape)}")
    m, P = g.shape
    if tuple(c.shape) not in ((m,), (m, 1)):
        raise ValueError(f"weights of shape {tuple(c.shape)} do not match "
                         f"g {tuple(g.shape)}: expected ({m},) or ({m}, 1)")
    if g.device.type == "cpu":
        return coded_combine_ref(g, c)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _check_kernel_operands(g, c)
    if c.dtype != torch.float32 or not c.is_contiguous():
        c = c.to(torch.float32).contiguous()
    out = torch.empty(P, dtype=g.dtype, device=g.device)
    if P:
        # a contiguous (m,) and (m, 1) hold the same m floats: the kernel
        # reads c through its pointer, so neither shape is copied
        launch("coded_combine", _entry(), (g, c, out), g.data_ptr(),
               c.data_ptr(), out.data_ptr(), m, P, _DTYPES[g.dtype])
        launches["coded_combine"] += 1
    return out


def _check_kernel_operands(g: torch.Tensor, c: torch.Tensor) -> None:
    """Raise on what the kernel does not take: g not float32 or bfloat16,
    not contiguous, or c on another device."""
    if c.device != g.device:
        raise ValueError(f"c on {c.device}, g on {g.device}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"combine kernel takes float32 or bfloat16 g, got "
                        f"{g.dtype}")
    if not g.is_contiguous():
        raise ValueError("combine kernel needs a contiguous g")


@functools.cache
def _entry():
    """The kernel's C entry, looked up once."""
    return load_library().repro_coded_combine
