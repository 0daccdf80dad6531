"""Fused masked gradient (paper Algorithm 1): the CUDA kernel's wrapper and
its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/fused_step.py`` (``_fused_body``)

    g = sum_i c_i (S_i X)^T (S_i X w - S_i y),
    c_i = mask_i * (m / k) / (n * beta),  k = max(|mask|, 1),

in one batched entry: W (R, p) iterates and (R, m) masks over one shared
encoded problem.  The single form is the same entry at R = 1.  On CUDA
tensors the wrapper launches ``csrc/fused_step.cu`` (a deterministic
two-stage reduction whose first stage reads each row of SX once for a tile
of realizations, so realization r of a batched call equals the single call
bit for bit); on CPU tensors it runs the plain version, which loops over
realizations for the same reason.
"""
from __future__ import annotations

import functools
import os

import torch

from repro_torch.device import full_f32_matmul

from ._build import check, launches, load_library, stream_of

__all__ = ["fused_enabled", "fused_masked_gradient",
           "fused_masked_gradient_plain",
           "pick_fused_block_rows", "pick_fused_realization_tile",
           "fused_row_registers", "fused_stage1_smem_bytes", "MAX_COLS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_ROWS_CAP = 16
# the kernel keeps a thread's share of a row in registers (64 of them at
# 256 threads); wider rows need the multi-pass form, not ported yet
_THREADS = 256
_REG_STEPS = (1, 2, 4, 8, 16, 24, 32, 48, 64)
MAX_COLS = _REG_STEPS[-1] * _THREADS
# the first stage's budgets (csrc/fused_step.cu): registers a thread for
# one row and its accumulators, and dynamic shared memory a block (the
# 227 KB opt-in maximum less 3 KB for the static arrays)
_REG_BUDGET = 200
SMEM_BUDGET = 227 * 1024 - 3072


def fused_enabled() -> bool:
    """Should the GD / ISTA runners take the fused kernel?  ``REPRO_FUSED``
    decides when it is set, as in the reference ("", "0", "false" and "no"
    turn it off); the other branch is ``core.data_parallel.masked_gradient``,
    whose combine is the coded-combine kernel on the card.

    Unset, it is on for every device, where the reference turns it on for
    the TPU only: the port's CPU path runs the kernel's plain version and
    exists to test the card's path, so both take the same branch.  The
    runners read it once a run."""
    env = os.environ.get("REPRO_FUSED")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no")
    return True


def pick_fused_block_rows(r: int) -> int:
    """Largest divisor of the per-worker row count ``r`` not above 16: the
    rows one block of the kernel's first stage reduces.  A divisor means no
    ragged block; the choice depends on r alone, never on R, so every
    reduction order of the kernel is fixed by the problem's shape."""
    return max(d for d in range(1, min(r, _BLOCK_ROWS_CAP) + 1)
               if r % d == 0)


def fused_row_registers(p: int) -> int:
    """Registers NE a first-stage thread holds for one row of width p: the
    smallest of 1, 2, 4, 8, 16, 24, 32, 48, 64 with NE * 256 >= p."""
    if not 0 < p <= MAX_COLS:
        raise ValueError(f"fused kernel takes 0 < p <= {MAX_COLS}, got {p}")
    return next(ne for ne in _REG_STEPS if ne * _THREADS >= p)


def fused_stage1_smem_bytes(p: int, tile: int, itemsize: int) -> int:
    """Least dynamic shared memory of a first-stage block: ``tile`` float32
    iterates of width p, then two row buffers of p elements of
    ``itemsize`` bytes, each rounded up to 16 bytes."""
    def r16(b):
        return (b + 15) // 16 * 16
    return r16(tile * p * 4) + 2 * r16(p * itemsize)


def pick_fused_realization_tile(p: int) -> int:
    """Realizations RT one first-stage block takes at width p: the largest
    of 8, 4, 2, 1 whose NE * (1 + RT) registers (a row and RT sets of
    accumulators) stay within 200 a thread, and whose RT float32 iterates
    fit shared memory beside two float32 row buffers at the widest p its NE
    serves.  Depends on p alone (through NE), so a realization's sums never
    depend on the batch; the kernel makes the same choice."""
    ne = fused_row_registers(p)
    return next(rt for rt in (8, 4, 2, 1)
                if rt == 1 or (ne * (1 + rt) <= _REG_BUDGET and
                               fused_stage1_smem_bytes(ne * _THREADS, rt, 4)
                               <= SMEM_BUDGET))


def _decode_weights(masks: torch.Tensor, m: int, n: int,
                    beta: float) -> torch.Tensor:
    k = masks.sum(-1, keepdim=True).clamp_min(1.0)
    return (masks * (m / k) / (n * beta)).float()


@full_f32_matmul
def fused_masked_gradient_plain(SX, Sy, W, masks, *, n: int,
                                beta: float) -> torch.Tensor:
    """Plain PyTorch version of the batched fused gradient: (R, p) in W's
    dtype, summed in float32, one realization at a time (so a row's result
    never depends on the batch it came in)."""
    m = SX.shape[0]
    SXf, Syf = SX.float(), Sy.float()
    c = _decode_weights(masks.float(), m, n, beta)
    out = []
    for q in range(W.shape[0]):
        u = torch.matmul(SXf, W[q].float()) - Syf                # (m, r)
        out.append(torch.einsum("m,mrp,mr->p", c[q], SXf, u))
    return torch.stack(out).to(W.dtype)


def fused_masked_gradient(SX: torch.Tensor, Sy: torch.Tensor,
                          w: torch.Tensor, mask: torch.Tensor, *, n: int,
                          beta: float) -> torch.Tensor:
    """The fused (1/eta)-scaled masked gradient.

    SX (m, r, p) / Sy (m, r) are the worker-stacked encoded blocks.  Single
    form: w (p,), mask (m,) -> (p,).  Batched form: w (R, p), mask (R, m)
    -> (R, p).  Operands in float32 or bfloat16 (one dtype), masks {0, 1}
    float, sums in float32, result in w's dtype.
    """
    if w.dim() == 1:
        return fused_masked_gradient(SX, Sy, w[None], mask[None], n=n,
                                     beta=beta)[0]
    if SX.dim() != 3 or w.dim() != 2 or mask.dim() != 2:
        raise ValueError("expected SX (m, r, p), w (R, p), mask (R, m)")
    m, r, p = SX.shape
    R = w.shape[0]
    if Sy.shape != (m, r) or w.shape[1] != p or mask.shape != (R, m):
        raise ValueError(f"shape mismatch: SX {tuple(SX.shape)}, Sy "
                         f"{tuple(Sy.shape)}, w {tuple(w.shape)}, mask "
                         f"{tuple(mask.shape)}")
    if SX.device.type == "cpu":
        return fused_masked_gradient_plain(SX, Sy, w, mask, n=n, beta=beta)
    if SX.device.type != "cuda":
        raise ValueError(f"unsupported device {SX.device}")
    _check_kernel_operands(SX, Sy, w, mask)
    br = pick_fused_block_rows(r)
    out = torch.empty((R, p), dtype=w.dtype, device=w.device)
    scratch = torch.empty((R, m * (r // br), p), dtype=torch.float32,
                          device=w.device)
    check(_entry()(
        SX.data_ptr(), Sy.data_ptr(), w.data_ptr(), mask.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), R, m, r, p, br,
        float(n * beta), _DTYPES[SX.dtype], stream_of(SX)),
        "fused_masked_gradient")
    launches["fused_masked_gradient"] += 1
    return out


def _check_kernel_operands(SX, Sy, w, mask) -> None:
    """Raise on what the kernel does not take: p > MAX_COLS, operands not
    of one dtype of float32 or bfloat16, masks not float32, operands on
    other devices than SX, or not contiguous."""
    p = SX.shape[-1]
    if p > MAX_COLS:
        raise ValueError(f"fused kernel takes p <= {MAX_COLS}, got {p}; "
                         f"REPRO_FUSED=0 takes the combine path "
                         f"(core.data_parallel.masked_gradient), which takes "
                         f"any p")
    if SX.dtype not in _DTYPES or Sy.dtype != SX.dtype or \
            w.dtype != SX.dtype:
        raise TypeError(f"fused kernel takes one operand dtype of float32 "
                        f"or bfloat16; got SX {SX.dtype}, Sy {Sy.dtype}, "
                        f"w {w.dtype}")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")
    for name, t in (("Sy", Sy), ("w", w), ("mask", mask)):
        if t.device != SX.device:
            raise ValueError(f"{name} on {t.device}, SX on {SX.device}")
    for name, t in (("SX", SX), ("Sy", Sy), ("w", w), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"fused kernel needs a contiguous {name}")


@functools.cache
def _entry():
    """The kernel's C entry, looked up once."""
    return load_library().repro_fused_masked_gradient
