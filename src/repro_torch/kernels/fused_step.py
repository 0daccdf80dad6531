"""Fused masked gradient (paper Algorithm 1): the CUDA kernel's wrapper and
its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/fused_step.py`` (``_fused_body``)

    g = sum_i c_i (S_i X)^T (S_i X w - S_i y),
    c_i = mask_i * (m / k) / (n * beta),  k = max(|mask|, 1),

in one batched entry: W (R, p) iterates and (R, m) masks over one shared
encoded problem.  The single form is the same entry at R = 1.  On CUDA
tensors the wrapper launches the kernel: up to p = MAX_COLS
``csrc/fused_step.cu``, a deterministic two-stage reduction whose first
stage holds a row in one block's registers and reads each row of SX once
for a tile of realizations; past it the column-split form of
``csrc/fused_wide.cu`` along ``wide_plan(p, itemsize)``'s route: "cluster"
(the 8 CTAs of a thread-block cluster each hold one column slice of a row
in shared memory, share the row's dot products through distributed shared
memory and add the same staged slice into the gradient, so each active row
is read once), or "two-read" past the cluster's capacity (the rows' dot
products by column chunks, then the gradient by column tiles, reading the
rows twice).  All end in the same second stage, and realization r of a
batched call equals the single call bit for bit.  On CPU tensors it runs
the plain version, which loops over realizations for the same reason.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from repro_torch.device import full_f32_matmul

from ._build import launch, launches, load_library

__all__ = ["fused_enabled", "fused_masked_gradient",
           "fused_masked_gradient_plain",
           "pick_fused_block_rows", "pick_fused_realization_tile",
           "pick_wide_block_rows", "fused_wide_scratch_bytes",
           "fused_row_registers", "fused_stage1_smem_bytes", "wide_plan",
           "WidePlan", "MAX_COLS", "WIDE_CHUNK", "WIDE_CLUSTER"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_ROWS_CAP = 16
# the one-read form keeps a thread's share of a row in registers (64 of
# them at 256 threads); wider rows take the column-split form
_THREADS = 256
_REG_STEPS = (1, 2, 4, 8, 16, 24, 32, 48, 64)
MAX_COLS = _REG_STEPS[-1] * _THREADS
# the first stage's budgets (csrc/fused_step.cu): registers a thread for
# one row and its accumulators, and dynamic shared memory a block (the
# 227 KB opt-in maximum less 3 KB for the static arrays)
_REG_BUDGET = 200
SMEM_BUDGET = 227 * 1024 - 3072
# the column-split form (csrc/fused_wide.cu): the most rows of one scratch
# unit; on the cluster route the CTAs a row (the portable cluster size),
# the vectors of 4 columns a thread may hold for its slice, the registers
# its iterates and sums may take (2 * 4 NV * RT) and the ring's depths; on
# the two-read route the columns of one partial dot product
_WIDE_ROWS_CAP = 64
WIDE_CLUSTER = 8
_WIDE_VECTORS = (3, 4, 6, 8, 10, 13, 16, 19)
_WIDE_REG_BUDGET = 208
_WIDE_SLOTS = (3, 8)
_WIDE_TILE = 4
WIDE_CHUNK = 4096


class WidePlan(NamedTuple):
    """How the column-split form takes a width p: ``route`` ("cluster" or
    "two-read"), ``C`` CTAs a row, ``slice_cols`` columns of each CTA's
    slice but the last (which takes the rest of p), ``threads`` a CTA,
    ``vectors`` (NV) of 4 columns a thread holds, ``tile`` (RT) the
    realizations a cluster takes, ``slots`` the ring of staged slices a
    CTA.  On the two-read route only ``tile`` is read (1 for a single
    call)."""
    route: str
    C: int
    slice_cols: int
    threads: int
    vectors: int
    tile: int
    slots: int


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


def pick_wide_block_rows(r: int) -> int:
    """Largest divisor of r not above 64: the rows of one scratch unit of
    the column-split form (p > MAX_COLS).  From r alone, like
    ``pick_fused_block_rows``."""
    return max(d for d in range(1, min(r, _WIDE_ROWS_CAP) + 1)
               if r % d == 0)


def wide_plan(p: int, itemsize: int) -> WidePlan:
    """The column-split form's plan at width p > MAX_COLS for elements of
    ``itemsize`` bytes (4 float32, 2 bfloat16), as ``csrc/fused_wide.cu``
    makes it.  Each of the 8 CTAs takes a slice of S columns, ceil(p / 8)
    rounded up to 16 bytes (the last takes the rest); a thread holds NV
    vectors of 4 columns, the smallest listed NV with NV * 4 * 256 >= S;
    the tile is the largest of 4, 2, 1 with 2 * 4 NV * RT <= 208 registers
    (its iterates and sums); the ring as many slices as fit SMEM_BUDGET, up
    to 8.  Where no listed NV holds S or fewer than 3 slices fit, the
    two-read route takes the width.  A function of p and the dtype alone,
    never of R, so a realization's sums never depend on its batch."""
    if p <= MAX_COLS:
        raise ValueError(f"the column-split form takes p > {MAX_COLS}, "
                         f"got {p}")
    if itemsize not in (4, 2):
        raise ValueError(f"itemsize 4 or 2, got {itemsize}")
    align = 16 // itemsize
    S = -(-(-(-p // WIDE_CLUSTER)) // align) * align
    need = -(-S // (4 * _THREADS))
    nv = next((v for v in _WIDE_VECTORS if need <= v), 0)
    slots = min(_WIDE_SLOTS[1], SMEM_BUDGET // (S * itemsize))
    if nv == 0 or slots < _WIDE_SLOTS[0]:
        return WidePlan("two-read", 1, 0, _THREADS, 0, _WIDE_TILE, 0)
    rt = next(t for t in (4, 2, 1)
              if t == 1 or 2 * 4 * nv * t <= _WIDE_REG_BUDGET)
    return WidePlan("cluster", WIDE_CLUSTER, S, _THREADS, nv, rt, slots)


def fused_wide_scratch_bytes(m: int, r: int, p: int, itemsize: int = 4) -> int:
    """Bytes of scratch a realization of the column-split form takes: one
    float32 p-row a unit of ``pick_wide_block_rows(r)`` rows, and on the
    two-read route the rows' chunk sums."""
    units = m * (r // pick_wide_block_rows(r))
    chunks = (m * r * -(-p // WIDE_CHUNK)
              if wide_plan(p, itemsize).route == "two-read" else 0)
    return 4 * (units * p + chunks)


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
    out = torch.empty((R, p), dtype=w.dtype, device=w.device)
    if p <= MAX_COLS:
        br = pick_fused_block_rows(r)
        scratch = torch.empty((R, m * (r // br), p), dtype=torch.float32,
                              device=w.device)
        launch("fused_masked_gradient", _entry(),
               (SX, Sy, w, mask, scratch, out),
               SX.data_ptr(), Sy.data_ptr(), w.data_ptr(), mask.data_ptr(),
               scratch.data_ptr(), out.data_ptr(), R, m, r, p, br,
               float(n * beta), _DTYPES[SX.dtype])
    else:
        bw = pick_wide_block_rows(r)
        scratch = torch.empty((R, m * (r // bw), p), dtype=torch.float32,
                              device=w.device)
        # the two-read route's chunk sums; none on the cluster route
        partial = None
        if wide_plan(p, SX.element_size()).route == "two-read":
            partial = torch.empty((R, m, r, -(-p // WIDE_CHUNK)),
                                  dtype=torch.float32, device=w.device)
        launch("fused_masked_gradient",
               load_library().repro_fused_masked_gradient_wide,
               (SX, Sy, w, mask, scratch, out) + (
                   () if partial is None else (partial,)),
               SX.data_ptr(), Sy.data_ptr(), w.data_ptr(), mask.data_ptr(),
               None if partial is None else partial.data_ptr(),
               scratch.data_ptr(), out.data_ptr(), R, m, r, p, bw,
               float(n * beta), _DTYPES[SX.dtype])
    launches["fused_masked_gradient"] += 1
    return out


def _check_kernel_operands(SX, Sy, w, mask) -> None:
    """Raise on what the kernel does not take: operands not of one dtype
    of float32 or bfloat16, masks not float32, operands on other devices
    than SX, or not contiguous.  Every width p is taken."""
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
