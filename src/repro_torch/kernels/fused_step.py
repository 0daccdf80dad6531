"""Fused masked gradient (paper Algorithm 1): the CUDA kernel's wrapper and
its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/fused_step.py`` (``_fused_body``)

    g = sum_i c_i (S_i X)^T (S_i X w - S_i y),
    c_i = mask_i * (m / k) / (n * beta),  k = max(|mask|, 1),

in one batched entry: W (R, p) iterates and (R, m) masks over one shared
encoded problem.  The single form is the same entry at R = 1.  On CUDA
tensors the wrapper launches ``csrc/fused_step.cu`` (a deterministic
two-stage reduction, so realization r of a batched call equals the single
call bit for bit); on CPU tensors it runs the plain version, which loops
over realizations for the same reason.
"""
from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul

from ._build import check, launches, load_library, stream_of

__all__ = ["fused_masked_gradient", "fused_masked_gradient_plain",
           "pick_fused_block_rows", "MAX_COLS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_ROWS_CAP = 16
# the kernel keeps a thread's share of a row in registers (64 of them at
# 256 threads); wider rows need the multi-pass form, not ported yet
MAX_COLS = 16384


def pick_fused_block_rows(r: int) -> int:
    """Largest divisor of the per-worker row count ``r`` not above 16: the
    rows one block of the kernel's first stage reduces.  A divisor means no
    ragged block; the choice depends on r alone, never on R, so every
    reduction order of the kernel is fixed by the problem's shape."""
    return max(d for d in range(1, min(r, _BLOCK_ROWS_CAP) + 1)
               if r % d == 0)


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
    if p > MAX_COLS:
        raise ValueError(f"fused kernel takes p <= {MAX_COLS}, got {p}")
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
        if not t.is_contiguous():
            raise ValueError(f"fused kernel needs a contiguous {name}")
    if not SX.is_contiguous():
        raise ValueError("fused kernel needs a contiguous SX")
    br = pick_fused_block_rows(r)
    out = torch.empty((R, p), dtype=w.dtype, device=w.device)
    scratch = torch.empty((R, m * (r // br), p), dtype=torch.float32,
                          device=w.device)
    check(load_library().repro_fused_masked_gradient(
        SX.data_ptr(), Sy.data_ptr(), w.data_ptr(), mask.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), R, m, r, p, br,
        float(n * beta), _DTYPES[SX.dtype], stream_of(SX)),
        "fused_masked_gradient")
    launches["fused_masked_gradient"] += 1
    return out
