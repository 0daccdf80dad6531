"""Plain PyTorch oracles for the kernels (allclose targets in tests),
counterparts of ``src/repro/kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.device import full_f32_matmul


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Recursive FWHT along the last axis (no normalization), float32."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("power of two required")
    x = x.float()
    h = 1
    while h < n:
        y = x.reshape(x.shape[:-1] + (n // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(x.shape)
        h *= 2
    return x


@full_f32_matmul
def fwht_matrix_ref(x: torch.Tensor) -> torch.Tensor:
    """Dense H @ x oracle (independent of the butterfly formulation)."""
    n = x.shape[-1]
    H = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    while H.shape[0] < n:
        H = torch.cat([torch.cat([H, H], 1), torch.cat([H, -H], 1)], 0)
    return torch.einsum("nm,...m->...n", H, x.float())


@full_f32_matmul
def fused_masked_gradient_ref(SX, Sy, w, mask, *, n: int,
                              beta: float) -> torch.Tensor:
    """Dense einsum oracle of the single fused gradient (p,)."""
    k = mask.sum().clamp_min(1.0)
    c = mask * (SX.shape[0] / k) / (n * beta)
    u = torch.einsum("mrp,p->mr", SX, w) - Sy
    return torch.einsum("m,mrp,mr->p", c, SX, u).to(w.dtype)


@full_f32_matmul
def coded_combine_ref(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version of the coded combine (counterpart of the reference's
    oracle of the same name): ``sum_i c_i g_i`` as one float32 einsum, cast
    back to g's dtype; c may be (m,) or (m, 1)."""
    return torch.einsum("m,mp->p", c.reshape(-1).float(),
                        g.float()).to(g.dtype)
