"""Encoded limited-memory BFGS (paper §2.1 'Limited-memory-BFGS', Thm 4).

Port of ``src/repro/core/lbfgs.py``, with the same semantics:
  * gradient differences r_t use ONLY the workers in the overlap
    A_t ∩ A_{t-1}, rescaled by m / |A_t ∩ A_{t-1}| (Lemma 3);
  * the descent direction uses the fastest-k aggregated gradient g~_t,
    combined by ``_masked_mean`` (the combine kernel on the card);
  * the step size comes from EXACT LINE SEARCH over a second fastest-k set
    D_t:  alpha = -rho * (d^T g~) / (d^T X~_D^T X~_D d), 0 < rho < 1 (eq. 3);
  * the two-loop recursion over the (u_j, r_j) pairs with the Nocedal
    initial scaling u^T r / r^T r.

Regularizer h(w) = ||w||^2 (ridge), as the paper assumes.  Everything stays
on the problem's device; the one host read a step is the curvature
safeguard's comparison in ``LBFGSState.push`` (a host decision in the
reference too).  The objective trace is written into a preallocated device
tensor; the caller copies it to the host once.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import full_f32_matmul

from .data_parallel import (EncodedProblem, _masked_mean, encoded_gradients,
                            original_objective)

__all__ = ["LBFGSState", "lbfgs_direction", "run_encoded_lbfgs"]


@dataclasses.dataclass
class LBFGSState:
    u: list  # iterate differences  w_t - w_{t-1}
    r: list  # overlap-set gradient differences
    memory: int

    def push(self, u: torch.Tensor, r: torch.Tensor) -> None:
        # Curvature safeguard (standard): skip pairs with tiny u^T r.  Both
        # products come back to the host in one read.
        ur, uu = torch.stack([torch.dot(u, r),
                              torch.dot(u, u) + 1e-30]).tolist()
        if ur > 1e-10 * uu:
            self.u.append(u)
            self.r.append(r)
            if len(self.u) > self.memory:
                self.u.pop(0)
                self.r.pop(0)


def lbfgs_direction(state: LBFGSState, grad: torch.Tensor) -> torch.Tensor:
    """Two-loop recursion: d = -B_t g~_t."""
    q = grad
    alphas = []
    for u, r in zip(reversed(state.u), reversed(state.r)):
        rho = 1.0 / torch.dot(r, u)
        a = rho * torch.dot(u, q)
        alphas.append((a, rho, u, r))
        q = q - a * r
    if state.u:
        u0, r0 = state.u[-1], state.r[-1]
        q = q * (torch.dot(u0, r0) / torch.dot(r0, r0))
    for a, rho, u, r in reversed(alphas):
        b = rho * torch.dot(r, q)
        q = q + (a - b) * u
    return -q


@full_f32_matmul
def run_encoded_lbfgs(prob: EncodedProblem, masks_A, masks_D=None,
                      memory: int = 10, rho: float = 0.9, w0=None):
    """Run encoded L-BFGS over mask schedules.

    masks_A: (T, m) 0/1 — gradient active sets A_t.
    masks_D: (T, m) 0/1 — line-search active sets D_t (defaults to A_t).

    Returns (w_T, trace) as tensors on the problem's device, trace[t] being
    the original ridge objective after step t.  The reference recomputes
    the previous iterate's worker gradients for the overlap difference; the
    port keeps the previous step's blocks, which are the same numbers.
    """
    dev = prob.device
    masks_A = torch.as_tensor(masks_A, dtype=torch.float32, device=dev)
    masks_D = (masks_A if masks_D is None else
               torch.as_tensor(masks_D, dtype=torch.float32, device=dev))
    T, m = masks_A.shape
    p = prob.SX.shape[-1]
    w = (torch.zeros(p, device=dev) if w0 is None else
         torch.as_tensor(w0, dtype=torch.float32, device=dev))
    lam = prob.lam
    state = LBFGSState([], [], memory)
    prev_w = prev_mask = prev_blocks = None
    trace = torch.empty(T, dtype=torch.float32, device=dev)

    for t in range(T):
        mask = masks_A[t]
        g_blocks = encoded_gradients(prob, w)             # (m, p)
        g = _masked_mean(g_blocks, mask) + lam * w

        if prev_w is not None:
            overlap = mask * prev_mask                    # A_t ∩ A_{t-1}
            novl = overlap.sum().clamp_min(1.0)
            g_ovl_now = torch.einsum("m,mp->p", overlap, g_blocks) * (m / novl)
            g_ovl_prev = (torch.einsum("m,mp->p", overlap, prev_blocks)
                          * (m / novl))
            u_t = w - prev_w
            r_t = (g_ovl_now - g_ovl_prev) + lam * u_t
            state.push(u_t, r_t)

        d = lbfgs_direction(state, g)
        # Exact line search on the encoded quadratic over fastest-k set D_t
        # (paper eq. 3): worker i contributes ||S_i X d||^2.
        maskD = masks_D[t]
        Xd = torch.einsum("mrp,p->mr", prob.SX, d)        # (m, r)
        quad = torch.einsum("m,mr->", maskD, Xd ** 2) / (prob.n * prob.beta)
        quad = (quad * (m / maskD.sum().clamp_min(1.0))
                + lam * torch.dot(d, d))
        alpha = -rho * torch.dot(d, g) / quad.clamp_min(1e-30)

        prev_w, prev_mask, prev_blocks = w, mask, g_blocks
        w = w + alpha * d
        trace[t] = original_objective(prob, w, h="l2")
    return w, trace
