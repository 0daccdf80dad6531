"""Encoded data-parallel optimization (paper §2.1, Algorithms 1-2).

Port of ``src/repro/core/data_parallel.py``.

Objective:   f(w) = 1/(2n) ||X w - y||^2 + lam * h(w)
Encoded:     f~(w) = 1/(2 n beta) ||S (X w - y)||^2 + lam * h(w)

Worker i stores (S_i X, S_i y); at iteration t the master combines the
gradients of the fastest ``k`` workers (erasure mask), rescaled by 1/eta.
Everything here works on worker-stacked tensors ``(m, rows_per_worker, p)``
on one device.  Float32 matrix products run in full float32: the functions
that take one turn ``torch.backends.cuda.matmul.allow_tf32`` off for their
own duration (``full_f32_matmul``), since a TF32 product keeps about three
decimal digits and the objective trace is compared with the reference to
float32 rounding.  The caller's setting is left as it was.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.kernels.ops import coded_combine

from .encoding import LinearEncoder
from .operators import FastHadamardEncoder

__all__ = [
    "EncodedProblem", "make_encoded_problem", "encoded_gradients",
    "masked_gradient", "gd_step", "prox_l1", "prox_step",
    "original_objective",
]


@dataclasses.dataclass
class EncodedProblem:
    """Worker-stacked encoded least-squares problem on one device."""
    SX: torch.Tensor      # (m, r, p)   encoded data blocks
    Sy: torch.Tensor      # (m, r)      encoded responses
    X: torch.Tensor       # (n, p)      original data (for evaluating f)
    y: torch.Tensor       # (n,)
    lam: float
    beta: float
    n: int

    @property
    def m(self) -> int:
        return self.SX.shape[0]

    @property
    def device(self) -> torch.device:
        return self.SX.device

    @classmethod
    def from_numpy(cls, SX, Sy, X, y, *, lam: float, beta: float, n: int,
                   device=None,
                   dtype: torch.dtype = torch.float32) -> "EncodedProblem":
        """The port's problem from the reference's ``EncodedProblem``
        fields given as host arrays (for example ``np.asarray(prob.SX)``),
        so one encoded problem can drive both packages."""
        dev = resolve_device(device)

        def put(a):      # a copy: the arrays may be read-only views
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        return cls(SX=put(SX), Sy=put(Sy), X=put(X), y=put(y),
                   lam=float(lam), beta=float(beta), n=int(n))


def make_encoded_problem(X: np.ndarray, y: np.ndarray, enc: LinearEncoder,
                         m: int, lam: float = 0.0,
                         dtype: torch.dtype = torch.float32,
                         device=None) -> EncodedProblem:
    """Build the worker-stacked encoded problem from any encoding operator.

    X and y are encoded jointly as one (n, p+1) pass.  The fast-Hadamard
    encoder runs its SRHT kernel on the device, on the float32 cast of the
    data (as the reference does), and its (rows, p+1) result stays there.
    Host encoders build float64 blocks that are cast to ``dtype`` exactly as
    the reference casts them.
    """
    dev = resolve_device(device)
    enc = enc.with_workers(m)
    Xy = np.concatenate([np.asarray(X, np.float64),
                         np.asarray(y, np.float64)[:, None]], axis=1)
    if isinstance(enc, FastHadamardEncoder):
        blocks = enc.encode_partitioned(
            torch.as_tensor(Xy, dtype=torch.float32, device=dev))
        SXy = torch.stack(blocks).to(dtype)               # (m, r, p+1)
    else:
        SXy = torch.as_tensor(
            np.stack([np.asarray(b, np.float64)
                      for b in enc.encode_partitioned(Xy)]),
            dtype=dtype, device=dev)
    return EncodedProblem(
        SX=SXy[..., :-1].contiguous(), Sy=SXy[..., -1].contiguous(),
        X=torch.as_tensor(np.asarray(X), dtype=dtype, device=dev),
        y=torch.as_tensor(np.asarray(y), dtype=dtype, device=dev),
        lam=float(lam), beta=float(enc.beta), n=X.shape[0])


@full_f32_matmul
def original_objective(prob: EncodedProblem, w: torch.Tensor,
                       h: str = "l2") -> torch.Tensor:
    """f(w) on the ORIGINAL (uncoded) problem — convergence is measured here.
    A plain product (``torch.matmul``), as the reference leaves it to XLA."""
    r = torch.matmul(prob.X, w) - prob.y
    loss = 0.5 * torch.dot(r, r) / prob.n
    if h == "l2":
        reg = 0.5 * torch.dot(w, w)
    elif h == "l1":
        reg = torch.sum(torch.abs(w))
    elif h == "none":
        reg = 0.0
    else:
        raise ValueError(h)
    return loss + prob.lam * reg


@full_f32_matmul
def encoded_gradients(prob: EncodedProblem, w: torch.Tensor) -> torch.Tensor:
    """Per-worker gradients of the smooth part, (m, p).

    grad_i = 1/(n beta) (S_i X)^T (S_i X w - S_i y).
    """
    r = torch.einsum("mrp,p->mr", prob.SX, w) - prob.Sy
    return torch.einsum("mrp,mr->mp", prob.SX, r) / (prob.n * prob.beta)


def _masked_mean(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(1/eta) sum_{i in A} g_i with eta = k/m, over an (m, p) gradient
    block: the combine kernel (``kernels/coded_reduce.py``) on the card,
    its plain einsum on the CPU; the tensor's device decides.  The weights
    stay on the device, so no step waits on the host."""
    k = mask.sum().clamp_min(1.0)
    return coded_combine(g, mask[:, None] * (g.shape[0] / k))


def masked_gradient(prob: EncodedProblem, w: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Fastest-k aggregation of per-worker encoded gradients (the unfused
    path; the GD / ISTA runners use the fused kernel)."""
    return _masked_mean(encoded_gradients(prob, w), mask)


def gd_step(prob: EncodedProblem, w: torch.Tensor, mask: torch.Tensor,
            step_size: float, h: str = "l2") -> torch.Tensor:
    """Encoded gradient descent step (paper §2.1) with smooth regularizer."""
    g = masked_gradient(prob, w, mask)
    if h == "l2":
        g = g + prob.lam * w
    return w - step_size * g


def prox_l1(v: torch.Tensor, thresh) -> torch.Tensor:
    """Soft-thresholding operator (ISTA)."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0.0)


def prox_step(prob: EncodedProblem, w: torch.Tensor, mask: torch.Tensor,
              step_size: float) -> torch.Tensor:
    """Encoded proximal gradient step for l1 regularizer (paper §2.1, Thm 5)."""
    g = masked_gradient(prob, w, mask)
    return prox_l1(w - step_size * g, step_size * prob.lam)
