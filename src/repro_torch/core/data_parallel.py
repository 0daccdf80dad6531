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
import math

import numpy as np
import torch

from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.kernels.ops import coded_combine

from .encoding import LinearEncoder
from .operators import FastHadamardEncoder

__all__ = [
    "EncodedProblem", "make_encoded_problem", "encoded_gradients",
    "masked_gradient", "gd_step", "run_encoded_gd", "prox_l1", "prox_step",
    "run_encoded_proximal", "original_objective",
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

    def to(self, device) -> "EncodedProblem":
        """The problem with S X, S y, X and y on ``device`` (tensors already
        there are not copied) and the same scalars."""
        return dataclasses.replace(
            self, SX=self.SX.to(device), Sy=self.Sy.to(device),
            X=self.X.to(device), y=self.y.to(device))

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
    data (as the reference does), and its (rows, p+1) result stays there
    (``_hadamard_blocks``).  Host encoders build float64 blocks that are
    cast to ``dtype`` exactly as the reference casts them.
    """
    dev = resolve_device(device)
    enc = enc.with_workers(m)
    if isinstance(enc, FastHadamardEncoder):
        SX, Sy = _hadamard_blocks(X, y, enc, dtype, dev)
    else:
        Xy = np.concatenate([np.asarray(X, np.float64),
                             np.asarray(y, np.float64)[:, None]], axis=1)
        SXy = torch.as_tensor(
            np.stack([np.asarray(b, np.float64)
                      for b in enc.encode_partitioned(Xy)]),
            dtype=dtype, device=dev)
        SX, Sy = SXy[..., :-1].contiguous(), SXy[..., -1].contiguous()
        del SXy
    return EncodedProblem(
        SX=SX, Sy=Sy,
        X=torch.as_tensor(np.asarray(X), dtype=dtype, device=dev),
        y=torch.as_tensor(np.asarray(y), dtype=dtype, device=dev),
        lam=float(lam), beta=float(enc.beta), n=X.shape[0])


# host rows of the data cast and moved to the device at a time
_STAGE_ROWS = 1024


def _hadamard_blocks(X, y, enc: FastHadamardEncoder, dtype, dev):
    """SX (m, r, p) and Sy (m, r) of the fast-Hadamard encode of [X y].

    The SRHT kernel reads the data as columns, xt = [X y]^T (p+1, n)
    float32, built on the device from float32 casts of a few host rows at a
    time, and writes the (p+1, N) frame.  xt is dropped before the frame
    is copied once into the worker blocks (zero rows past N pad the last
    worker), and the frame after, so the device holds at most the frame
    and SX (about 2 |SX|) and the host no float64 copy of the data.  The
    values equal those of stacking ``enc.encode_partitioned`` of the
    float32 [X y] and splitting off its last column."""
    from repro_torch.kernels.encode import srht_encode_call, srht_operands
    X = np.asarray(X)
    n, p = X.shape
    xt = torch.empty((p + 1, n), dtype=torch.float32, device=dev)
    for r0 in range(0, n, _STAGE_ROWS):
        rows = torch.as_tensor(X[r0:r0 + _STAGE_ROWS]).to(dev, torch.float32)
        xt[:p, r0:r0 + _STAGE_ROWS] = rows.t()
        del rows
    xt[p] = torch.as_tensor(np.asarray(y)).to(dev, torch.float32)
    cols, signs, smap = srht_operands(enc.cols, enc.signs, enc.N, dev)
    frame = srht_encode_call(xt, cols, signs, N=enc.N, lo=0, hi=enc.N,
                             scale=1.0 / math.sqrt(n), smap=smap)
    del xt
    m, r = enc.m, enc.rows_per_worker
    SX = torch.empty((m, r, p), dtype=dtype, device=dev)
    Sy = torch.empty((m, r), dtype=dtype, device=dev)
    SX.view(m * r, p)[:enc.N].copy_(frame[:p].t())
    Sy.view(-1)[:enc.N].copy_(frame[p])
    SX.view(m * r, p)[enc.N:].zero_()
    Sy.view(-1)[enc.N:].zero_()
    return SX, Sy


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
    path, which the GD / ISTA runners take under ``REPRO_FUSED=0``)."""
    return _masked_mean(encoded_gradients(prob, w), mask)


def gd_step(prob: EncodedProblem, w: torch.Tensor, mask: torch.Tensor,
            step_size: float, h: str = "l2") -> torch.Tensor:
    """Encoded gradient descent step (paper §2.1) with smooth regularizer."""
    g = masked_gradient(prob, w, mask)
    if h == "l2":
        g = g + prob.lam * w
    return w - step_size * g


def _on_device(prob: EncodedProblem, device) -> EncodedProblem:
    """``prob`` with its tensors on ``device`` (``Tensor.to`` copies
    nothing for a tensor already there)."""
    dev = resolve_device(device)
    return dataclasses.replace(prob, SX=prob.SX.to(dev), Sy=prob.Sy.to(dev),
                               X=prob.X.to(dev), y=prob.y.to(dev))


def _start(prob: EncodedProblem, w0) -> torch.Tensor:
    """The starting iterate on ``prob``'s device: zeros, or ``w0`` (any
    array or tensor, on any device) as float32."""
    if w0 is None:
        return torch.zeros(prob.SX.shape[-1], device=prob.device)
    return torch.as_tensor(w0, dtype=torch.float32, device=prob.device)


def run_encoded_gd(prob: EncodedProblem, masks, step_size: float, w0=None,
                   h: str = "l2", device=None):
    """Run GD over a precomputed (T, m) mask schedule; returns (w_T, f-trace)
    with w_T a tensor on ``device`` and the trace a host array.

    Thin wrapper over the runner ``runtime.runners.scan_gd``: the schedule
    and the trace stay on the device until the end.  ``device`` unset means
    CUDA (and raises without a card); the problem and ``w0`` are moved
    there if they lie elsewhere.
    """
    from repro_torch.runtime.runners import scan_gd
    prob = _on_device(prob, device)
    w = _start(prob, w0)
    w, trace = scan_gd(prob, masks, step_size, w, h=h)
    return w, trace.cpu().numpy()


def prox_l1(v: torch.Tensor, thresh) -> torch.Tensor:
    """Soft-thresholding operator (ISTA)."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0.0)


def prox_step(prob: EncodedProblem, w: torch.Tensor, mask: torch.Tensor,
              step_size: float) -> torch.Tensor:
    """Encoded proximal gradient step for l1 regularizer (paper §2.1, Thm 5)."""
    g = masked_gradient(prob, w, mask)
    return prox_l1(w - step_size * g, step_size * prob.lam)


def run_encoded_proximal(prob: EncodedProblem, masks, step_size: float,
                         w0=None, device=None):
    """Encoded ISTA over a mask schedule; returns (w_T, f-trace with h=l1).

    Thin wrapper over the runner ``runtime.runners.scan_prox``; ``device``
    as in ``run_encoded_gd``."""
    from repro_torch.runtime.runners import scan_prox
    prob = _on_device(prob, device)
    w = _start(prob, w0)
    w, trace = scan_prox(prob, masks, step_size, w)
    return w, trace.cpu().numpy()
