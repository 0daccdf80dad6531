"""Encoded model parallelism: block coordinate descent on the lifted problem
(paper §2.2, Algorithms 3-4; Thm 6).

Port of ``src/repro/core/model_parallel.py``.

Original:  min_w g(w) = phi(X w),   X column-partitioned across m workers.
Encoded:   w = S^T v,  min_v g~(v) = phi(X S^T v) = phi(sum_i X S_i^T v_i).

Worker i stores the column block X S_i^T and its parameter slice v_i; the
master keeps the summed activations z = sum_i u_i with u_i = X S_i^T v_i.
Per iteration only workers in A_t commit their step (an erased worker's
step is discarded, v_i stays put).  phi is a (value, grad) pair of
functions of the n-vector of activations, holding its data on the device
it was built for; built-ins: quadratic phi(z) = 1/(2n)||z - y||^2 and
logistic with labels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

from .encoding import LinearEncoder
from .operators import FastHadamardEncoder

__all__ = ["LiftedProblem", "make_lifted_problem", "phi_quadratic",
           "phi_logistic", "run_encoded_bcd"]


@dataclasses.dataclass
class LiftedProblem:
    XS: torch.Tensor       # (m, n, p_block)  worker column blocks X S_i^T
    phi_val: Callable      # z (n,) -> scalar
    phi_grad: Callable     # z (n,) -> (n,)
    beta: float

    @property
    def m(self) -> int:
        return self.XS.shape[0]

    @property
    def device(self) -> torch.device:
        return self.XS.device

    @classmethod
    def from_numpy(cls, XS, phi_val, phi_grad, beta: float, device=None,
                   dtype: torch.dtype = torch.float32) -> "LiftedProblem":
        """The port's lifted problem from the reference's ``XS`` given as a
        host array (for example ``np.asarray(prob.XS)``), so one lifted
        problem can drive both packages."""
        XS = torch.tensor(np.asarray(XS), dtype=dtype,
                          device=resolve_device(device))
        return cls(XS, phi_val, phi_grad, float(beta))


def make_lifted_problem(X: np.ndarray, enc: LinearEncoder, m: int, phi_val,
                        phi_grad, dtype: torch.dtype = torch.float32,
                        device=None) -> LiftedProblem:
    """Encode the FEATURE dimension: S is (beta p, p), and worker i's block
    is X S_i^T = (S_i X^T)^T.  The fast-Hadamard encoder runs its SRHT
    kernel on the device on the float32 cast of X^T (as
    ``make_encoded_problem`` does); host encoders build float64 blocks that
    are cast to ``dtype`` as the reference casts them."""
    dev = resolve_device(device)
    p = X.shape[1]
    if enc.n != p:
        raise ValueError(f"encoder dim {enc.n} != feature dim {p}")
    enc = enc.with_workers(m)
    if isinstance(enc, FastHadamardEncoder):
        Xt = torch.as_tensor(np.asarray(X, np.float64).T, dtype=torch.float32,
                             device=dev)
        XS = torch.stack([b.t() for b in enc.encode_partitioned(Xt)])
        XS = XS.to(dtype).contiguous()
    else:
        XS = torch.as_tensor(
            np.stack([np.asarray(b, np.float64).T
                      for b in enc.encode_partitioned(np.asarray(X).T)]),
            dtype=dtype, device=dev)
    return LiftedProblem(XS, phi_val, phi_grad, float(enc.beta))


def phi_quadratic(y: np.ndarray, device=None):
    """phi(z) = 1/(2n) ||z - y||^2, y held as float32 on ``device``."""
    yt = torch.tensor(np.asarray(y), dtype=torch.float32,
                      device=resolve_device(device))

    def val(z):
        r = z - yt
        return 0.5 * torch.dot(r, r) / yt.shape[0]

    def grad(z):
        return (z - yt) / yt.shape[0]
    return val, grad


def phi_logistic(labels: np.ndarray, lam: float = 0.0, device=None):
    """phi(z) = mean log(1 + exp(-l_i z_i)); labels in {-1, +1}, held as
    float32 on ``device``."""
    lt = torch.tensor(np.asarray(labels), dtype=torch.float32,
                      device=resolve_device(device))

    def val(z):
        return torch.logaddexp(torch.zeros_like(z), -lt * z).mean()

    def grad(z):
        return -lt * torch.sigmoid(-lt * z) / lt.shape[0]
    return val, grad


def run_encoded_bcd(prob: LiftedProblem, masks, step_size: float, v0=None):
    """Run encoded BCD over a (T, m) mask schedule (Algorithms 3-4): every
    worker computes its step from the CURRENT activations, only workers in
    A_t commit it.  Returns (v_T, objective trace of length T + 1) as tensors
    on the problem's device; a thin wrapper over ``runtime.runners.scan_bcd``.
    """
    from repro_torch.runtime.runners import scan_bcd
    m, _, pb = prob.XS.shape
    v = torch.zeros((m, pb), device=prob.device) if v0 is None else v0
    return scan_bcd(prob, masks, step_size, v)
