"""Fast Walsh-Hadamard transform: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of the TPU kernel ``src/repro/kernels/fwht.py`` (``_fwht_body``).  On
a CUDA tensor the wrapper launches ``csrc/fwht.cu`` along the route of
``fwht_plan``: one pass (one block per row, the whole row on chip for all
log2(n) stages) up to n = 32768; one launch over thread-block clusters
(a row across the shared memory of 8 CTAs) up to n = 2^18; past that the
Kronecker split of ``fwht_passes`` (the one-pass kernel over contiguous
segments, then strided passes through device memory).  On a CPU tensor it
runs the plain version, the reshape-and-stack butterfly of the reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ._build import check, launches, load_library, stream_of

__all__ = ["fwht_kernel_call", "fwht_plain", "butterfly", "fwht_passes",
           "fwht_plan", "Plan", "MAX_ONE_PASS", "MAX_STRIDED", "MAX_CLUSTER",
           "CLUSTER_CTAS", "MIN_CTA_SLOTS"]

# one block holds a whole row in shared memory (128 KB of float32); longer
# rows are split into segments of this length (pass 1) and strided passes
MAX_ONE_PASS = 32768
# points of one strided pass's butterflies (csrc/fwht.cu kMaxStrided)
MAX_STRIDED = 1024
# a thread-block cluster holds a row in the shared memory of its CTAs: at
# most 8 of them (the portable cluster size), 8192 to 32768 slots each
CLUSTER_CTAS = 8
MIN_CTA_SLOTS = 8192
MAX_CLUSTER = CLUSTER_CTAS * MAX_ONE_PASS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def butterfly(x: torch.Tensor, n: int) -> torch.Tensor:
    """All log2(n) FWHT butterfly stages over the trailing axis of a
    (rows, n) float32 tensor, in the reference's stage order."""
    rows = x.shape[0]
    h = 1
    while h < n:
        y = x.reshape(rows, n // (2 * h), 2, h)
        a = y[:, :, 0, :]
        b = y[:, :, 1, :]
        x = torch.stack([a + b, a - b], dim=2).reshape(rows, n)
        h *= 2
    return x


def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FWHT of a (rows, n) tensor, computed in float32 and
    returned in x's dtype."""
    return butterfly(x.float(), x.shape[1]).to(x.dtype)


def _check_length(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"FWHT length {n} is not a power of two")


def fwht_passes(n: int) -> list[tuple[int, int]]:
    """The kernel's passes for a row of n (a power of two), as (length,
    stride): pass 1 is (min(n, 32768), 1), the one-pass transform of each
    contiguous segment; each later pass (L, S) runs the L-point butterflies
    at stride S (S the product of the earlier lengths, L <= 1024).  In
    Sylvester order H_n = H_L (x) ... (x) H_N2, so the passes together are
    the whole transform, and they run its stages in the reference's order
    (h below the first length first)."""
    _check_length(n)
    first = min(n, MAX_ONE_PASS)
    passes, done = [(first, 1)], first
    while done < n:
        L = min(n // done, MAX_STRIDED)
        passes.append((L, done))
        done *= L
    return passes


class Plan(NamedTuple):
    """How a kernel takes a row: ``route`` ("one-pass", "pruned", "cluster"
    or "passes"), ``C`` CTAs a row (1 outside a cluster), ``slots`` the
    transform points a CTA holds; for the SRHT also the window's aligned
    block [b rp, (b+1) rp) and whether the one-pass route stages each
    column in shared memory by a bulk copy (``stage``).  A plan is a
    function of one row's shapes only, so a row's result never depends on
    how many rows share the call."""
    route: str
    C: int
    slots: int
    rp: int = 0
    b: int = 0
    stage: bool = False


def cluster_split(n: int) -> tuple[int, int]:
    """(C, slots a CTA) of an n-point row held by a cluster: slots =
    max(8192, n / 8), C = n / slots, so few rows still spread over many
    SMs and a CTA holds at most 32768 float32 (128 KB)."""
    slots = max(MIN_CTA_SLOTS, n // CLUSTER_CTAS)
    return n // slots, slots


@functools.lru_cache(maxsize=None)
def fwht_plan(n: int) -> Plan:
    """The route of an n-point FWHT row: one pass up to 32768, a cluster
    up to 2^18, the strided passes of ``fwht_passes`` past it."""
    _check_length(n)
    if n <= MAX_ONE_PASS:
        return Plan("one-pass", 1, n)
    if n <= MAX_CLUSTER:
        return Plan("cluster", *cluster_split(n))
    return Plan("passes", 1, MAX_ONE_PASS)


def strided_pass(lib, src: torch.Tensor, dst: torch.Tensor, n: int, L: int,
                 S: int, lo: int, hi: int, scale: float) -> None:
    """Launch one strided pass (``csrc/fwht.cu`` fwht_strided) from the
    float32 rows of src (rows, n) into positions [lo, hi) of dst (rows,
    hi - lo), times scale; src and dst may be one tensor (lo = 0, hi = n)."""
    check(lib.repro_fwht_strided(
        src.data_ptr(), dst.data_ptr(), src.shape[0], n, L, S, lo, hi,
        float(scale), 0, _DTYPES[dst.dtype], stream_of(src)), "fwht")


def fwht_kernel_call(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised FWHT along the last axis of x: (rows, n) -> (rows, n).

    n must be a power of two.  CUDA tensors (float32 or bfloat16,
    contiguous) go through the CUDA kernel along ``fwht_plan(n)``: one
    launch up to n = 2^18 (one pass, then a cluster), and
    ``len(fwht_passes(n))`` passes past it (a bfloat16 row then keeps a
    float32 intermediate, rounded once at the end); CPU tensors through
    the plain version.  A launch the card refuses raises.
    """
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, n) tensor, got {tuple(x.shape)}")
    rows, n = x.shape
    _check_length(n)
    if x.device.type == "cpu":
        return fwht_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"FWHT kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("FWHT kernel needs a contiguous tensor")
    out = torch.empty_like(x)
    plan = fwht_plan(n)
    if rows and plan.route == "cluster":
        dt = _DTYPES[x.dtype]
        check(load_library().repro_fwht_cluster(
            x.data_ptr(), out.data_ptr(), rows, n, plan.C, dt, dt,
            stream_of(x)), "fwht")
        launches["fwht"] += 1
    elif rows:
        lib = load_library()
        dt = _DTYPES[x.dtype]
        (seg, _), *later = fwht_passes(n)
        # the passes' float32 rows: the output itself, or for bfloat16 a
        # scratch that the last pass reads and rounds into the output
        work = out if not later or dt == 0 else torch.empty(
            (rows, n), dtype=torch.float32, device=x.device)
        check(lib.repro_fwht(x.data_ptr(), work.data_ptr(), rows * (n // seg),
                             seg, dt, _DTYPES[work.dtype], stream_of(x)),
              "fwht")
        for j, (L, S) in enumerate(later):
            strided_pass(lib, work, out if j == len(later) - 1 else work, n,
                         L, S, 0, n, 1.0)
        launches["fwht"] += 1
    return out
