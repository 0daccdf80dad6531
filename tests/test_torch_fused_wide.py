"""The fused gradient's column-split form (p > MAX_COLS) as the CPU can see
it: the plan that ``csrc/fused_wide.cu`` follows (``wide_plan``, its
mirror) for every width from 16 385 to 2^20 in float32 and bfloat16, and
the wrapper's results past one block's registers against the JAX
package's fused gradient, on both routes.

The plan's properties: on the cluster route the C = 8 CTAs' slices tile
[0, p) exactly, every boundary a multiple of 16 bytes and the last slice
non-empty; a thread's vectors cover its slice; the ring of at least three
slices stays within SMEM_BUDGET; the realization tile keeps its iterates
and sums within the register budget; and the route, the slices and the
tile depend on p and the dtype alone (the plan takes no R).  The two-read
route takes exactly the widths whose slice no listed vector count holds or
whose three slices do not fit.  Tolerances: the gradients rel 1e-4 of the
reference's largest magnitude (float32 dot products of p terms summed in
another order); the plans exactly.
"""
import inspect

import numpy as np
import pytest
import torch

from repro.kernels.fused_step import fused_masked_gradient as j_fused
from repro_torch.kernels.fused_step import (MAX_COLS, SMEM_BUDGET,
                                            WIDE_CLUSTER,
                                            fused_masked_gradient,
                                            fused_wide_scratch_bytes,
                                            wide_plan)

# the cluster route's constants (csrc/fused_wide.cu)
THREADS, VEC, REG_BUDGET, MIN_SLOTS, MAX_SLOTS = 256, 4, 208, 3, 8
VECTORS = (3, 4, 6, 8, 10, 13, 16, 19)
# the widest p each dtype's cluster route takes
CAPACITY = {4: 152896, 2: 155648}
TOP = 1 << 20
CHUNKS = 8


def _check_plan(p, itemsize):
    plan = wide_plan(p, itemsize)
    align = 16 // itemsize
    S = -(-(-(-p // WIDE_CLUSTER)) // align) * align
    if plan.route == "two-read":
        # only where no cluster plan fits: no listed NV holds the slice,
        # or fewer than three slices fit one CTA's shared memory
        assert -(-S // (VEC * THREADS)) > VECTORS[-1] or \
            MIN_SLOTS * S * itemsize > SMEM_BUDGET
        assert p > CAPACITY[itemsize]
        return
    assert p <= CAPACITY[itemsize]
    assert plan.route == "cluster" and plan.C == WIDE_CLUSTER
    S, C = plan.slice_cols, plan.C
    # the slices tile [0, p): boundaries c S, 16-byte aligned, the last
    # slice non-empty and no wider than the others
    assert (S * itemsize) % 16 == 0
    last = p - (C - 1) * S
    assert 0 < last <= S
    # a thread's NV vectors of 4 columns cover its slice, NV the least
    # listed count that does
    assert plan.vectors in VECTORS and plan.vectors * VEC * THREADS >= S
    smaller = [v for v in VECTORS if v < plan.vectors]
    assert not smaller or smaller[-1] * VEC * THREADS < S
    # the ring (a CTA's dynamic shared memory, as the launcher sizes it):
    # at least three slices, at most eight, within the budget
    assert MIN_SLOTS <= plan.slots <= MAX_SLOTS
    assert plan.slots * S * itemsize <= SMEM_BUDGET
    assert plan.slots == MAX_SLOTS or \
        (plan.slots + 1) * S * itemsize > SMEM_BUDGET
    # the tile: the largest of 4, 2, 1 whose iterates and sums fit
    assert plan.tile in (4, 2, 1)
    assert 2 * VEC * plan.vectors * plan.tile <= REG_BUDGET or plan.tile == 1
    assert plan.tile == 4 or \
        2 * VEC * plan.vectors * plan.tile * 2 > REG_BUDGET
    assert plan.threads == THREADS


@pytest.mark.parametrize("chunk", range(CHUNKS))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_wide_plan_every_width(itemsize, chunk):
    """Every p from MAX_COLS + 1 to 2^20, split in CHUNKS ranges."""
    lo = MAX_COLS + 1
    step = -(-(TOP + 1 - lo) // CHUNKS)
    for p in range(lo + chunk * step, min(TOP + 1, lo + (chunk + 1) * step)):
        _check_plan(p, itemsize)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_wide_slices_tile_the_row(itemsize):
    """The slices the kernel's CTAs take, [c S, (c + 1) S) and the last to
    p: contiguous, 16-byte-aligned starts, covering [0, p) once."""
    for p in (MAX_COLS + 1, 16387, 20000, 100000, CAPACITY[itemsize]):
        plan = wide_plan(p, itemsize)
        S = plan.slice_cols
        sl = [(c * S, p if c == plan.C - 1 else (c + 1) * S)
              for c in range(plan.C)]
        assert len(sl) == WIDE_CLUSTER and sl[0][0] == 0 and sl[-1][1] == p
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
        assert all(lo * itemsize % 16 == 0 and hi > lo for lo, hi in sl)
    assert wide_plan(CAPACITY[itemsize] + 1, itemsize).route == "two-read"


def test_wide_plan_takes_no_realization_count():
    """The plan is a function of p and the dtype only: no R enters it, so
    C, the slices and the tile are the same for a single call and for any
    batch, and a batched row equals a single call bit for bit."""
    assert list(inspect.signature(wide_plan).parameters) == ["p", "itemsize"]
    assert wide_plan(100000, 4) == wide_plan(100000, 4)


@pytest.mark.parametrize("p,itemsize,want", [
    (16385, 4, ("cluster", 2052, 3, 4, 8)),
    (16385, 2, ("cluster", 2056, 3, 4, 8)),
    (100000, 4, ("cluster", 12500, 13, 2, 4)),
    (100000, 2, ("cluster", 12504, 13, 2, 8)),
    (152896, 4, ("cluster", 19112, 19, 1, 3)),
    (152897, 4, ("two-read", 0, 0, 4, 0)),
    (155648, 2, ("cluster", 19456, 19, 1, 5)),
    (155649, 2, ("two-read", 0, 0, 4, 0)),
])
def test_wide_plan_at_named_widths(p, itemsize, want):
    """The path's width (LASSO §5.4, p = 100 000: 12 500 columns a CTA,
    50 000 bytes a float32 slice, a ring of four) and the edges."""
    plan = wide_plan(p, itemsize)
    assert (plan.route, plan.slice_cols, plan.vectors, plan.tile,
            plan.slots) == want


@pytest.mark.parametrize("p", [0, MAX_COLS])
def test_wide_plan_rejects_widths_of_the_first_form(p):
    with pytest.raises(ValueError):
        wide_plan(p, 4)


def test_wide_scratch_by_route():
    """The cluster route's scratch is one float32 p-row a unit; the
    two-read route adds the rows' chunk sums."""
    m, r = 3, 130                             # units of 26 rows
    p = 100000
    assert fused_wide_scratch_bytes(m, r, p) == 4 * m * 5 * p
    p = CAPACITY[4] + 1
    assert fused_wide_scratch_bytes(m, r, p) == \
        4 * (m * 5 * p + m * r * -(-p // 4096))
    assert fused_wide_scratch_bytes(m, r, p, itemsize=2) == 4 * m * 5 * p


@pytest.mark.parametrize("p", [MAX_COLS + 1, CAPACITY[4] + 1])
def test_wide_gradient_on_each_route_matches_reference(p):
    """Through the wrapper on the CPU (the card's plain version) against
    the JAX package's fused gradient, at a width of each route, batched
    over 3 realizations with one all-masked."""
    m, r, R = 3, 2, 3
    rng = np.random.default_rng(p)
    SX = rng.standard_normal((m, r, p)).astype(np.float32)
    Sy = rng.standard_normal((m, r)).astype(np.float32)
    W = (0.01 * rng.standard_normal((R, p))).astype(np.float32)
    masks = np.array([[1, 0, 1], [1, 1, 1], [0, 0, 0]], np.float32)
    out = fused_masked_gradient(torch.as_tensor(SX), torch.as_tensor(Sy),
                                torch.as_tensor(W), torch.as_tensor(masks),
                                n=4, beta=2.0).numpy()
    for q in range(R):
        ref = np.asarray(j_fused(SX, Sy, W[q], masks[q], n=4, beta=2.0))
        assert np.max(np.abs(out[q] - ref)) <= \
            1e-4 * max(np.max(np.abs(ref)), 1e-30)
    assert not out[2].any()
