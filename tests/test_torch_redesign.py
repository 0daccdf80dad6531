"""The shape choices of the redesigned fused-gradient and combine kernels,
the wrappers' checks of what the kernels take, and the plain versions
(the path CPU tensors take) against the JAX package's Pallas kernels in
interpret mode on the masks that the tiles of realizations must handle.

The kernels themselves run only on the card (tests/test_torch_gpu.py holds
each against these choices and its plain version).  Inputs are drawn from
a seed with numpy and handed to both packages.  Tolerances: rel 1e-5 of
max|ref| in float32 (the same sums in another order by XLA's fusion).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coded_reduce import coded_combine_call as j_combine
from repro.kernels.fused_step import fused_masked_gradient as j_fused
from repro.kernels.ref import coded_combine_ref as j_combine_ref
from repro_torch.kernels import coded_reduce, fused_step
from repro_torch.kernels.coded_reduce import (coded_combine_call,
                                              combine_row_groups)
from repro_torch.kernels.fused_step import (MAX_COLS, SMEM_BUDGET,
                                            fused_masked_gradient,
                                            fused_masked_gradient_plain,
                                            fused_row_registers,
                                            fused_stage1_smem_bytes,
                                            pick_fused_realization_tile)

F32_TOL = 1e-5


def _close(out, ref, tol):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(np.max(np.abs(ref)), 1e-30)


# ---------------------------------------------------------------------------
# Realization tile of the fused kernel's first stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,want", [(1, 8), (37, 8), (4096, 8), (4097, 4),
                                    (6000, 4), (6001, 4), (8192, 4),
                                    (8193, 2), (12288, 2), (12289, 1),
                                    (16384, 1)])
def test_realization_tile_by_width(p, want):
    assert pick_fused_realization_tile(p) == want


def test_realization_tile_fits_registers_and_shared_memory():
    """For every p <= 16384: NE (1 + RT) <= 200 registers, and the tile's
    iterates with two row buffers fit shared memory in both dtypes."""
    prev = 8
    for p in range(1, MAX_COLS + 1):
        rt = pick_fused_realization_tile(p)
        ne = fused_row_registers(p)
        assert rt in (1, 2, 4, 8) and rt <= prev
        assert ne * 256 >= p and ne * (1 + rt) <= 200
        for itemsize in (4, 2):              # float32, bfloat16 rows
            assert fused_stage1_smem_bytes(p, rt, itemsize) <= SMEM_BUDGET
        prev = rt


def test_realization_tile_is_a_function_of_p_alone():
    """The same p always gives the same tile, and the kernel entry takes no
    other input for it: a realization's sums never depend on R."""
    widths = np.random.default_rng(0).integers(1, MAX_COLS + 1, 64)
    first = [pick_fused_realization_tile(int(p)) for p in widths]
    again = [pick_fused_realization_tile(int(p)) for p in widths[::-1]]
    assert first == again[::-1]


@pytest.mark.parametrize("p,want", [(1, 1), (256, 1), (257, 2), (2049, 16),
                                    (6000, 24), (6144, 24), (6145, 32),
                                    (16384, 64)])
def test_row_registers(p, want):
    assert fused_row_registers(p) == want


@pytest.mark.parametrize("p", [0, MAX_COLS + 1])
def test_row_registers_reject_out_of_range(p):
    with pytest.raises(ValueError):
        fused_row_registers(p)


# ---------------------------------------------------------------------------
# Row groups of the combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,want", [(0, 1), (1, 1), (2, 2), (3, 4), (4, 4),
                                    (5, 8), (7, 8), (8, 8), (9, 8), (32, 8),
                                    (64, 8), (200, 8)])
def test_combine_row_groups(m, want):
    assert combine_row_groups(m) == want


# ---------------------------------------------------------------------------
# What the kernels do not take (the checks the CUDA path runs first)
# ---------------------------------------------------------------------------

def _fused_operands(m, r, p, R, seed=0):
    rng = np.random.default_rng(seed)
    SX = rng.standard_normal((m, r, p)).astype(np.float32)
    Sy = rng.standard_normal((m, r)).astype(np.float32)
    W = (0.1 * rng.standard_normal((R, p))).astype(np.float32)
    masks = (rng.random((R, m)) < 0.7).astype(np.float32)
    return SX, Sy, W, masks


def _t(*arrs):
    return [torch.tensor(a) for a in arrs]


def test_fused_kernel_rejects_rows_wider_than_registers():
    """Rows wider than the one-read form's registers (p > MAX_COLS) have no
    register count of their own: they take the column-split form, whose
    operands the card's check accepts and whose scratch unit is the
    largest divisor of r up to 64 rows (one float32 p-row a unit on the
    cluster route that p = MAX_COLS + 1 takes)."""
    SX, Sy, W, masks = _t(*_fused_operands(2, 2, MAX_COLS + 1, 1))
    with pytest.raises(ValueError):
        fused_row_registers(MAX_COLS + 1)
    fused_step._check_kernel_operands(SX, Sy, W, masks)
    assert fused_step.pick_wide_block_rows(2) == 2
    assert fused_step.wide_plan(MAX_COLS + 1, 4).route == "cluster"
    assert fused_step.fused_wide_scratch_bytes(2, 2, MAX_COLS + 1) == \
        4 * 2 * (MAX_COLS + 1)


@pytest.mark.parametrize("which", ["Sy", "w", "all64"])
def test_fused_kernel_rejects_mixed_or_unsupported_dtypes(which):
    SX, Sy, W, masks = _t(*_fused_operands(3, 4, 16, 2))
    if which == "Sy":
        Sy = Sy.bfloat16()
    elif which == "w":
        W = W.bfloat16()
    else:
        SX, Sy, W = SX.double(), Sy.double(), W.double()
    with pytest.raises(TypeError):
        fused_step._check_kernel_operands(SX, Sy, W, masks)


def test_fused_kernel_rejects_non_float32_masks():
    SX, Sy, W, masks = _t(*_fused_operands(3, 4, 16, 2))
    with pytest.raises(TypeError):
        fused_step._check_kernel_operands(SX, Sy, W, masks.double())


@pytest.mark.parametrize("which", ["SX", "Sy", "w", "mask"])
def test_fused_kernel_rejects_non_contiguous(which):
    SX, Sy, W, masks = _t(*_fused_operands(3, 4, 16, 2))
    ops = {"SX": SX, "Sy": Sy, "w": W, "mask": masks}
    t = ops[which]
    ops[which] = t.t().contiguous().t() if t.dim() == 2 else \
        t.transpose(1, 2).contiguous().transpose(1, 2)
    assert not ops[which].is_contiguous()
    with pytest.raises(ValueError, match=which):
        fused_step._check_kernel_operands(ops["SX"], ops["Sy"], ops["w"],
                                          ops["mask"])


def test_fused_kernel_accepts_what_it_takes():
    SX, Sy, W, masks = _t(*_fused_operands(3, 4, MAX_COLS, 2))
    fused_step._check_kernel_operands(SX, Sy, W, masks)
    fused_step._check_kernel_operands(SX.bfloat16(), Sy.bfloat16(),
                                      W.bfloat16(), masks)


def test_fused_rejects_devices_without_a_kernel():
    SX, Sy, W, masks = (t.to("meta")
                        for t in _t(*_fused_operands(3, 4, 16, 2)))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_masked_gradient(SX, Sy, W, masks, n=6, beta=2.0)


def test_combine_kernel_rejects_unsupported_dtype_and_layout():
    g, c = torch.zeros((4, 10)), torch.ones(4)
    with pytest.raises(TypeError):
        coded_reduce._check_kernel_operands(g.double(), c)
    with pytest.raises(ValueError, match="contiguous"):
        coded_reduce._check_kernel_operands(torch.zeros((10, 4)).t(), c)
    coded_reduce._check_kernel_operands(g, c)
    coded_reduce._check_kernel_operands(g.bfloat16(), c)
    with pytest.raises(ValueError, match="unsupported device"):
        coded_combine_call(g.to("meta"), c.to("meta"))


# ---------------------------------------------------------------------------
# Plain versions against the JAX package on the tiles' masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 3, 4, 5, 9])
@pytest.mark.parametrize("p", [37, 63])          # the existing odd widths
def test_fused_plain_matches_pallas_on_tile_masks(R, p):
    """Worker 1 masked out in every realization and, for R > 1, the last
    realization all-masked: each row matches the Pallas kernel, the
    all-masked row is exactly 0, and every row equals its single call.
    (The tolerance is relative to a row's largest entry, so a row needs
    several entries: one lone entry can be a sum that cancels.)"""
    SX, Sy, W, masks = _fused_operands(4, 6, p, R, seed=R * 100 + p)
    masks[:, 1] = 0.0
    if R > 1:
        masks[-1] = 0.0
    out = fused_masked_gradient(*_t(SX, Sy, W, masks), n=12, beta=2.0)
    assert out.shape == (R, p)
    for q in range(R):
        ref = j_fused(*(jnp.asarray(a) for a in (SX, Sy, W[q], masks[q])),
                      n=12, beta=2.0, interpret=True)
        _close(out[q].numpy(), np.asarray(ref), F32_TOL)
        single = fused_masked_gradient(*_t(SX, Sy, W[q], masks[q]), n=12,
                                       beta=2.0)
        assert torch.equal(out[q], single)
    if R > 1:
        assert torch.count_nonzero(out[-1]) == 0


def test_fused_plain_batched_equals_its_rows():
    SX, Sy, W, masks = _t(*_fused_operands(5, 8, 40, 16, seed=4))
    full = fused_masked_gradient_plain(SX, Sy, W, masks, n=20, beta=2.0)
    for lo in range(0, 16, 4):
        part = fused_masked_gradient_plain(SX, Sy, W[lo:lo + 4],
                                           masks[lo:lo + 4], n=20, beta=2.0)
        assert torch.equal(full[lo:lo + 4], part)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 32, 64, 200])
def test_combine_plain_matches_reference_over_row_groups(m):
    """The m of every row-group case; the Pallas combine takes m <= 32, the
    reference's einsum any m.  (m,) and (m, 1) weights equal bit for bit."""
    rng = np.random.default_rng(m)
    g = rng.standard_normal((m, 2085)).astype(np.float32)
    c = rng.uniform(size=m).astype(np.float32)
    out = coded_combine_call(torch.tensor(g), torch.tensor(c))
    _close(out, j_combine_ref(jnp.asarray(g), jnp.asarray(c)), F32_TOL)
    if m <= 32:
        _close(out, j_combine(jnp.asarray(g), jnp.asarray(c), block=2048,
                              interpret=True), F32_TOL)
    assert torch.equal(out, coded_combine_call(torch.tensor(g),
                                               torch.tensor(c)[:, None]))
