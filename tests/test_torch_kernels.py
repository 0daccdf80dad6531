"""The port's kernels (plain PyTorch versions, the path CPU tensors take)
against the JAX package's Pallas kernels run in interpret mode.

Inputs are drawn from a seed with numpy and handed to both packages.
Tolerances: in float32 the plain versions repeat the reference's operation
order up to XLA's fusion, so they agree to a few float32 ulps of the
largest value (rtol 1e-5 of max|ref|); bfloat16 outputs may round one
bfloat16 ulp apart (2^-7 of max|ref|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.encoding import hadamard_matrix
from repro.kernels import ops as jops
from repro.kernels.encode import srht_encode_call as j_srht
from repro.kernels.fused_step import fused_masked_gradient as j_fused
from repro.kernels.fwht import fwht_kernel_call as j_fwht
from repro_torch.core import (EncodedProblem, masked_gradient,
                              original_objective)
from repro_torch.device import full_f32_matmul
from repro_torch.kernels import ops
from repro_torch.kernels._build import launches
from repro_torch.kernels.encode import srht_encode_call, srht_encode_plain
from repro_torch.kernels.fused_step import (fused_masked_gradient,
                                            fused_masked_gradient_plain,
                                            pick_fused_block_rows)
from repro_torch.kernels.fwht import fwht_kernel_call
from repro_torch.kernels.ref import (fused_masked_gradient_ref,
                                     fwht_matrix_ref, fwht_ref)

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _close(out, ref, tol):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(np.max(np.abs(ref)), 1e-30)


def _bf16_pair(a):
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


# ---------------------------------------------------------------------------
# FWHT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("n", [128, 256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwht_matches_pallas(rows, n, dtype):
    x = np.random.default_rng(rows * n).standard_normal((rows, n))
    x = x.astype(np.float32)
    if dtype == "float32":
        jx, tx, tol = jnp.asarray(x), torch.tensor(x), F32_TOL
    else:
        (jx, tx), tol = _bf16_pair(x), BF16_TOL
    ref = j_fwht(jx, interpret=True)
    out = fwht_kernel_call(tx)
    assert out.dtype == tx.dtype and out.shape == (rows, n)
    _close(out.float().numpy(), np.asarray(ref, np.float32), tol)


def test_fwht_vs_dense_matrix():
    x = torch.tensor(np.random.default_rng(1).standard_normal((4, 128)),
                     dtype=torch.float32)
    _close(fwht_kernel_call(x).numpy(), fwht_matrix_ref(x).numpy(), F32_TOL)
    _close(fwht_ref(x).numpy(), fwht_matrix_ref(x).numpy(), F32_TOL)


@pytest.mark.parametrize("logn", [0, 1, 3, 6, 9])
def test_fwht_involution(logn):
    """H (H x) = n x — the defining FWHT property."""
    n = 1 << logn
    x = torch.tensor(np.random.default_rng(logn).standard_normal((2, n)),
                     dtype=torch.float32)
    _close(fwht_kernel_call(fwht_kernel_call(x)).numpy(), n * x.numpy(),
           F32_TOL)


def test_fwht_linearity():
    rng = np.random.default_rng(5)
    a, b = (torch.tensor(rng.standard_normal((3, 128)), dtype=torch.float32)
            for _ in range(2))
    _close(fwht_kernel_call(a + 2.0 * b).numpy(),
           (fwht_kernel_call(a) + 2.0 * fwht_kernel_call(b)).numpy(), F32_TOL)


@pytest.mark.parametrize("n", [100, 3, 0])
def test_fwht_rejects_non_pow2(n):
    with pytest.raises(ValueError):
        fwht_kernel_call(torch.ones((4, n)))
    with pytest.raises(ValueError):
        ops.fwht(torch.ones((n, 4)), axis=0)


def test_fwht_axis_wrapper_matches_reference():
    x = np.random.default_rng(3).standard_normal((128, 5)).astype(np.float32)
    ref = jops.fwht(jnp.asarray(x), axis=0)
    out = ops.fwht(torch.tensor(x), axis=0)
    _close(out.numpy(), np.asarray(ref), F32_TOL)


# ---------------------------------------------------------------------------
# SRHT encode
# ---------------------------------------------------------------------------

def _srht_operands(n=48, p=7, N=128, seed=0):
    rng = np.random.default_rng(seed)
    cols = rng.choice(N, size=n, replace=False)
    signs = rng.choice([-1.0, 1.0], size=n)
    X = rng.standard_normal((n, p)).astype(np.float32)
    return X, cols, signs


@pytest.mark.parametrize("lo,hi", [(0, 128), (32, 64), (5, 6), (100, 128)])
def test_srht_matches_pallas(lo, hi):
    n, N = 48, 128
    X, cols, signs = _srht_operands(n=n, N=N)
    # the reference kernel takes the data already scattered into N slots
    xt = np.zeros((X.shape[1], N), np.float32)
    xt[:, cols] = X.T
    dsigns = np.zeros((1, N), np.float32)
    dsigns[0, cols] = signs
    scale = 1.0 / np.sqrt(n)
    ref = j_srht(jnp.asarray(xt), jnp.asarray(dsigns), lo=lo, hi=hi,
                 scale=scale, interpret=True)
    out = srht_encode_call(torch.tensor(X.T.copy()),
                           torch.tensor(cols.astype(np.int32)),
                           torch.tensor(signs.astype(np.float32)), N=N,
                           lo=lo, hi=hi, scale=scale)
    assert out.shape == (X.shape[1], hi - lo)
    _close(out.numpy(), np.asarray(ref), F32_TOL)


def test_hadamard_encode_matches_dense_and_reference():
    n, p, N = 64, 8, 128
    X, cols, signs = _srht_operands(n=n, p=p, N=N, seed=1)
    S = hadamard_matrix(N)[:, cols] * signs[None, :] / np.sqrt(n)
    out = ops.hadamard_encode(torch.tensor(X), cols, signs, N=N)
    ref = jops.hadamard_encode(jnp.asarray(X), cols, signs, N=N)
    _close(out.numpy(), S @ X, F32_TOL)
    _close(out.numpy(), np.asarray(ref), F32_TOL)


def test_srht_rejects_bad_arguments():
    X, cols, signs = _srht_operands()
    xt = torch.tensor(X.T.copy())
    c = torch.tensor(cols.astype(np.int32))
    s = torch.tensor(signs.astype(np.float32))
    with pytest.raises(ValueError):
        srht_encode_call(xt, c, s, N=100, lo=0, hi=100, scale=1.0)
    with pytest.raises(ValueError):
        srht_encode_call(xt, c, s, N=128, lo=64, hi=64, scale=1.0)
    with pytest.raises(ValueError):
        srht_encode_call(xt, c[:-1], s, N=128, lo=0, hi=128, scale=1.0)
    with pytest.raises(ValueError):      # cols outside the transform
        ops.srht_encode(torch.tensor(X), cols + 200, signs, 128)


def test_srht_plain_equals_wrapper_on_cpu():
    X, cols, signs = _srht_operands(seed=4)
    args = (torch.tensor(X.T.copy()), torch.tensor(cols.astype(np.int32)),
            torch.tensor(signs.astype(np.float32)))
    kw = dict(N=128, lo=3, hi=77, scale=0.5)
    assert torch.equal(srht_encode_call(*args, **kw),
                       srht_encode_plain(*args, **kw))


# ---------------------------------------------------------------------------
# Fused masked gradient
# ---------------------------------------------------------------------------

def _fused_operands(m, r, p, seed=0, R=None):
    rng = np.random.default_rng(seed)
    SX = rng.standard_normal((m, r, p)).astype(np.float32)
    Sy = rng.standard_normal((m, r)).astype(np.float32)
    shape = (p,) if R is None else (R, p)
    w = rng.standard_normal(shape).astype(np.float32)
    mshape = (m,) if R is None else (R, m)
    mask = (rng.random(mshape) < 0.7).astype(np.float32)
    return SX, Sy, w, mask


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.tensor(a) for a in arrs]


@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("p", [37, 63])          # odd p: no alignment
def test_fused_matches_pallas_odd_p(m, p):
    SX, Sy, w, mask = _fused_operands(m, 8, p)
    n = m * 8 // 2
    ref = j_fused(*_j(SX, Sy, w, mask), n=n, beta=2.0, interpret=True)
    out = fused_masked_gradient(*_t(SX, Sy, w, mask), n=n, beta=2.0)
    assert out.shape == (p,) and out.dtype == torch.float32
    _close(out.numpy(), np.asarray(ref), F32_TOL)
    _close(fused_masked_gradient_ref(*_t(SX, Sy, w, mask), n=n,
                                     beta=2.0).numpy(), np.asarray(ref),
           F32_TOL)


def test_fused_bf16():
    SX, Sy, w, mask = _fused_operands(8, 16, 64)
    ref = j_fused(*(jnp.asarray(a, jnp.bfloat16) for a in (SX, Sy, w)),
                  jnp.asarray(mask), n=64, beta=2.0, interpret=True)
    out = fused_masked_gradient(*(torch.tensor(a).bfloat16()
                                  for a in (SX, Sy, w)),
                                torch.tensor(mask), n=64, beta=2.0)
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), np.asarray(ref, np.float32), BF16_TOL)


def test_fused_all_masked_is_exact_zero():
    SX, Sy, w, _ = _fused_operands(4, 8, 16)
    out = fused_masked_gradient(*_t(SX, Sy, w), torch.zeros(4), n=16,
                                beta=2.0)
    assert torch.count_nonzero(out) == 0
    ref = j_fused(*_j(SX, Sy, w), jnp.zeros(4), n=16, beta=2.0,
                  interpret=True)
    assert np.all(np.asarray(ref) == 0)


def test_fused_batched_matches_pallas_rows_and_single_bitwise():
    R = 5
    SX, Sy, W, masks = _fused_operands(6, 12, 40, seed=2, R=R)
    out = fused_masked_gradient(*_t(SX, Sy, W, masks), n=36, beta=2.0)
    assert out.shape == (R, 40)
    for q in range(R):
        ref = j_fused(*_j(SX, Sy, W[q], masks[q]), n=36, beta=2.0,
                      interpret=True)
        _close(out[q].numpy(), np.asarray(ref), F32_TOL)
        single = fused_masked_gradient(*_t(SX, Sy, W[q], masks[q]), n=36,
                                       beta=2.0)
        assert torch.equal(out[q], single)


@pytest.mark.parametrize("r", [1, 7, 34, 96])
def test_fused_matches_pallas_row_counts(r):
    """Per-worker row counts whose stage-1 row blocks differ (r, 7, 2, 16)."""
    SX, Sy, w, mask = _fused_operands(4, r, 24, seed=r)
    n = 2 * r
    ref = j_fused(*_j(SX, Sy, w, mask), n=n, beta=2.0, interpret=True)
    out = fused_masked_gradient(*_t(SX, Sy, w, mask), n=n, beta=2.0)
    _close(out.numpy(), np.asarray(ref), F32_TOL)


@pytest.mark.parametrize("prev", [True, False])
def test_products_leave_tf32_setting_as_found(prev):
    """The plain products run in full float32 and restore the caller's
    TF32 setting, whatever it was."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = prev
    try:
        inside = full_f32_matmul(lambda: matmul.allow_tf32)()
        assert inside is False and matmul.allow_tf32 is prev
        SX, Sy, w, mask = _t(*_fused_operands(4, 8, 16))
        prob = EncodedProblem(SX=SX, Sy=Sy, X=SX[0], y=Sy[0], lam=0.1,
                              beta=2.0, n=8)
        original_objective(prob, w)
        masked_gradient(prob, w, mask)
        fused_masked_gradient_plain(SX, Sy, w[None], mask[None], n=16,
                                    beta=2.0)
        fused_masked_gradient_ref(SX, Sy, w, mask, n=16, beta=2.0)
        assert matmul.allow_tf32 is prev
    finally:
        matmul.allow_tf32 = saved


def test_fused_rejects_bad_shapes_and_block_rows():
    SX, Sy, w, mask = _t(*_fused_operands(4, 12, 40))
    with pytest.raises(ValueError):
        fused_masked_gradient(SX, Sy[:, :-1], w, mask, n=24, beta=2.0)
    with pytest.raises(ValueError):
        fused_masked_gradient(SX, Sy, w[:-1], mask, n=24, beta=2.0)


@pytest.mark.parametrize("r,want", [(256, 16), (12, 12), (7, 7), (96, 16),
                                    (34, 2), (4096, 16)])
def test_pick_fused_block_rows(r, want):
    br = pick_fused_block_rows(r)
    assert br == want and r % br == 0


def test_cpu_tensors_never_count_as_kernel_launches():
    before = dict(launches)
    SX, Sy, w, mask = _t(*_fused_operands(4, 8, 16))
    fused_masked_gradient(SX, Sy, w, mask, n=16, beta=2.0)
    fwht_kernel_call(torch.ones((2, 8)))
    ops.hadamard_encode(torch.ones((4, 3)), np.arange(4), np.ones(4), N=8)
    assert dict(launches) == before


def test_plain_batched_rows_do_not_depend_on_batch():
    SX, Sy, W, masks = _t(*_fused_operands(5, 8, 33, seed=7, R=6))
    full = fused_masked_gradient_plain(SX, Sy, W, masks, n=20, beta=2.0)
    part = fused_masked_gradient_plain(SX, Sy, W[2:4], masks[2:4], n=20,
                                       beta=2.0)
    assert torch.equal(full[2:4], part)
