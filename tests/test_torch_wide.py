"""The port past its kernels' one-pass widths, against the JAX package, on
the CPU: the fast-Hadamard encoder at N = 65 536 (a thread-block cluster
on the card), coded GD / ISTA at p = 16 385 (the fused gradient's
column-split form on the card), the multi-pass plans the card's wrappers
follow (the FWHT split and the SRHT's signed slot map, against numpy),
and the fast-Hadamard ``make_encoded_problem`` that builds the worker
blocks with one copy.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the encoder's outputs rel 1e-5 of the reference's largest
magnitude (float32 butterflies; the two agree exactly today); the
strategies' objective traces rel 1e-4 (float32 sums of 16 385 terms in
another order, over 12 steps); the plans and the encoded blocks exactly.
"""
import math

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime as jrt
import repro_torch.core as tcore
import repro_torch.runtime as trt
from repro_torch.kernels.encode import (CHUNK_BYTES, srht_chunk_rows,
                                        srht_operands)
from repro_torch.kernels.fused_step import (MAX_COLS, fused_wide_scratch_bytes,
                                            pick_wide_block_rows, wide_plan)
from repro_torch.kernels.fwht import MAX_ONE_PASS, MAX_STRIDED, fwht_passes

RTOL, TRACE_RTOL = 1e-5, 1e-4


def _rel_close(out, ref, rtol):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


# ---------------------------------------------------------------------------
# the fast-Hadamard encoder at N = 65 536
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hadamard_wide():
    n = 20000
    X = np.random.default_rng(0).standard_normal((n, 3))
    je = jcore.FastHadamardEncoder(n, 2.0, seed=0)
    te = tcore.FastHadamardEncoder(n, 2.0, seed=0, device="cpu")
    assert je.N == te.N == 65536
    E = np.asarray(je.encode(X))
    return X, je, te, E


def test_fast_hadamard_encode_past_one_pass_matches_reference(hadamard_wide):
    X, _, te, E = hadamard_wide
    _rel_close(te.encode(X).numpy(), E, RTOL)


def test_fast_hadamard_decode_t_past_one_pass_matches_reference(
        hadamard_wide):
    X, je, te, E = hadamard_wide
    D = te.decode_t(torch.tensor(E))
    _rel_close(D.numpy(), np.asarray(je.decode_t(E)), RTOL)
    # S^T S = beta I: decode_t(encode(x)) = beta x
    _rel_close(D.numpy(), te.beta * X, RTOL)


# ---------------------------------------------------------------------------
# coded GD / ISTA one column past the one-read fused form
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide_data():
    rng = np.random.default_rng(1)
    n, p = 64, MAX_COLS + 1
    X = rng.standard_normal((n, p))
    w = np.zeros(p)
    w[rng.choice(p, 40, replace=False)] = rng.standard_normal(40)
    y = X @ w + 0.1 * rng.standard_normal(n)
    return X, y


@pytest.mark.parametrize("encoder", ["hadamard", "fast-hadamard"])
@pytest.mark.parametrize("strategy,h", [("coded-gd", "l2"),
                                        ("coded-prox", "l1")])
def test_strategy_past_max_cols_matches_reference(wide_data, strategy, h,
                                                  encoder):
    X, y = wide_data
    kw = dict(steps=12, k=3, encoder=encoder, step_size=2e-5)
    ref = jrt.get_strategy(strategy).run(
        jrt.ProblemSpec(X=X, y=y, lam=0.05, h=h),
        jrt.ClusterEngine(jcore.bimodal_delays(), 4, seed=0), **kw)
    out = trt.get_strategy(strategy).run(
        trt.ProblemSpec(X=X, y=y, lam=0.05, h=h),
        trt.ClusterEngine(tcore.bimodal_delays(), 4, seed=0), device="cpu",
        **kw)
    assert np.array_equal(out.times, np.asarray(ref.times))
    tr = np.asarray(out.objective)
    assert tr[-1] < tr[0]
    _rel_close(tr, np.asarray(ref.objective), TRACE_RTOL)


# ---------------------------------------------------------------------------
# the multi-pass plans, against numpy
# ---------------------------------------------------------------------------

def _sylvester(n):
    H = np.ones((1, 1))
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


def _fwht_np(v, axis):
    """Unnormalised Walsh-Hadamard transform of v along ``axis`` (numpy
    butterflies, Sylvester order)."""
    v = np.moveaxis(v, axis, -1)
    lead, n = v.shape[:-1], v.shape[-1]
    h = 1
    while h < n:
        y = v.reshape(lead + (n // (2 * h), 2, h))
        v = np.stack([y[..., 0, :] + y[..., 1, :],
                      y[..., 0, :] - y[..., 1, :]], -2).reshape(lead + (n,))
        h *= 2
    return np.moveaxis(v, -1, axis)


def _apply_passes(x, passes):
    """Each (L, S) of ``passes`` in numpy: the rows viewed as
    (n / (L S), L, S), H_L along the middle axis."""
    rows, n = x.shape
    for L, S in passes:
        x = _fwht_np(x.reshape(rows, n // (L * S), L, S), 2).reshape(rows, n)
    return x


@pytest.mark.parametrize("n", [1, 8, 4096, MAX_ONE_PASS, 2 * MAX_ONE_PASS,
                               1 << 20])
def test_fwht_split_plans_the_whole_transform(n):
    passes = fwht_passes(n)
    assert passes[0] == (min(n, MAX_ONE_PASS), 1)
    stride = passes[0][0]
    for L, S in passes[1:]:
        assert S == stride and 2 <= L <= MAX_STRIDED
        stride *= L
    assert stride == n
    x = np.random.default_rng(n).standard_normal((2, n))
    ref = _fwht_np(x, 1)
    if n <= 4096:
        np.testing.assert_allclose(ref, x @ _sylvester(n).T, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())
    np.testing.assert_allclose(_apply_passes(x, passes), ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())


def test_fwht_split_takes_three_passes_past_one_strided_pass():
    n = MAX_ONE_PASS * MAX_STRIDED * 2
    assert fwht_passes(n) == [(MAX_ONE_PASS, 1),
                              (MAX_STRIDED, MAX_ONE_PASS),
                              (2, MAX_ONE_PASS * MAX_STRIDED)]
    with pytest.raises(ValueError):
        fwht_passes(3 * MAX_ONE_PASS)


@pytest.mark.parametrize("n,N", [(5, 8), (20000, 65536), (100, 262144)])
def test_srht_slot_map_against_numpy(n, N):
    """The operands the encoders hand the kernel, from host arrays: cols
    and signs as given, and the signed slot map the passes gather
    through."""
    rng = np.random.default_rng(n)
    cols = rng.choice(N, n, replace=False)
    signs = rng.choice([-1.0, 1.0], n)
    want = np.full(N, -1, np.int32)
    want[cols] = (np.arange(n) << 1) | (signs < 0)
    cols_t, signs_t, got = srht_operands(cols, signs, N, "cpu")
    assert (cols_t.dtype, signs_t.dtype, got.dtype) == (
        torch.int32, torch.float32, torch.int32)
    np.testing.assert_array_equal(cols_t.numpy(), cols)
    np.testing.assert_array_equal(signs_t.numpy(), signs)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,N", [(1, 65536), (100001, 65536),
                                 (7, 1 << 30)])
def test_srht_partial_window_chunk_stays_within_budget(p, N):
    rows = srht_chunk_rows(p, N)
    assert 1 <= rows <= p
    assert rows == 1 or rows * N * 4 <= CHUNK_BYTES


def test_fused_wide_scratch_is_a_sixteenth_of_the_active_rows():
    """The column-split form's scratch a realization at the wide path's
    shape (LASSO §5.4 at n = 32 768: m = 128, r = 512, p = 100 000, 80
    of 128 workers active) stays within 1/16 of the active S X bytes: on
    the cluster route that width takes, one float32 p-row a unit of 64
    rows and no chunk sums, in float32 and bfloat16."""
    m, r, p, k = 128, 512, 100_000, 80
    assert pick_wide_block_rows(r) == 64
    assert [pick_wide_block_rows(v) for v in (1, 7, 96, 130)] == \
        [1, 7, 48, 26]
    for itemsize in (4, 2):
        assert wide_plan(p, itemsize).route == "cluster"
        assert fused_wide_scratch_bytes(m, r, p, itemsize) == \
            4 * m * (r // 64) * p
    assert fused_wide_scratch_bytes(m, r, p) <= k * r * p * 4 / 16


# ---------------------------------------------------------------------------
# make_encoded_problem's fast-Hadamard blocks, one copy out of the frame
# ---------------------------------------------------------------------------

def _stacked_blocks(X, y, enc, m, dtype):
    """The worker blocks as the port built them before: the float32 [X y]
    encoded, its blocks stacked and cast, the last column split off."""
    Xy = np.concatenate([X, y[:, None]], axis=1)
    blocks = enc.with_workers(m).encode_partitioned(
        torch.as_tensor(Xy, dtype=torch.float32))
    SXy = torch.stack(blocks).to(dtype)
    return SXy[..., :-1].contiguous(), SXy[..., -1].contiguous()


@pytest.mark.parametrize("n,p,m,dtype", [
    (64, 5, 4, torch.float32), (100, 7, 3, torch.float32),
    (48, 3, 8, torch.float32), (2500, 1030, 5, torch.float32),
    (64, 5, 4, torch.bfloat16)])
def test_make_encoded_problem_blocks_equal_stacked_encode(n, p, m, dtype):
    rng = np.random.default_rng(n + p)
    X, y = rng.standard_normal((n, p)), rng.standard_normal(n)
    enc = tcore.FastHadamardEncoder(n, 2.0, seed=0, device="cpu")
    prob = tcore.make_encoded_problem(X, y, enc, m, lam=0.1, dtype=dtype,
                                      device="cpu")
    SX, Sy = _stacked_blocks(X, y, enc, m, dtype)
    assert prob.SX.dtype == dtype and prob.SX.is_contiguous()
    assert torch.equal(prob.SX, SX) and torch.equal(prob.Sy, Sy)
    assert prob.beta == enc.beta and prob.n == n
    assert math.isclose(prob.lam, 0.1)
