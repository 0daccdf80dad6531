"""The plans of the port's Hadamard kernels and the arithmetic of their new
routes, on the CPU: the properties of the route, cluster size, slots a CTA
and shared memory that each transform length takes (FWHT ``fwht_plan``,
SRHT ``srht_plan``); the pruned window's identity

    H_N[lo:hi] z = H_{r'}( sum_q (-1)^popcount(b & q) z_q )[lo - b r' :]

(z_q the q-th r'-slot chunk of the signed, scattered column), which the
card's ``pruned`` route computes, composed from the port's window block,
signed slot map and butterfly, against the plain SRHT and the JAX
package's ``repro.kernels.ops.srht_encode`` (run as its own CPU tests run
it); the signed slot map against numpy, and the signs of +-1 it requires.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the pruned identity rel 1e-5 of the reference's largest
magnitude (float32 sums of N / r' chunks in another order than the
butterfly's); the plans and the map exactly.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.encode import (MAX_ONE_PASS_SRHT, MIN_PRUNED,
                                        srht_encode_call, srht_encode_plain,
                                        srht_plan, srht_signed_slot_map,
                                        srht_window_block)
from repro_torch.kernels.fwht import (CLUSTER_CTAS, MAX_CLUSTER, MAX_ONE_PASS,
                                      MIN_CTA_SLOTS, butterfly, fwht_passes,
                                      fwht_plan)

RTOL = 1e-5
# the H100's shared memory a block (227 KB)
BLOCK_SMEM = 232448
LENGTHS = [1 << e for e in range(1, 23)]


def _ensemble(n, N, seed):
    rng = np.random.default_rng(seed)
    cols = rng.choice(N, n, replace=False)
    signs = rng.choice([-1.0, 1.0], n)
    return cols, signs


def _pruned(xt, cols, signs, N, lo, hi, scale):
    """The pruned route's arithmetic from the port's pieces: the window's
    block (``srht_window_block``), the signed slot map it gathers through
    (``srht_signed_slot_map``, decoded as the kernel decodes it), each of
    r' slots summed over the N / r' chunks in chunk order with the signs of
    H_{N / r'}'s row b, then the r'-point ``butterfly`` and the window."""
    rp, b = srht_window_block(N, lo, hi)
    smap = srht_signed_slot_map(torch.as_tensor(cols.astype(np.int32)),
                                torch.as_tensor(signs, dtype=torch.float32),
                                N).long()
    x = torch.as_tensor(xt, dtype=torch.float32)
    vals = x[:, (smap >> 1).clamp_min(0)]
    z = torch.where(smap >= 0, torch.where((smap & 1) == 1, -vals, vals),
                    torch.zeros(()))
    y = torch.zeros((x.shape[0], rp))
    for q in range(N // rp):
        chunk = z[:, q * rp:(q + 1) * rp]
        y = y - chunk if bin(b & q).count("1") & 1 else y + chunk
    return (butterfly(y, rp)[:, lo - b * rp:hi - b * rp] * scale).numpy()


def _cta_smem(plan, n):
    """A CTA's dynamic shared memory on the plan's route, as the launchers
    of ``csrc/srht.cu`` size it: the slots, and on a staged one-pass route
    two staging buffers of the column padded to a multiple of 4."""
    staged = 2 * (-(-n // 4) * 4) if plan.stage else 0
    return (plan.slots + staged) * 4


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def test_plans_take_one_row_shape_only():
    """A plan is a function of one row's shapes: no row count enters it, so
    a row's route, and with it its result, is the same in any batch."""
    assert list(inspect.signature(fwht_plan).parameters) == ["n"]
    assert list(inspect.signature(srht_plan).parameters) == ["n", "N", "lo",
                                                             "hi"]


@pytest.mark.parametrize("n", LENGTHS)
def test_fwht_plan_every_length(n):
    """One launch (one pass or one cluster) up to MAX_CLUSTER; the C CTAs
    of a cluster split the row evenly, within the portable cluster size
    and one CTA's shared memory; past it, passes that multiply to n."""
    plan = fwht_plan(n)
    assert plan.slots * 4 <= BLOCK_SMEM
    if plan.route == "passes":
        assert n > MAX_CLUSTER
        assert math.prod(L for L, _ in fwht_passes(n)) == n
    else:
        assert n <= MAX_CLUSTER
        assert plan.C * plan.slots == n and plan.C & (plan.C - 1) == 0
        assert plan.C <= CLUSTER_CTAS
        assert (plan.route == "one-pass") == (plan.C == 1) == (
            n <= MAX_ONE_PASS)
        if plan.route == "cluster":
            assert MIN_CTA_SLOTS <= plan.slots <= MAX_ONE_PASS
    assert fwht_plan(n) == plan                  # the same every call


@pytest.mark.parametrize("N", LENGTHS)
def test_srht_plan_every_length(N):
    """Every route covers the transform or the window: a pruned block is an
    aligned power of two below N that holds the window, a cluster's CTAs
    split N evenly, a one-pass block holds N; each CTA's shared memory
    fits the card's; only a window too wide to prune past MAX_CLUSTER takes
    the passes."""
    rng = np.random.default_rng(N)
    for n in sorted({1, 3, max(1, N // 2), N}):
        windows = {(0, N), (0, 1), (N - 1, N), (N // 2 - 1, N // 2 + 1)
                   if N >= 4 else (0, N)}
        lo = int(rng.integers(0, N))
        windows.add((lo, int(rng.integers(lo + 1, N + 1))))
        for lo, hi in windows:
            plan = srht_plan(n, N, lo, hi)
            assert _cta_smem(plan, n) <= BLOCK_SMEM
            assert plan.stage <= (plan.route == "one-pass")
            if plan.route == "pruned":
                rp, b = plan.rp, plan.b
                assert plan.slots == rp and rp & (rp - 1) == 0
                assert min(N, MIN_PRUNED) <= rp < N and rp <= MAX_ONE_PASS
                assert b * rp <= lo and hi <= (b + 1) * rp
            elif plan.route == "one-pass":
                assert plan.C == 1 and plan.slots == N <= MAX_ONE_PASS_SRHT
                assert plan.stage == (n % 4 == 0)   # a bulk copy's rows
            elif plan.route == "cluster":
                assert plan.C * plan.slots == N <= MAX_CLUSTER
                assert 1 < plan.C <= CLUSTER_CTAS
            else:
                assert plan.route == "passes" and N > MAX_CLUSTER
                assert srht_window_block(N, lo, hi)[0] > MAX_ONE_PASS
            assert srht_plan(n, N, lo, hi) == plan


@pytest.mark.parametrize("N", [2, 64, 512, 4096, 65536])
def test_srht_window_block_is_the_smallest_aligned_block(N):
    rng = np.random.default_rng(N + 1)
    for _ in range(200):
        lo = int(rng.integers(0, N))
        hi = int(rng.integers(lo + 1, N + 1))
        rp, b = srht_window_block(N, lo, hi)
        assert rp & (rp - 1) == 0 and rp <= N
        assert b * rp <= lo and hi <= (b + 1) * rp
        if rp > min(N, MIN_PRUNED):       # a half block would not hold it
            half = rp // 2
            assert lo // half != (hi - 1) // half


# ---------------------------------------------------------------------------
# the pruned window's identity and the signed slot map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(512, 1024),     # aligned
                                   (700, 901),      # misaligned
                                   (1500, 1501),    # one row
                                   (1000, 1100)])   # straddles N / 2
def test_pruned_identity_matches_plain_and_reference(lo, hi):
    import jax.numpy as jnp
    from repro.kernels.ops import srht_encode
    n, N, p = 1000, 2048, 3
    cols, signs = _ensemble(n, N, lo)
    X = np.random.default_rng(hi).standard_normal((n, p)).astype(np.float32)
    scale = 1.0 / math.sqrt(n)
    got = _pruned(X.T, cols, signs, N, lo, hi, scale)
    plain = srht_encode_plain(
        torch.as_tensor(X.T.copy()), torch.as_tensor(cols),
        torch.as_tensor(signs, dtype=torch.float32), N=N, lo=lo, hi=hi,
        scale=scale).numpy()
    ref = np.asarray(srht_encode(jnp.asarray(X), cols, signs, N, lo=lo,
                                 hi=hi)).T
    for want in (plain, ref):
        assert got.shape == want.shape == (p, hi - lo)
        assert np.max(np.abs(got - want)) <= RTOL * np.max(np.abs(want))


@pytest.mark.parametrize("n,N,lo,hi", [(32768, 65536, 2560, 3072),
                                       (32768, 65536, 2561, 3000),
                                       (20000, 65536, 40000, 40001),
                                       (4096, 8192, 1280, 1536)])
def test_pruned_identity_at_the_paths_windows(n, N, lo, hi):
    """Worker 5's window of the wide path's N = 65 536 and of PAPER_RIDGE's
    N = 8192, a misaligned window and one row, against the plain SRHT."""
    cols, signs = _ensemble(n, N, n + lo)
    xt = np.random.default_rng(hi).standard_normal((2, n)).astype(np.float32)
    scale = 1.0 / math.sqrt(n)
    assert srht_plan(n, N, lo, hi).route == "pruned"
    got = _pruned(xt, cols, signs, N, lo, hi, scale)
    want = srht_encode_plain(torch.as_tensor(xt), torch.as_tensor(cols),
                             torch.as_tensor(signs, dtype=torch.float32),
                             N=N, lo=lo, hi=hi, scale=scale).numpy()
    assert np.max(np.abs(got - want)) <= RTOL * np.max(np.abs(want))


@pytest.mark.parametrize("n,N", [(1, 2), (5, 8), (4096, 8192),
                                 (32768, 65536), (100000, 262144)])
def test_signed_slot_map_against_numpy(n, N):
    cols, signs = _ensemble(n, N, n)
    want = np.full(N, -1, np.int64)
    want[cols] = np.arange(n) * 2 + (signs < 0)
    got = srht_signed_slot_map(torch.as_tensor(cols.astype(np.int32)),
                               torch.as_tensor(signs, dtype=torch.float32),
                               N)
    assert got.dtype == torch.int32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    live = want >= 0                     # the map decodes to (cols, signs)
    np.testing.assert_array_equal(cols[want[live] >> 1],
                                  np.flatnonzero(live))
    np.testing.assert_array_equal(
        np.where(want[live] & 1, -1.0, 1.0), signs[want[live] >> 1])


@pytest.mark.parametrize("bad", ["half", "zero", "nan", "slot"])
def test_srht_rejects_signs_off_one_and_slots_off_the_frame(bad):
    """The kernels keep only a sign's sign bit, so the map's builder, every
    wrapper call that builds it (on the CPU too) and the host-array entry
    point refuse signs other than +-1 and slots outside [0, N)."""
    n, N = 40, 64
    cols, signs = _ensemble(n, N, 7)
    if bad == "slot":
        cols[3] = N
    else:
        signs[5] = {"half": 0.5, "zero": 0.0, "nan": np.nan}[bad]
    cols_t = torch.as_tensor(cols.astype(np.int32))
    signs_t = torch.as_tensor(signs, dtype=torch.float32)
    with pytest.raises(ValueError, match="signs of"):
        srht_signed_slot_map(cols_t, signs_t, N)
    with pytest.raises(ValueError, match="signs of"):
        srht_encode_call(torch.ones((2, n)), cols_t, signs_t, N=N, lo=0,
                         hi=N, scale=1.0)
    with pytest.raises(ValueError):
        ops.srht_encode(torch.ones((n, 2)), cols, signs, N)


def _c_entries():
    """{name: [parameter types]} of every ``extern "C"`` entry point in the
    kernels' sources."""
    import re

    from repro_torch.kernels._build import CSRC
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()[:-1]) for p in m.group(2).split(",")
                      if p.strip()]
            out[m.group(1)] = params
    return out


def test_ctypes_signatures_match_the_c_entry_points():
    """Each entry point's ctypes argument list has the C declaration's
    length and types, so a call from the wrappers passes what the kernel
    reads (a mismatch would show only on the card)."""
    import ctypes

    from repro_torch.kernels._build import _SIGNATURES
    as_ctypes = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
                 "int": ctypes.c_int, "int64_t": ctypes.c_int64,
                 "float": ctypes.c_float}
    entries = _c_entries()
    assert set(_SIGNATURES) == set(entries)
    for name, params in entries.items():
        assert _SIGNATURES[name] == [as_ctypes[p] for p in params], name
