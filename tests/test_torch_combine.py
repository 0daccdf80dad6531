"""The port's coded combine (its plain version, the path CPU tensors take)
against the JAX package's Pallas combine run in interpret mode and its
``coded_combine_ref``, and ``_masked_mean`` / ``masked_gradient`` against
the reference's dense path.

Inputs are drawn from a seed with numpy and handed to both packages.
Tolerance: rel 1e-5 of max|ref| in float32 (the same einsum on both sides,
summed in another order by XLA's fusion); one bfloat16 ulp (2^-7) for
bfloat16 outputs.  (m,) and (m, 1) weights give the same result bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.data_parallel import _masked_mean as j_masked_mean
from repro.kernels.coded_reduce import coded_combine_call as j_combine
from repro.kernels.ref import coded_combine_ref as j_combine_ref
import repro_torch.core as tcore
from repro_torch.core.data_parallel import _masked_mean
from repro_torch.kernels import launches, ops
from repro_torch.kernels.coded_reduce import coded_combine_call
from repro_torch.kernels.ref import coded_combine_ref

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
CASES = [(4, 128), (16, 2048), (32, 6144), (8, 3000), (6, 37), (6, 2085)]


def _close(out, ref, tol):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(np.max(np.abs(ref)), 1e-30)


def _inputs(m, P, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, P)).astype(np.float32)
    c = rng.uniform(size=m).astype(np.float32)
    return g, c


@pytest.mark.parametrize("m,P", CASES)
def test_combine_matches_pallas_and_ref(m, P):
    g, c = _inputs(m, P, m * P)
    out = coded_combine_call(torch.tensor(g), torch.tensor(c))
    ref_kernel = j_combine(jnp.asarray(g), jnp.asarray(c),
                           block=min(2048, P), interpret=True)
    ref = j_combine_ref(jnp.asarray(g), jnp.asarray(c))
    assert out.dtype == torch.float32 and out.shape == (P,)
    _close(out, ref_kernel, F32_TOL)
    _close(out, ref, F32_TOL)
    _close(ops.coded_combine(torch.tensor(g), torch.tensor(c)), ref,
           F32_TOL)


@pytest.mark.parametrize("m,P", [(6, 37), (6, 2085), (32, 6144)])
def test_combine_weight_shapes_bitwise(m, P):
    g, c = _inputs(m, P, 7)
    gt, ct = torch.tensor(g), torch.tensor(c)
    assert torch.equal(coded_combine_call(gt, ct),
                       coded_combine_call(gt, ct[:, None]))


def test_combine_bf16_matches_reference():
    g, c = _inputs(8, 3000, 11)
    gj = jnp.asarray(g, jnp.bfloat16)
    gt = torch.tensor(g).to(torch.bfloat16)
    out = coded_combine_call(gt, torch.tensor(c))
    assert out.dtype == torch.bfloat16
    ref = j_combine_ref(gj, jnp.asarray(c))
    _close(out.float(), np.asarray(ref, np.float32), BF16_TOL)


def test_combine_all_masked_is_zero_and_cpu_launches_nothing():
    g, _ = _inputs(8, 600, 3)
    before = sum(launches.values())
    out = coded_combine_call(torch.tensor(g), torch.zeros(8))
    assert torch.count_nonzero(out) == 0
    assert sum(launches.values()) == before


def test_combine_rejects_bad_shapes():
    g = torch.zeros((4, 10))
    for bad in (torch.zeros(3), torch.zeros((4, 2)), torch.zeros((1, 4))):
        with pytest.raises(ValueError):
            coded_combine_call(g, bad)
    with pytest.raises(ValueError):
        coded_combine_call(torch.zeros(10), torch.zeros(10))


def test_plain_version_is_the_reference_formula():
    g, c = _inputs(5, 77, 5)
    assert torch.equal(coded_combine_ref(torch.tensor(g), torch.tensor(c)),
                       torch.einsum("m,mp->p", torch.tensor(c),
                                    torch.tensor(g)))


@pytest.mark.parametrize("active", [0, 1, 5, 8])
def test_masked_mean_matches_reference(active):
    rng = np.random.default_rng(active)
    g = rng.standard_normal((8, 300)).astype(np.float32)
    mask = np.zeros(8, np.float32)
    mask[rng.permutation(8)[:active]] = 1.0
    out = _masked_mean(torch.tensor(g), torch.tensor(mask))
    ref = j_masked_mean(jnp.asarray(g), jnp.asarray(mask))
    if active == 0:
        assert torch.count_nonzero(out) == 0
    else:
        _close(out, ref, F32_TOL)


def test_masked_gradient_matches_reference():
    rng = np.random.default_rng(1)
    n, p, m = 96, 24, 8
    X = rng.standard_normal((n, p))
    y = rng.standard_normal(n)
    jp = jcore.make_encoded_problem(X, y, jcore.hadamard_encoder(n, 2.0), m,
                                    lam=0.05)
    tp = tcore.EncodedProblem.from_numpy(
        np.asarray(jp.SX), np.asarray(jp.Sy), np.asarray(jp.X),
        np.asarray(jp.y), lam=jp.lam, beta=jp.beta, n=jp.n, device="cpu")
    for seed in range(3):
        r = np.random.default_rng(seed)
        w = r.standard_normal(p).astype(np.float32)
        mask = (r.random(m) < 0.6).astype(np.float32)
        _close(tcore.masked_gradient(tp, torch.tensor(w), torch.tensor(mask)),
               jcore.masked_gradient(jp, jnp.asarray(w), jnp.asarray(mask)),
               F32_TOL)
