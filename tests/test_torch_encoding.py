"""The port's encoders, data generators and encoded problem against the
JAX package (``repro.core``, ``repro.data``).

Host numpy code copied into the port must match bit for bit
(``materialize()``, the rng draws, dense blocks).  Maps computed in float32
on the device (the fast-Hadamard encode / decode_t / worker_block) match to
float32 rounding: max|d| <= 1e-5 of max|ref|.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro_torch.core as tcore
import repro_torch.data as tdata

F32_TOL = 1e-5


def _close(out, ref, tol=F32_TOL):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= tol * max(np.max(np.abs(ref)), 1e-30)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("n,beta,seed", [(5, 2.0, 0), (96, 2.0, 3),
                                         (4096, 2.0, 0), (100, 1.5, 9)])
def test_hadamard_ensemble_draws_identical(n, beta, seed):
    N1, c1, s1 = jcore.encoding.hadamard_ensemble(n, beta, seed)
    N2, c2, s2 = tcore.hadamard_ensemble(n, beta, seed)
    assert N1 == N2
    assert np.array_equal(c1, c2) and np.array_equal(s1, s2)


@pytest.mark.parametrize("name", ["gaussian", "hadamard", "haar", "paley",
                                  "steiner", "replication", "uncoded"])
def test_dense_encoders_materialize_bitwise(name):
    ref = jcore.make_encoder(name, 24, beta=2.0, seed=4)
    out = tcore.make_encoder(name, 24, beta=2.0, seed=4)
    assert (out.name, out.beta, out.tight) == (ref.name, ref.beta, ref.tight)
    assert np.array_equal(out.materialize(), ref.materialize())


def test_registry_names_match():
    assert tcore.available_encoders() == jcore.available_encoders()


@pytest.mark.parametrize("n,m", [(96, 4), (48, 8), (64, 3)])
def test_fast_hadamard_materialize_and_partition_bitwise(n, m):
    ref = jcore.FastHadamardEncoder(n, 2.0, seed=5).with_workers(m)
    out = tcore.FastHadamardEncoder(n, 2.0, seed=5,
                                    device="cpu").with_workers(m)
    assert (out.rows, out.rows_per_worker, out.beta) == \
        (ref.rows, ref.rows_per_worker, ref.beta)
    assert np.array_equal(out.materialize(), ref.materialize())
    assert np.array_equal(tcore.partition_rows(out, m),
                          jcore.partition_rows(ref, m))


@pytest.mark.parametrize("n,m", [(96, 4), (48, 8), (64, 3)])
def test_fast_hadamard_maps_match_reference(n, m):
    """encode / decode_t / every worker_block (Kronecker split when m is a
    power of two, the windowed SRHT otherwise) to float32 rounding."""
    ref = jcore.FastHadamardEncoder(n, 2.0, seed=1).with_workers(m)
    out = tcore.FastHadamardEncoder(n, 2.0, seed=1,
                                    device="cpu").with_workers(m)
    rng = np.random.default_rng(n + m)
    X = rng.standard_normal((n, 5))
    _close(_np(out.encode(X)), ref.encode(X))
    _close(_np(out.encode(X[:, 0])), ref.encode(X[:, 0]))
    G = rng.standard_normal((ref.rows, 3))
    _close(_np(out.decode_t(G)), ref.decode_t(G))
    for i in range(m):
        _close(_np(out.worker_block(i, X)), ref.worker_block(i, X))
    for a, b in zip(out.encode_partitioned(X), ref.encode_partitioned(X)):
        _close(_np(a), b)


def test_fast_hadamard_decode_inverts_encode():
    enc = tcore.FastHadamardEncoder(64, 2.0, seed=2, device="cpu")
    X = torch.tensor(np.random.default_rng(0).standard_normal((64, 4)),
                     dtype=torch.float32)
    _close(enc.decode_t(enc.encode(X)).numpy(), enc.beta * X.numpy())


def test_fast_hadamard_tensor_inputs_stay_on_their_device():
    enc = tcore.FastHadamardEncoder(32, 2.0, seed=0)   # device unset
    out = enc.encode(torch.ones((32, 2)))
    assert out.device.type == "cpu"


@pytest.mark.parametrize("m", [4, 5])
def test_block_diagonal_bitwise(m):
    ref = jcore.BlockDiagonalEncoder(96, 2.0, seed=1,
                                     block_size=16).with_workers(m)
    out = tcore.BlockDiagonalEncoder(96, 2.0, seed=1,
                                     block_size=16).with_workers(m)
    assert np.array_equal(out.materialize(), ref.materialize())
    X = np.random.default_rng(2).standard_normal((96, 3))
    assert np.array_equal(out.encode(X), ref.encode(X))
    G = np.random.default_rng(3).standard_normal((ref.rows, 2))
    assert np.array_equal(out.decode_t(G), ref.decode_t(G))
    for i in range(m):
        assert out.input_slice(i) == ref.input_slice(i)
        assert np.array_equal(out.worker_block(i, X), ref.worker_block(i, X))


@pytest.mark.parametrize("name", ["hadamard", "gaussian", "paley"])
def test_brip_constant_and_spectrum_identical(name):
    ref = jcore.make_encoder(name, 32, beta=2.0, seed=0)
    out = tcore.make_encoder(name, 32, beta=2.0, seed=0)
    assert tcore.brip_constant(out, 8, 6, trials=5) == \
        jcore.brip_constant(ref, 8, 6, trials=5)
    assert tcore.pad_rows(out, 5).rows == jcore.pad_rows(ref, 5).rows


def test_lsq_dataset_and_rows_identical():
    for kw in ({}, {"sparse": 5}, {"noise": 0.5, "seed": 3}):
        for a, b in zip(tdata.lsq_dataset(40, 12, **kw),
                        jdata.lsq_dataset(40, 12, **kw)):
            assert np.array_equal(a, b)
        for a, b in zip(tdata.lsq_rows(4000, 4200, 6, **kw),
                        jdata.lsq_rows(4000, 4200, 6, **kw)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["hadamard", "replication", "uncoded",
                                  "block-diagonal"])
def test_make_encoded_problem_dense_blocks_bitwise(name):
    X, y, _ = jdata.lsq_dataset(64, 10, seed=1)
    kw = {"block_size": 16} if name == "block-diagonal" else {}
    ref = jcore.make_encoded_problem(
        X, y, jcore.make_encoder(name, 64, beta=2.0, seed=0, **kw), 4,
        lam=0.1)
    out = tcore.make_encoded_problem(
        X, y, tcore.make_encoder(name, 64, beta=2.0, seed=0, **kw), 4,
        lam=0.1, device="cpu")
    for f in ("SX", "Sy", "X", "y"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(ref, f)))
    assert (out.lam, out.beta, out.n, out.m) == \
        (ref.lam, ref.beta, ref.n, ref.m)


@pytest.mark.parametrize("m", [8, 3])
def test_make_encoded_problem_fast_hadamard(m):
    X, y, _ = jdata.lsq_dataset(96, 10, seed=2)
    ref = jcore.make_encoded_problem(X, y,
                                     jcore.FastHadamardEncoder(96, 2.0), m)
    out = tcore.make_encoded_problem(X, y,
                                     tcore.FastHadamardEncoder(96, 2.0), m,
                                     device="cpu")
    assert out.SX.is_contiguous() and out.Sy.is_contiguous()
    _close(out.SX.numpy(), np.asarray(ref.SX))
    _close(out.Sy.numpy(), np.asarray(ref.Sy))
    assert out.beta == ref.beta


def test_from_numpy_carries_the_reference_problem():
    X, y, _ = jdata.lsq_dataset(64, 10, seed=1)
    ref = jcore.make_encoded_problem(X, y, jcore.hadamard_encoder(64), 4,
                                     lam=0.2)
    out = tcore.EncodedProblem.from_numpy(
        np.asarray(ref.SX), np.asarray(ref.Sy), np.asarray(ref.X),
        np.asarray(ref.y), lam=ref.lam, beta=ref.beta, n=ref.n, device="cpu")
    assert out.SX.dtype == torch.float32 and out.m == ref.m
    assert np.array_equal(out.SX.numpy(), np.asarray(ref.SX))
