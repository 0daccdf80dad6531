"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips (in the ``cuda``
fixture, never at import) where no card is present; this file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: float32 sums taken in another order than the plain version's,
max|d| <= 1e-5 of max|ref| for the butterflies and the combine and 1e-4
for the fused gradient's long dot products; bfloat16 outputs one bfloat16
ulp (2^-7).  Encoded L-BFGS on the card matches the same call on the CPU
to rel 1e-3 of its objective (float32 differences divided by their inner
products in the two-loop recursion and the line search).  The workloads'
``smoke`` cells on the card match the same cells on the CPU: ``times``
bit for bit, GD / ISTA / BCD traces to rel 1e-5, ``coded-lbfgs`` and MF
to rel 1e-4, ridge gaps to abs 1e-4 |f*|, LASSO F1 and logistic test
error equal; each cell launches exactly the kernels of its path.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EncodedProblem, masked_gradient, run_encoded_lbfgs
from repro_torch.kernels import launches
from repro_torch.kernels._build import load_library
from repro_torch.kernels.coded_reduce import (coded_combine_call,
                                              coded_combine_plain,
                                              combine_row_groups)
from repro_torch.kernels.encode import srht_encode_call, srht_encode_plain
from repro_torch.kernels.fused_step import (MAX_COLS, fused_masked_gradient,
                                            fused_masked_gradient_plain,
                                            pick_fused_realization_tile)
from repro_torch.kernels.fwht import fwht_kernel_call, fwht_plain
from repro_torch.runtime import scan_gd, scan_prox
from repro_torch.workloads import get_workload

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(out, ref, tol):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(ref.float().abs().max().item(), 1e-30)


def _randn(shape, seed, dev, dtype=torch.float32):
    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)


@pytest.mark.parametrize("n", [1, 2, 8, 32, 64, 512, 1024, 8192, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel(cuda, n, dtype):
    x = _randn((3, n), n, cuda, dtype)
    before = launches["fwht"]
    out = fwht_kernel_call(x)
    torch.cuda.synchronize()
    assert launches["fwht"] == before + 1 and out.dtype == dtype
    _close(out, fwht_plain(x), 1e-5 if dtype == torch.float32 else 2 ** -7)


def test_fwht_kernel_rejects(cuda):
    with pytest.raises(ValueError):
        fwht_kernel_call(torch.ones((2, 65536), device=cuda))
    with pytest.raises(ValueError):
        fwht_kernel_call(torch.ones((8, 4), device=cuda).t())
    with pytest.raises(TypeError):
        fwht_kernel_call(torch.ones((2, 8), device=cuda, dtype=torch.float64))


@pytest.mark.parametrize("n,N,lo,hi", [(48, 128, 0, 128), (48, 128, 32, 64),
                                       (3000, 4096, 1000, 1001),
                                       (4096, 8192, 0, 8192),
                                       (20000, 32768, 256, 512)])
def test_srht_kernel(cuda, n, N, lo, hi):
    rng = np.random.default_rng(n)
    cols = torch.tensor(rng.choice(N, n, replace=False).astype(np.int32),
                        device=cuda)
    signs = torch.tensor(rng.choice([-1.0, 1.0], n).astype(np.float32),
                         device=cuda)
    xt = _randn((5, n), n + 1, cuda)
    kw = dict(N=N, lo=lo, hi=hi, scale=n ** -0.5)
    out = srht_encode_call(xt, cols, signs, **kw)
    _close(out, srht_encode_plain(xt, cols, signs, **kw), 1e-5)


def _fused(dev, m, r, p, R, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    SX = _randn((m, r, p), seed, dev, dtype)
    Sy = _randn((m, r), seed + 1, dev, dtype)
    W = _randn((R, p), seed + 2, dev, dtype)
    masks = torch.tensor((rng.random((R, m)) < 0.7).astype(np.float32),
                         device=dev)
    return SX, Sy, W, masks


@pytest.mark.parametrize("m,r,p", [(4, 8, 37), (32, 8, 63), (3, 12, 1),
                                   (8, 256, 600), (32, 16, 6000),
                                   (2, 4, 16384)])
def test_fused_kernel_batched_and_single(cuda, m, r, p):
    SX, Sy, W, masks = _fused(cuda, m, r, p, R=4)
    out = fused_masked_gradient(SX, Sy, W, masks, n=m * r // 2, beta=2.0)
    ref = fused_masked_gradient_plain(SX, Sy, W, masks, n=m * r // 2,
                                      beta=2.0)
    _close(out, ref, 1e-4)
    for q in range(4):
        single = fused_masked_gradient(SX, Sy, W[q], masks[q], n=m * r // 2,
                                       beta=2.0)
        assert torch.equal(out[q], single)


@pytest.mark.parametrize("R", [1, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("p", [1, 37, 6000, 6001, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_tiles_bitwise(cuda, R, p, dtype):
    """Batched rows equal single calls bit for bit whatever the tile of
    realizations a row falls in, on every copy path into the row ring
    (bulk copies where a row is whole 16-byte units, 4-byte copies, plain
    loads for odd bfloat16 rows); worker 2 is masked out in every
    realization and, for R > 1, the last realization is all-masked."""
    SX, Sy, W, masks = _fused(cuda, 5, 24, p, R, dtype, seed=R + p)
    masks[:, 2] = 0.0
    if R > 1:
        masks[-1] = 0.0
    kw = dict(n=60, beta=2.0)
    out = fused_masked_gradient(SX, Sy, W, masks, **kw)
    _close(out, fused_masked_gradient_plain(SX, Sy, W, masks, **kw),
           1e-4 if dtype == torch.float32 else 2 ** -7)
    for q in range(R):
        assert torch.equal(out[q], fused_masked_gradient(SX, Sy, W[q],
                                                         masks[q], **kw))
    if R > 1:
        assert torch.count_nonzero(out[-1]) == 0


def test_kernel_shape_choices_match_wrappers(cuda):
    """The kernels choose their realization tile and row groups as the
    wrappers' Python functions say (those are what the CPU tests check)."""
    lib = load_library()
    assert all(lib.repro_fused_realization_tile(p) ==
               pick_fused_realization_tile(p)
               for p in range(1, MAX_COLS + 1))
    assert lib.repro_fused_realization_tile(MAX_COLS + 1) == 0
    assert all(lib.repro_coded_combine_groups(m) == combine_row_groups(m)
               for m in range(0, 300))


@pytest.mark.parametrize("r", [1, 7, 12, 34])
def test_fused_kernel_row_counts(cuda, r):
    """Row counts whose stage-1 row blocks differ (r, 7, 12, 2 rows)."""
    SX, Sy, W, masks = _fused(cuda, 4, r, 40, R=2, seed=3)
    out = fused_masked_gradient(SX, Sy, W, masks, n=2 * r, beta=2.0)
    _close(out, fused_masked_gradient_plain(SX, Sy, W, masks, n=2 * r,
                                            beta=2.0), 1e-4)


def test_fused_kernel_rejects_rows_wider_than_registers(cuda):
    SX, Sy, W, masks = _fused(cuda, 2, 2, 16385, R=1)
    with pytest.raises(ValueError):
        fused_masked_gradient(SX, Sy, W, masks, n=2, beta=2.0)


def test_fused_kernel_bf16_and_all_masked(cuda):
    SX, Sy, W, masks = _fused(cuda, 8, 16, 64, R=2, dtype=torch.bfloat16)
    out = fused_masked_gradient(SX, Sy, W, masks, n=64, beta=2.0)
    assert out.dtype == torch.bfloat16
    _close(out, fused_masked_gradient_plain(SX, Sy, W, masks, n=64,
                                            beta=2.0), 2 ** -7)
    zero = fused_masked_gradient(SX, Sy, W, torch.zeros_like(masks), n=64,
                                 beta=2.0)
    assert torch.count_nonzero(zero) == 0


def test_runners_on_card_match_cpu(cuda):
    SX, Sy, _, _ = _fused(cuda, 8, 16, 24, R=1, seed=5)
    X, y = _randn((64, 24), 7, cuda), _randn((64,), 8, cuda)
    masks = (np.random.default_rng(9).random((15, 8)) < 0.75)
    masks = masks.astype(np.float32)
    kw = dict(lam=0.05, beta=2.0, n=64)
    gpu = EncodedProblem(SX=SX, Sy=Sy, X=X, y=y, **kw)
    cpu = EncodedProblem(SX=SX.cpu(), Sy=Sy.cpu(), X=X.cpu(), y=y.cpu(), **kw)
    before = launches["fused_masked_gradient"]
    for run in (scan_gd, scan_prox):
        w_g, tr_g = run(gpu, masks, 0.01, torch.zeros(24, device=cuda))
        w_c, tr_c = run(cpu, masks, 0.01, torch.zeros(24))
        _close(tr_g.cpu(), tr_c, 1e-5)
        _close(w_g.cpu(), w_c, 1e-4)
    assert launches["fused_masked_gradient"] == before + 30


@pytest.mark.parametrize("P", [1, 37, 128, 2085, 6000, 6001])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 32, 64, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernel(cuda, P, m, dtype):
    g = _randn((m, P), P + m, cuda, dtype)
    c = torch.tensor(np.random.default_rng(m).uniform(size=m),
                     dtype=torch.float32, device=cuda)
    before = launches["coded_combine"]
    out = coded_combine_call(g, c)
    torch.cuda.synchronize()
    assert launches["coded_combine"] == before + 1 and out.dtype == dtype
    _close(out, coded_combine_plain(g, c),
           1e-5 if dtype == torch.float32 else 2 ** -7)
    assert torch.equal(out, coded_combine_call(g, c[:, None]))


def test_combine_kernel_all_masked_and_misaligned(cuda):
    g = _randn((8, 6001), 1, cuda)
    zero = coded_combine_call(g, torch.zeros(8, device=cuda))
    assert torch.count_nonzero(zero) == 0
    # a contiguous view one element into its storage: not 16-byte aligned,
    # so the kernel takes its one-column-at-a-time loads
    base = _randn((8 * 6000 + 1,), 2, cuda)
    view = base[1:].view(8, 6000)
    c = torch.rand(8, device=cuda)
    _close(coded_combine_call(view, c), coded_combine_plain(view, c), 1e-5)
    with pytest.raises(ValueError):
        coded_combine_call(g.t(), torch.ones(6001, device=cuda))


def _small_problem(dev):
    SX, Sy, _, _ = _fused(dev, 8, 16, 24, R=1, seed=5)
    X, y = _randn((64, 24), 7, dev), _randn((64,), 8, dev)
    return EncodedProblem(SX=SX, Sy=Sy, X=X, y=y, lam=0.05, beta=2.0, n=64)


def _cpu_copy(prob):
    return EncodedProblem(SX=prob.SX.cpu(), Sy=prob.Sy.cpu(), X=prob.X.cpu(),
                          y=prob.y.cpu(), lam=prob.lam, beta=prob.beta,
                          n=prob.n)


def test_masked_gradient_on_card_matches_cpu(cuda):
    gpu = _small_problem(cuda)
    cpu = _cpu_copy(gpu)
    w = _randn((24,), 3, cuda)
    before = launches["coded_combine"]
    for mask in ([1.0] * 8, [0.0] * 8, [1, 0, 1, 1, 0, 1, 1, 0]):
        mk = torch.tensor(mask, dtype=torch.float32)
        _close(masked_gradient(gpu, w, mk.to(cuda)).cpu(),
               masked_gradient(cpu, w.cpu(), mk), 1e-5)
    assert launches["coded_combine"] == before + 3


def test_lbfgs_on_card_matches_cpu(cuda):
    gpu = _small_problem(cuda)
    cpu = _cpu_copy(gpu)
    masks = (np.random.default_rng(4).random((25, 8)) < 0.75)
    masks = masks.astype(np.float32)
    before = launches["coded_combine"]
    w_g, tr_g = run_encoded_lbfgs(gpu, masks, memory=5)
    w_c, tr_c = run_encoded_lbfgs(cpu, masks, memory=5)
    assert launches["coded_combine"] == before + 25
    assert tr_g.is_cuda and torch.isfinite(tr_g).all()
    _close(tr_g.cpu(), tr_c, 1e-3)


# ---------------------------------------------------------------------------
# the workloads' smoke cells: card against CPU, and the kernels each path
# launches
# ---------------------------------------------------------------------------

FUSED, SRHT, FWHT, COMB = ("fused_masked_gradient", "srht_encode", "fwht",
                           "coded_combine")
WORKLOAD_CELLS = [
    # (workload, strategy, encoder, launches on the card)
    ("ridge", "coded", None, {COMB: 40}),
    ("ridge", "coded", "fast-hadamard", {COMB: 40, SRHT: 1}),
    ("ridge", "uncoded", None, {FUSED: 40}),
    ("ridge", "replication", None, {FUSED: 40}),
    ("lasso", "coded", None, {FUSED: 240}),
    ("logistic", "coded", None, {}),
    ("logistic", "coded", "fast-hadamard", {SRHT: 1, FWHT: 8}),
    ("mf", "coded", None, {COMB: 48}),
]


def _launched(before) -> dict:
    return {k: v - before.get(k, 0) for k, v in launches.items()
            if v - before.get(k, 0)}


def _same_cell(gpu, cpu, f_star=None):
    assert np.array_equal(gpu.times, cpu.times)
    assert np.array_equal(gpu.metric_times, cpu.metric_times)
    lbfgs = gpu.strategy == "coded-lbfgs"
    _close(torch.as_tensor(gpu.objective), torch.as_tensor(cpu.objective),
           1e-4 if lbfgs else 1e-5)
    if gpu.workload == "ridge":
        assert np.max(np.abs(gpu.metric - cpu.metric)) <= 1e-4 * abs(f_star)
    elif gpu.workload == "mf":
        _close(torch.as_tensor(gpu.metric), torch.as_tensor(cpu.metric),
               1e-4)
    else:                       # LASSO F1, logistic test error
        assert np.array_equal(gpu.metric, cpu.metric)


@pytest.mark.parametrize("name,strategy,encoder,expect", WORKLOAD_CELLS)
def test_workload_on_card_matches_cpu(cuda, name, strategy, encoder, expect):
    wl = get_workload(name)
    data = wl.build("smoke")
    cfg = {} if encoder is None else {"encoder": encoder}
    before = dict(launches)
    gpu = wl.run(strategy, preset="smoke", data=data, **cfg)
    torch.cuda.synchronize()
    assert _launched(before) == expect
    cpu = wl.run(strategy, preset="smoke", data=data, device="cpu", **cfg)
    assert _launched(before) == expect          # the CPU run launches none
    _same_cell(gpu, cpu, getattr(data, "f_star", None))


def test_ridge_run_trials_on_card_matches_cpu(cuda):
    wl = get_workload("ridge")
    data = wl.build("smoke")
    kw = dict(preset="smoke", data=data, trials=3, eval_every=4,
              encoder="fast-hadamard")
    before = dict(launches)
    gpu = wl.run_trials("coded", **kw)
    assert _launched(before) == {COMB: 3 * 40, SRHT: 1}
    cpu = wl.run_trials("coded", device="cpu", **kw)
    for g, c in zip(gpu, cpu):
        _same_cell(g, c, data.f_star)
