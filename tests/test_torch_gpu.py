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
error equal; each cell launches exactly the kernels of its path.  The
runners' combine branch (``REPRO_FUSED=0``) matches the fused branch to rel
1e-5, and an experiment spec executed on the card matches the same spec on
the CPU under the same rules, with ``times`` bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import EncodedProblem, masked_gradient, run_encoded_lbfgs
from repro_torch.kernels import launches
from repro_torch.kernels._build import load_library
from repro_torch.kernels.coded_reduce import (coded_combine_call,
                                              coded_combine_ref,
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
    _close(out, coded_combine_ref(g, c),
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
    _close(coded_combine_call(view, c), coded_combine_ref(view, c), 1e-5)
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


# ---------------------------------------------------------------------------
# the runners' two branches (REPRO_FUSED), the harness and the build watch
# ---------------------------------------------------------------------------

def test_runners_combine_branch_on_card(cuda, monkeypatch):
    """REPRO_FUSED=0 takes the combine kernel (one launch a realization a
    step) and never the fused kernel; its trace matches the fused
    branch's."""
    from repro_torch.runtime import batched_scan_gd
    gpu = _small_problem(cuda)
    masks = (np.random.default_rng(9).random((3, 15, 8)) < 0.75)
    masks = masks.astype(np.float32)
    W0 = torch.zeros((3, 24), device=cuda)
    monkeypatch.setenv("REPRO_FUSED", "1")
    before = dict(launches)
    W_f, tr_f = batched_scan_gd(gpu, masks, 0.01, W0)
    torch.cuda.synchronize()
    assert _launched(before) == {FUSED: 15}
    monkeypatch.setenv("REPRO_FUSED", "0")
    before = dict(launches)
    W_c, tr_c = batched_scan_gd(gpu, masks, 0.01, W0)
    w_p, tr_p = scan_prox(gpu, masks[0], 0.01, W0[0])
    torch.cuda.synchronize()
    assert _launched(before) == {COMB: 3 * 15 + 15}
    _close(tr_c, tr_f, 1e-5)
    _close(W_c, W_f, 1e-4)
    monkeypatch.setenv("REPRO_FUSED", "1")
    _close(tr_p, scan_prox(gpu, masks[0], 0.01, W0[0])[1], 1e-5)


def test_runners_refuse_past_max_cols_and_name_the_switch(cuda, monkeypatch):
    """At p = MAX_COLS + 1 the fused branch raises with an error that names
    REPRO_FUSED=0; under it the same run takes the combine path."""
    from repro_torch.core import run_encoded_gd
    p = MAX_COLS + 1
    SX, Sy, _, _ = _fused(cuda, 4, 2, p, R=1, seed=1)
    prob = EncodedProblem(SX=SX, Sy=Sy, X=_randn((8, p), 2, cuda),
                          y=_randn((8,), 3, cuda), lam=0.1, beta=1.0, n=8)
    masks = np.ones((3, 4), np.float32)
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    with pytest.raises(ValueError, match="REPRO_FUSED=0"):
        run_encoded_gd(prob, masks, 1e-4)
    monkeypatch.setenv("REPRO_FUSED", "0")
    before = dict(launches)
    w, tr = run_encoded_gd(prob, masks, 1e-4)
    assert _launched(before) == {COMB: 3}
    assert w.is_cuda and np.isfinite(tr).all()
    w_c, tr_c = run_encoded_gd(prob, masks, 1e-4, device="cpu")
    _close(torch.as_tensor(tr), torch.as_tensor(tr_c), 1e-5)


@pytest.mark.parametrize("wrapper", ["run_encoded_gd",
                                     "run_encoded_proximal"])
def test_run_encoded_wrappers_move_a_host_w0(cuda, wrapper):
    """A card problem with a host ``w0`` (a CPU tensor or a numpy array):
    the wrapper moves ``w0`` to the card and matches the CPU run."""
    import repro_torch.core as core
    run = getattr(core, wrapper)
    gpu = _small_problem(cuda)
    masks = (np.random.default_rng(4).random((12, 8)) < 0.75)
    masks = masks.astype(np.float32)
    w0 = np.random.default_rng(5).standard_normal(24)
    w_c, tr_c = run(_cpu_copy(gpu), masks, 0.01, w0=torch.as_tensor(w0),
                    device="cpu")
    for start in (torch.as_tensor(w0, dtype=torch.float32), w0):
        before = dict(launches)
        w, tr = run(gpu, masks, 0.01, w0=start)
        torch.cuda.synchronize()
        assert _launched(before) == {FUSED: 12}
        assert w.is_cuda
        _close(torch.as_tensor(tr), torch.as_tensor(tr_c), 1e-5)
        _close(w.cpu(), w_c, 1e-5)


def test_logistic_fast_hadamard_through_harness_on_card(cuda):
    """The logistic fast-Hadamard smoke cell through the harness's
    ``run_workload_matrix``: one SRHT lift and one FWHT decode a chunk on
    the card, and the same record as the CPU run."""
    from repro_torch.workloads import run_workload_matrix
    kw = dict(preset="smoke", encoder="fast-hadamard")
    before = dict(launches)
    (gpu,) = run_workload_matrix(["logistic"], ["coded"], **kw)
    torch.cuda.synchronize()
    records = get_workload("logistic").preset("smoke").dims["records"]
    assert _launched(before) == {SRHT: 1, FWHT: records}
    before = dict(launches)
    (cpu,) = run_workload_matrix(["logistic"], ["coded"], device="cpu", **kw)
    assert _launched(before) == {}
    assert gpu["times"] == cpu["times"]
    _close(torch.tensor(gpu["objective"]), torch.tensor(cpu["objective"]),
           1e-5)


def test_harness_cells_past_max_cols_on_card(cuda, monkeypatch):
    """Through ``execute`` on the card, GD cells at p = MAX_COLS + 1 come
    out as skip records naming REPRO_FUSED=0; under it they run on the
    combine kernel."""
    from repro_torch.experiments import (DelayAxis, ExperimentSpec,
                                         ProblemAxis, StrategyAxis, execute,
                                         plan)
    opts = (("step_size", 1e-4),)
    spec = ExperimentSpec(
        problems=(ProblemAxis.synthetic(32, MAX_COLS + 1),),
        strategies=(StrategyAxis("coded-gd", options=opts),
                    StrategyAxis("uncoded", options=opts)),
        delays=DelayAxis.of("bimodal", m=4), steps=2)
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    before = dict(launches)
    out = execute(plan(spec), record_to=False)
    assert FUSED not in _launched(before)
    for rec in out.records:
        assert "REPRO_FUSED=0" in rec["skipped"]
    monkeypatch.setenv("REPRO_FUSED", "0")
    before = dict(launches)
    out = execute(plan(spec), record_to=False)
    torch.cuda.synchronize()
    assert _launched(before).get(COMB, 0) >= 2 * 2
    assert FUSED not in _launched(before)
    for rec in out.records:
        assert "skipped" not in rec
        assert np.isfinite(rec["objective"]).all()


def _spec():
    from repro_torch.experiments import (DelayAxis, ExperimentSpec,
                                         ProblemAxis, StrategyAxis,
                                         TrialsAxis)
    return ExperimentSpec(
        problems=(ProblemAxis.synthetic(96, 24),
                  ProblemAxis.from_workload("ridge", "smoke")),
        strategies=(StrategyAxis("coded-gd", encoder="fast-hadamard"),
                    StrategyAxis("coded-lbfgs"), StrategyAxis("uncoded")),
        delays=DelayAxis.of("bimodal", m=8),
        trials=TrialsAxis(trials=2), steps=8)


def test_experiment_on_card_matches_cpu(cuda, tmp_path):
    """One spec through ``execute`` on the card and on the CPU: the same
    records (``times`` bit for bit, objectives to rel 1e-5, coded-lbfgs
    to rel 1e-4), the card's run launching the kernels of its cells."""
    from repro_torch.experiments import execute, plan
    from repro_torch.obs import RunStore
    store = RunStore(str(tmp_path / "runs"))
    before = dict(launches)
    gpu = execute(plan(_spec()), record_to=store)
    torch.cuda.synchronize()
    got = _launched(before)
    assert got.get(FUSED, 0) > 0 and got.get(SRHT, 0) > 0 and \
        got.get(COMB, 0) > 0
    before = dict(launches)
    cpu = execute(plan(_spec()), device="cpu", record_to=False)
    assert _launched(before) == {}
    assert gpu.device.type == "cuda" and cpu.device.type == "cpu"
    assert store.load(gpu.run_id)["backend"] == "cuda"
    for g, c in zip(gpu.records, cpu.records):
        assert g.keys() == c.keys() and g.get("skipped") == c.get("skipped")
        if "skipped" in c:
            continue
        assert g["times"] == c["times"]
        assert g["wallclock_s"] == c["wallclock_s"]
        tol = 1e-4 if g["strategy"] == "coded-lbfgs" else 1e-5
        _close(torch.tensor(g["objective"]), torch.tensor(c["objective"]),
               tol)


def test_compile_watch_counts_a_fresh_build(cuda, monkeypatch, tmp_path):
    """A build of the kernels into an empty directory inside the watch
    counts one compile, and its time is compile time; loading the built
    library again counts none."""
    from repro_torch.kernels import _build
    from repro_torch.obs import CompileWatch
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    with CompileWatch() as cold:
        lib = _build.load_library.__wrapped__()
    assert cold.compiles == 1 and cold.compile_s > 1.0
    assert cold.compile_s <= cold.total_s
    assert lib.repro_coded_combine_groups(32) == combine_row_groups(32)
    with CompileWatch() as warm:
        _build.load_library.__wrapped__()
    assert warm.compiles == 0 and warm.compile_s < cold.compile_s
