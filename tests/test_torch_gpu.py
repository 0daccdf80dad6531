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
the CPU under the same rules, with ``times`` bit for bit.  Coded SGD:
the FRC update under two masks that keep one replica of every cluster is
equal bit for bit on the card; three coded steps on the card match the
same steps on the CPU to rel 1e-4 of the loss; the combine above 2^31
elements matches its plain version on column slices to rel 1e-5.  Past
one pass (FWHT and SRHT above N = 32 768, the fused gradient above
p = 16 384) the kernels hold to the same tolerances, and the fused
gradient's column-split form keeps batched rows equal to single calls bit
for bit on both its routes (a thread-block cluster, rows not whole 16-byte
units and bfloat16 at p = 100 000 included; the two-read route past the
cluster's capacity), one counted launch a call, its plan as the wrapper's
``wide_plan`` says.  The Hadamard kernels' routes (``fwht_plan``,
``srht_plan``):
FWHT and SRHT over a thread-block cluster up to N = 2^18 and the SRHT's
pruned window, each one launch a call, against their plain versions, a
column of a batched call equal bit for bit to a one-column call, two calls
equal bit for bit; the strided passes past 2^18; a cluster launch the card
refuses raises and counts no launch; the signed slot map the card builds
equals the host's, and a sign other than +-1 raises on every route.  The
serve path (every architecture's smoke variant: prefill and decode on the
card against the CPU, logits and caches to rel 1e-4, TF32 off) launches
no kernel of the port; the coded step through the MoE dispatch launches
one combine and matches the CPU's loss and gradient norm to rel 1e-4.
With two cards or more (the ``two_cards`` fixture skips below two): each
kernel launched with its operands on the last card while card 0 is
current equals the same call on card 0 bit for bit, operands on two
cards raise before any launch, and the sharded runners split the
realization axis over every card, bit for bit the batched run.
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
from repro_torch.kernels.encode import (srht_encode_call, srht_encode_plain,
                                        srht_plan)
from repro_torch.kernels.fused_step import (MAX_COLS, fused_masked_gradient,
                                            fused_masked_gradient_plain,
                                            pick_fused_realization_tile,
                                            wide_plan)
from repro_torch.kernels.fwht import (Plan, fwht_kernel_call, fwht_plain,
                                      fwht_plan)
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
        fwht_kernel_call(torch.ones((2, 3 * 32768), device=cuda))
    with pytest.raises(ValueError):
        fwht_kernel_call(torch.ones((8, 4), device=cuda).t())
    with pytest.raises(TypeError):
        fwht_kernel_call(torch.ones((2, 8), device=cuda, dtype=torch.float64))


@pytest.mark.parametrize("n", [65536, 131072, 262144, 1 << 19, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_kernel_multi_pass(cuda, n, dtype):
    """Past one pass (n > 32768): a thread-block cluster up to 2^18, the
    strided passes past it; one launch counted a call; a row of a batched
    call equals a one-row call, and two calls are equal, bit for bit."""
    assert fwht_plan(n).route == ("cluster" if n <= 1 << 18 else "passes")
    x = _randn((3, n), n, cuda, dtype)
    before = launches["fwht"]
    out = fwht_kernel_call(x)
    torch.cuda.synchronize()
    assert launches["fwht"] == before + 1 and out.dtype == dtype
    _close(out, fwht_plain(x), 1e-5 if dtype == torch.float32 else 2 ** -7)
    assert torch.equal(fwht_kernel_call(x[1:2].contiguous())[0], out[1])
    assert torch.equal(fwht_kernel_call(x), out)


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


@pytest.mark.parametrize("n,N,lo,hi", [(20000, 65536, 0, 65536),
                                       (32768, 65536, 2560, 3072),
                                       (40000, 65536, 100, 65000),
                                       (100000, 262144, 0, 262144),
                                       (130000, 262144, 10240, 12288)])
def test_srht_kernel_multi_pass(cuda, n, N, lo, hi):
    """Past one pass (N > 32768): the cluster route for the full frame and
    windows past 32 768 rows, the pruned route for the narrower windows;
    one launch counted a call."""
    rng = np.random.default_rng(n)
    cols = torch.tensor(rng.choice(N, n, replace=False).astype(np.int32),
                        device=cuda)
    signs = torch.tensor(rng.choice([-1.0, 1.0], n).astype(np.float32),
                         device=cuda)
    xt = _randn((5, n), n + 1, cuda)
    kw = dict(N=N, lo=lo, hi=hi, scale=n ** -0.5)
    before = launches["srht_encode"]
    out = srht_encode_call(xt, cols, signs, **kw)
    torch.cuda.synchronize()
    assert launches["srht_encode"] == before + 1
    _close(out, srht_encode_plain(xt, cols, signs, **kw), 1e-5)


def test_srht_kernel_partial_window_in_chunks(cuda, monkeypatch):
    """A partial window past the cluster's capacity, too wide to prune,
    takes its data columns a chunk at a time (here two frames a chunk, over
    5 columns): the same result."""
    import repro_torch.kernels.encode as encode
    N, n = 1 << 19, 300000
    monkeypatch.setattr(encode, "CHUNK_BYTES", 2 * N * 4)
    assert encode.srht_chunk_rows(5, N) == 2
    kw = dict(N=N, lo=4096, hi=70000, scale=n ** -0.5)
    assert srht_plan(n, N, kw["lo"], kw["hi"]).route == "passes"
    rng = np.random.default_rng(3)
    cols = torch.tensor(rng.choice(N, n, replace=False).astype(np.int32),
                        device=cuda)
    signs = torch.tensor(rng.choice([-1.0, 1.0], n).astype(np.float32),
                         device=cuda)
    xt = _randn((5, n), 4, cuda)
    _close(srht_encode_call(xt, cols, signs, **kw),
           srht_encode_plain(xt, cols, signs, **kw), 1e-5)


def _srht_inputs(n, N, p, seed, dev):
    rng = np.random.default_rng(seed)
    cols = torch.tensor(rng.choice(N, n, replace=False).astype(np.int32),
                        device=dev)
    signs = torch.tensor(rng.choice([-1.0, 1.0], n).astype(np.float32),
                         device=dev)
    return _randn((p, n), seed + 1, dev), cols, signs


@pytest.mark.parametrize("n,N,lo,hi,route", [
    (32768, 1 << 16, 0, 1 << 16, "cluster"),          # full frame
    (20001, 1 << 16, 0, 1 << 16, "cluster"),          # odd n
    (32768, 1 << 16, 2560, 3072, "pruned"),           # worker 5's window
    (32768, 1 << 16, 2561, 3001, "pruned"),           # misaligned
    (32768, 1 << 16, 32000, 33000, "cluster"),        # straddles N / 2
    (65536, 1 << 17, 0, 1 << 17, "cluster"),
    (65535, 1 << 17, 8192, 16384, "pruned"),          # aligned, odd n
    (65536, 1 << 17, 65000, 66000, "cluster"),
    (100000, 1 << 18, 0, 1 << 18, "cluster"),
    (130000, 1 << 18, 10240, 12288, "pruned"),        # aligned
    (100000, 1 << 18, 131000, 131500, "cluster"),
    (4096, 8192, 1280, 1536, "pruned"),               # PAPER_RIDGE worker 5
    (4096, 8192, 0, 8192, "one-pass"),
    (4096, 8192, 4000, 4200, "one-pass")])
def test_srht_kernel_routes(cuda, n, N, lo, hi, route):
    """Each route against the plain SRHT, one launch a call; column 2 of a
    batched call equals a one-column call, and two calls are equal, bit
    for bit."""
    assert srht_plan(n, N, lo, hi).route == route
    xt, cols, signs = _srht_inputs(n, N, 4, n + lo, cuda)
    kw = dict(N=N, lo=lo, hi=hi, scale=n ** -0.5)
    before = launches["srht_encode"]
    out = srht_encode_call(xt, cols, signs, **kw)
    torch.cuda.synchronize()
    assert launches["srht_encode"] == before + 1
    _close(out, srht_encode_plain(xt, cols, signs, **kw), 1e-5)
    assert torch.equal(srht_encode_call(xt[2:3].contiguous(), cols, signs,
                                        **kw)[0], out[2])
    assert torch.equal(srht_encode_call(xt, cols, signs, **kw), out)


@pytest.mark.parametrize("N,lo,hi", [(1 << 19, 0, 1 << 19),
                                     (1 << 20, 0, 1 << 20),
                                     (1 << 20, 1 << 18, 3 << 18)])
def test_srht_kernel_strided_route(cuda, N, lo, hi):
    """Past the cluster's 2^18 the segment and strided passes remain the
    route for a window too wide to prune."""
    n = N // 2 + 3
    assert srht_plan(n, N, lo, hi).route == "passes"
    xt, cols, signs = _srht_inputs(n, N, 2, N, cuda)
    kw = dict(N=N, lo=lo, hi=hi, scale=n ** -0.5)
    _close(srht_encode_call(xt, cols, signs, **kw),
           srht_encode_plain(xt, cols, signs, **kw), 1e-5)


def test_refused_cluster_launch_raises(cuda, monkeypatch):
    """A cluster of 16 CTAs is past the portable size, and no kernel here
    opts in to more: the card refuses the launch, and each wrapper raises
    and counts no launch rather than take another route."""
    import importlib
    encode = importlib.import_module("repro_torch.kernels.encode")
    # the package's name ``fwht`` is the op, not the module
    fwht = importlib.import_module("repro_torch.kernels.fwht")
    N = 1 << 18
    sixteen = Plan("cluster", 16, N // 16)
    monkeypatch.setattr(fwht, "fwht_plan", lambda n: sixteen)
    monkeypatch.setattr(encode, "srht_plan", lambda n, N, lo, hi: sixteen)
    x = _randn((2, N), 1, cuda)
    before = dict(launches)
    with pytest.raises(RuntimeError, match="failed to launch"):
        fwht_kernel_call(x)
    xt, cols, signs = _srht_inputs(1000, N, 2, 5, cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        srht_encode_call(xt, cols, signs, N=N, lo=0, hi=N, scale=1.0)
    assert dict(launches) == before


@pytest.mark.parametrize("n,N,lo,hi", [(4096, 8192, 0, 8192),
                                       (4096, 8192, 1280, 1536),
                                       (32768, 1 << 16, 0, 1 << 16),
                                       (300000, 1 << 19, 0, 1 << 19)])
def test_srht_kernel_signed_slot_map(cuda, n, N, lo, hi):
    """On every route (one pass, pruned, cluster, passes): the map built on
    the card equals the one built on the host; a call given it equals a
    call that builds its own, bit for bit, and counts one launch; a sign
    other than +-1 raises before any launch."""
    import repro_torch.kernels.encode as encode
    xt, cols, signs = _srht_inputs(n, N, 3, n, cuda)
    smap = encode.srht_signed_slot_map(cols, signs, N)
    assert torch.equal(smap.cpu(), encode.srht_signed_slot_map(
        cols.cpu(), signs.cpu(), N))
    kw = dict(N=N, lo=lo, hi=hi, scale=n ** -0.5)
    before = launches["srht_encode"]
    out = srht_encode_call(xt, cols, signs, smap=smap, **kw)
    torch.cuda.synchronize()
    assert launches["srht_encode"] == before + 1
    assert torch.equal(out, srht_encode_call(xt, cols, signs, **kw))
    bad = signs.clone()
    bad[n // 2] = 0.5
    before = launches["srht_encode"]
    with pytest.raises(ValueError, match="signs of"):
        srht_encode_call(xt, cols, bad, **kw)
    assert launches["srht_encode"] == before


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
    """Rows wider than the one-read form's registers (p = 16385) take the
    column-split form: one launch counted, the plain version's result."""
    SX, Sy, W, masks = _fused(cuda, 2, 2, 16385, R=1)
    masks[:, 0] = 1.0
    before = launches["fused_masked_gradient"]
    out = fused_masked_gradient(SX, Sy, W, masks, n=2, beta=2.0)
    torch.cuda.synchronize()
    assert launches["fused_masked_gradient"] == before + 1
    _close(out, fused_masked_gradient_plain(SX, Sy, W, masks, n=2,
                                            beta=2.0), 1e-4)


@pytest.mark.parametrize("m,r,p", [(4, 8, 16385), (5, 24, 20000),
                                   (8, 512, 100000), (3, 7, 16385)])
@pytest.mark.parametrize("R", [1, 4, 9])
def test_fused_kernel_wide_batched_and_single(cuda, m, r, p, R):
    """The column-split form: batched rows equal single calls bit for bit;
    worker 1 is masked out in every realization and, for R > 1, the last
    realization is all-masked."""
    SX, Sy, W, masks = _fused(cuda, m, r, p, R, seed=p + R)
    W *= 0.01
    masks[:, 1] = 0.0
    masks[:, 0] = 1.0
    if R > 1:
        masks[-1] = 0.0
    kw = dict(n=m * r // 2, beta=2.0)
    out = fused_masked_gradient(SX, Sy, W, masks, **kw)
    _close(out, fused_masked_gradient_plain(SX, Sy, W, masks, **kw), 1e-4)
    for q in range(R):
        assert torch.equal(out[q], fused_masked_gradient(SX, Sy, W[q],
                                                         masks[q], **kw))
    if R > 1:
        assert torch.count_nonzero(out[-1]) == 0


def test_fused_kernel_wide_bf16(cuda):
    SX, Sy, W, masks = _fused(cuda, 4, 8, 16385, R=3, dtype=torch.bfloat16)
    kw = dict(n=16, beta=2.0)
    out = fused_masked_gradient(SX, Sy, W, masks, **kw)
    assert out.dtype == torch.bfloat16
    _close(out, fused_masked_gradient_plain(SX, Sy, W, masks, **kw), 2 ** -7)
    for q in range(3):
        assert torch.equal(out[q], fused_masked_gradient(SX, Sy, W[q],
                                                         masks[q], **kw))


def _wide_launch_checked(SX, Sy, W, masks, kw, tol):
    """One counted launch a wrapper call; the plain version's result to
    ``tol``; every batched row equal to its single call bit for bit."""
    before = launches["fused_masked_gradient"]
    out = fused_masked_gradient(SX, Sy, W, masks, **kw)
    torch.cuda.synchronize()
    assert launches["fused_masked_gradient"] == before + 1
    _close(out, fused_masked_gradient_plain(SX, Sy, W, masks, **kw), tol)
    for q in range(W.shape[0]):
        before = launches["fused_masked_gradient"]
        assert torch.equal(out[q], fused_masked_gradient(SX, Sy, W[q],
                                                         masks[q], **kw))
        assert launches["fused_masked_gradient"] == before + 1
    return out


@pytest.mark.parametrize("p,dtype", [(16387, torch.float32),
                                     (16386, torch.float32),
                                     (50001, torch.float32),
                                     (16387, torch.bfloat16),
                                     (16390, torch.bfloat16)])
def test_fused_kernel_wide_unaligned_rows(cuda, p, dtype):
    """Rows that are not whole 16-byte units on the cluster route: the
    slices still start on 16-byte boundaries, the rows reach the ring by
    4-byte copies (float32, even bfloat16) or plain loads (odd bfloat16),
    and the last CTA's slice ends mid-vector."""
    assert wide_plan(p, torch.empty((), dtype=dtype).element_size()).route \
        == "cluster"
    SX, Sy, W, masks = _fused(cuda, 5, 12, p, R=3, dtype=dtype, seed=p)
    masks[:, 0] = 1.0
    masks[:, 3] = 0.0
    _wide_launch_checked(SX, Sy, W, masks, dict(n=30, beta=2.0),
                         1e-4 if dtype == torch.float32 else 2 ** -7)


def test_fused_kernel_wide_bf16_at_path_width(cuda):
    """bfloat16 at the wide path's p = 100 000 (a slice of 12 504 columns,
    a ring of eight), batched over a tile and a half, the last realization
    all-masked."""
    SX, Sy, W, masks = _fused(cuda, 6, 16, 100000, R=3,
                              dtype=torch.bfloat16, seed=5)
    W = (W.float() * 0.01).to(torch.bfloat16)
    masks[:, 0] = 1.0
    masks[-1] = 0.0
    out = _wide_launch_checked(SX, Sy, W, masks, dict(n=48, beta=2.0),
                               2 ** -7)
    assert out.dtype == torch.bfloat16
    assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.parametrize("p,dtype", [(152897, torch.float32),
                                     (155649, torch.bfloat16)])
def test_fused_kernel_past_cluster_capacity(cuda, p, dtype):
    """Past the cluster's capacity (three slices no longer fit one CTA, or
    no listed vector count holds a slice) the width takes the two-read
    route, one counted launch a call, no silent switch of forms."""
    assert wide_plan(p, torch.empty((), dtype=dtype).element_size()).route \
        == "two-read"
    SX, Sy, W, masks = _fused(cuda, 2, 2, p, R=2, dtype=dtype, seed=7)
    masks[:, 0] = 1.0
    _wide_launch_checked(SX, Sy, W, masks, dict(n=2, beta=2.0),
                         1e-4 if dtype == torch.float32 else 2 ** -7)


def test_fused_wide_plan_matches_kernel(cuda):
    """The kernel's own plan (``repro_fused_wide_plan``) equals the
    wrapper's ``wide_plan`` field by field, at every 13th width from
    MAX_COLS + 1 to 2^20 and at the capacity edges, in both dtypes."""
    lib = load_library()
    widths = list(range(MAX_COLS + 1, (1 << 20) + 1, 13)) + [
        152896, 152897, 155648, 155649]
    for p in widths:
        for itemsize in (4, 2):
            plan = wide_plan(p, itemsize)
            want = [int(plan.route == "cluster"), plan.C, plan.slice_cols,
                    plan.threads, plan.vectors, plan.tile, plan.slots]
            got = [lib.repro_fused_wide_plan(p, itemsize, f)
                   for f in range(7)]
            assert got == want, (p, itemsize)


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
    """At p = MAX_COLS + 1 the fused branch launches the fused kernel's
    column-split form (the refusal that named REPRO_FUSED=0 is gone); its
    trace matches the same run under REPRO_FUSED=0 (the combine path) and
    on the CPU."""
    from repro_torch.core import run_encoded_gd
    p = MAX_COLS + 1
    SX, Sy, _, _ = _fused(cuda, 4, 2, p, R=1, seed=1)
    prob = EncodedProblem(SX=SX, Sy=Sy, X=_randn((8, p), 2, cuda),
                          y=_randn((8,), 3, cuda), lam=0.1, beta=1.0, n=8)
    masks = np.ones((3, 4), np.float32)
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    before = dict(launches)
    w_f, tr_f = run_encoded_gd(prob, masks, 1e-4)
    assert _launched(before) == {FUSED: 3}
    monkeypatch.setenv("REPRO_FUSED", "0")
    before = dict(launches)
    w, tr = run_encoded_gd(prob, masks, 1e-4)
    assert _launched(before) == {COMB: 3}
    assert w.is_cuda and np.isfinite(tr).all()
    _close(torch.as_tensor(tr_f), torch.as_tensor(tr), 1e-5)
    _close(w_f.cpu(), w.cpu(), 1e-5)
    w_c, tr_c = run_encoded_gd(prob, masks, 1e-4, device="cpu")
    _close(torch.as_tensor(tr_f), torch.as_tensor(tr_c), 1e-5)


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
    """Through ``execute`` on the card, GD cells at p = MAX_COLS + 1 run on
    the fused kernel's column-split form (they were skip records naming
    REPRO_FUSED=0), and their objectives match the same cells under
    REPRO_FUSED=0, on the combine kernel."""
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
    fused = execute(plan(spec), record_to=False)
    torch.cuda.synchronize()
    assert _launched(before).get(FUSED, 0) >= 2 * 2
    monkeypatch.setenv("REPRO_FUSED", "0")
    before = dict(launches)
    out = execute(plan(spec), record_to=False)
    torch.cuda.synchronize()
    assert _launched(before).get(COMB, 0) >= 2 * 2
    assert FUSED not in _launched(before)
    for f, rec in zip(fused.records, out.records):
        assert "skipped" not in f and "skipped" not in rec
        assert f["times"] == rec["times"]
        _close(torch.tensor(f["objective"]), torch.tensor(rec["objective"]),
               1e-5)


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


# ---------------------------------------------------------------------------
# coded SGD on the card
# ---------------------------------------------------------------------------

def _coded_setup(dev, code_name="frc"):
    from repro_torch.core import make_code
    from repro_torch.data import GroupBatcher, TokenStream
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.train import TrainProblem, build_coded_train_step
    cfg = TrainProblem(seq_len=32, vocab=128).build_cfg()
    code = make_code(code_name, 8, beta=2)
    batcher = GroupBatcher(TokenStream(cfg.vocab, seed=0), code, 1, 32,
                           seed=0)
    step = build_coded_train_step(cfg, cosine_schedule(1e-3, 2, 10),
                                  rows_per_group=1,
                                  num_groups=code.num_groups)
    params = init_params(cfg, 0, device=dev)
    return code, batcher, step, params, adamw_init(params)


def _tensors(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def test_frc_update_bit_for_bit_on_card(cuda):
    """Two masks that keep one replica of every FRC cluster give the same
    parameters and loss bit for bit on the card (replicas' gradients are
    computed alike, with no atomics), one combine launch a step."""
    from repro_torch.tree import tree_leaves
    code, batcher, step, params, opt = _coded_setup(cuda)
    batch = _tensors(cuda, *batcher.next_batch())
    outs = []
    for mask in ([1, 1, 1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 1, 1, 1, 1]):
        d = _tensors(cuda, code.decode_weights(np.asarray(mask, float)))[0]
        before = dict(launches)
        outs.append(step(params, opt, *batch, d))
        torch.cuda.synchronize()
        assert _launched(before) == {COMB: 1}
    for a, b in zip(tree_leaves(outs[0][:2]), tree_leaves(outs[1][:2])):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])


@pytest.mark.parametrize("code_name", ["frc", "cyclic"])
def test_coded_steps_on_card_match_cpu(cuda, code_name):
    """Three steps on the card and on the CPU from the same parameters:
    losses rel 1e-4 (float32 sums in another order through AdamW's
    steps)."""
    from repro_torch.tree import tree_map
    code, batcher, step, params, opt = _coded_setup(cuda, code_name)
    cpu_p = tree_map(lambda t: t.cpu(), params)
    cpu_o = tree_map(lambda t: t.cpu(), opt)
    rng = np.random.default_rng(0)
    got = []
    for t in range(3):
        batch = batcher.next_batch(code.at_step(t))
        mask = (rng.random(8) < 0.75).astype(float)
        d = code.at_step(t).decode_weights(mask)
        params, opt, gm = step(params, opt, *_tensors(cuda, *batch, d))
        cpu_p, cpu_o, cm = step(cpu_p, cpu_o, *_tensors("cpu", *batch, d))
        got.append((float(gm["loss"]), float(cm["loss"])))
    g, c = np.asarray(got).T
    assert np.max(np.abs(g - c)) <= 1e-4 * np.max(np.abs(c))


def test_coded_sgd_strategy_on_card(cuda):
    """The strategy entry point with the device unset runs on the card:
    one combine launch a step and nothing else of the port's kernels; a
    seed gives the same parameters on both devices, so the same call with
    ``device="cpu"`` has the same times and losses to rel 1e-4."""
    from repro_torch.runtime import ClusterEngine, get_strategy
    from repro_torch.core import bimodal_delays
    from repro_torch.train import TrainProblem
    run = lambda **kw: get_strategy("coded-sgd").run(  # noqa: E731
        TrainProblem(seq_len=16, vocab=64),
        ClusterEngine(bimodal_delays(), 8, seed=0), steps=4, k=6, **kw)
    before = dict(launches)
    res = run()
    torch.cuda.synchronize()
    assert _launched(before) == {COMB: 4}
    cpu = run(device="cpu")
    assert np.array_equal(res.times, cpu.times)
    _close(torch.tensor(res.objective), torch.tensor(cpu.objective), 1e-4)


def test_init_params_same_on_card_and_cpu(cuda):
    from repro_torch.models import init_params
    from repro_torch.train import TrainProblem
    from repro_torch.tree import tree_leaves
    cfg = TrainProblem(seq_len=16, vocab=64).build_cfg()
    for a, b in zip(tree_leaves(init_params(cfg, 3)),
                    tree_leaves(init_params(cfg, 3, device="cpu"))):
        assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("P", [(1 << 28) + 4, (1 << 28) + 5])
def test_combine_above_2_31_elements(cuda, P):
    """m * P above 2^31: the kernel's row offsets are 64-bit.  The output
    on column slices at the start, the middle and the end matches the plain
    version on those columns (rel 1e-5); P + 4 takes the 16-byte loads, P +
    5 the element-wise path."""
    m = 8
    assert m * P > 2 ** 31
    g = torch.empty((m, P), device=cuda)
    for i in range(m):
        g[i].normal_(generator=torch.Generator(device=cuda).manual_seed(i))
    c = torch.rand(m, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(9))
    out = coded_combine_call(g, c)
    for lo in (0, P // 2 - 77, P - 4099):
        sl = slice(lo, lo + 4099)
        _close(out[sl], coded_combine_ref(g[:, sl].contiguous(), c), 1e-5)


# ---------------------------------------------------------------------------
# the model zoo's serve path (no kernel of the port runs on it)
# ---------------------------------------------------------------------------

def _serve(cfg, host, dev, B=2, S=32, new=4):
    """prefill + ``new`` teacher-forced decode steps on ``dev`` from the
    host parameters -> (logits (B, 1 + new, V) on the host, caches)."""
    from repro_torch.device import full_f32_matmul
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve import serve_inputs
    from repro_torch.tree import tree_map

    @full_f32_matmul
    def run():
        params = tree_map(lambda t: t.to(dev), host)
        rng = np.random.default_rng(0)
        prompts, kw = serve_inputs(cfg, B, S, rng, dev)
        forced = torch.as_tensor(rng.integers(0, cfg.vocab, (B, new)),
                                 device=dev)
        with torch.no_grad():
            lg, caches = prefill(params, cfg, prompts, cache_len=S + new,
                                 **kw)
            out = [lg]
            for i in range(new):
                lg, caches = decode_step(params, cfg, forced[:, i:i + 1],
                                         caches, S + i)
                out.append(lg)
        return torch.cat(out, dim=1).cpu(), caches
    return run()


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-7b", "gemma2-27b",
                                  "jamba-1.5-large-398b",
                                  "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b",
                                  "stablelm-12b", "starcoder2-3b",
                                  "whisper-small", "xlstm-350m"])
def test_serve_paths_on_card_match_cpu(cuda, arch):
    """Every architecture's smoke variant: prefill and four decode steps on
    the card against the same on the CPU from the same parameters (TF32
    off), logits and every cache leaf to rel 1e-4 (float32 sums in other
    orders), caches of equal structure; no kernel of the port launches."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves
    cfg = ARCHS[arch].smoke_variant()
    host = init_params(cfg, 0, device="cpu")
    before = dict(launches)
    lc, cc = _serve(cfg, host, cuda)
    torch.cuda.synchronize()
    assert dict(launches) == before
    lh, ch = _serve(cfg, host, torch.device("cpu"))
    _close(lc, lh, 1e-4)
    a, b = tree_leaves(cc), tree_leaves(ch)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.is_cuda and x.shape == y.shape and x.dtype == y.dtype
        _close(x.cpu(), y, 1e-4)


def test_serve_bfloat16_on_card_runs(cuda):
    """gemma2's smoke variant in its own bfloat16: prefill and decode
    finite on the card, the greedy tokens of a bfloat16 run equal on a
    second run (the path is deterministic on one card)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    cfg = ARCHS["gemma2-27b"].smoke_variant().with_overrides(
        dtype="bfloat16", param_dtype="bfloat16")
    host = init_params(cfg, 0, device="cpu")
    l1, _ = _serve(cfg, host, cuda)
    l2, _ = _serve(cfg, host, cuda)
    assert torch.isfinite(l1).all() and torch.equal(l1, l2)


def test_serve_main_on_card(cuda, capsys):
    from repro_torch.serve import main
    assert main(["--arch", "phi3.5-moe-42b-a6.6b", "--prompt-len", "32",
                 "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("prefill: 4x32 in ") and "tok/s" in out


def test_coded_step_over_moe_on_card_matches_cpu(cuda):
    """The coded step at phi3.5-moe's smoke variant (workers batched by
    ``torch.func.vmap`` through the MoE dispatch): one combine launch, the
    loss and the gradient norm on the card match the CPU's to rel 1e-4."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.gradient_coding import make_code
    from repro_torch.data.pipeline import GroupBatcher, TokenStream
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.train import build_coded_train_step
    from repro_torch.tree import tree_map
    cfg = ARCHS["phi3.5-moe-42b-a6.6b"].smoke_variant().with_overrides(
        vocab=64)
    code = make_code("frc", 8, beta=2)
    step = build_coded_train_step(cfg, cosine_schedule(1e-3, 2, 10),
                                  rows_per_group=1,
                                  num_groups=code.num_groups)
    tokens, labels, coeff = GroupBatcher(TokenStream(64, seed=0), code, 1,
                                         16, seed=0).next_batch()
    d = code.decode_weights(np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float64))
    host = init_params(cfg, 0, device="cpu")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev), host)
        args = [torch.from_numpy(np.asarray(a)).to(dev) for a in
                (tokens, labels, coeff, np.asarray(d, np.float32))]
        before = launches["coded_combine"]
        p2, _, m = step(params, adamw_init(params), *args)
        out[dev.type] = (p2, m)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert launches["coded_combine"] == before + 1
    mc, mh = out["cuda"][1], out["cpu"][1]
    _close(mc["loss"].cpu(), mh["loss"], 1e-4)
    _close(mc["grad_norm"].cpu(), mh["grad_norm"], 1e-4)


# ---------------------------------------------------------------------------
# More than one card: each kernel launches on its operands' card
# ---------------------------------------------------------------------------

@pytest.fixture
def two_cards():
    """Card 0 and the last card; skips below two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", 0), torch.device(
        "cuda", torch.cuda.device_count() - 1)


def _kernel_case(name):
    """(call, host operands) of one kernel at a shape that reaches its
    per-card launch settings (SM count, shared-memory opt-in, cluster
    occupancy)."""
    g = torch.Generator().manual_seed(0)
    if name.startswith("fused"):
        m, r, p = (8, 64, 6000) if name == "fused" else (8, 32, 100_000)
        masks = (torch.rand((4, m), generator=g) < 0.75).float()
        return (lambda SX, Sy, W, mk: fused_masked_gradient(
            SX, Sy, W, mk, n=m * r, beta=2.0),
            [torch.randn((m, r, p), generator=g),
             torch.randn((m, r), generator=g),
             torch.randn((4, p), generator=g) * 0.01, masks])
    if name.startswith("fwht"):
        n = 8192 if name == "fwht" else 65536
        return fwht_kernel_call, [torch.randn((6, n), generator=g)]
    if name.startswith("srht"):
        n, N, lo, hi = ((4000, 8192, 1280, 1536) if name == "srht"
                        else (40000, 65536, 0, 65536))
        cols = torch.randperm(N, generator=g)[:n].sort().values.int()
        signs = torch.randint(0, 2, (n,), generator=g).float() * 2 - 1
        return (lambda xt, c, s: srht_encode_call(
            xt, c, s, N=N, lo=lo, hi=hi, scale=n ** -0.5),
            [torch.randn((5, n), generator=g), cols, signs])
    return coded_combine_call, [torch.randn((32, 6000), generator=g),
                                torch.rand(32, generator=g)]


KERNEL_CASES = ["fused", "fused_wide", "fwht", "fwht_cluster", "srht",
                "srht_cluster", "combine"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_on_the_last_card_equals_card_zero(two_cards, name):
    """Operands on the last card while card 0 is current: the result
    equals the same call on card 0 bit for bit, and card 0 stays current."""
    first, last = two_cards
    call, host = _kernel_case(name)
    outs = []
    for dev in (first, last):
        with torch.cuda.device(first):
            out = call(*[t.to(dev) for t in host])
            assert torch.cuda.current_device() == 0
        assert out.device == dev
        torch.cuda.synchronize(dev)
        outs.append(out.cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("name", ["fused", "srht", "combine"])
def test_kernel_operands_on_two_cards_raise(two_cards, name):
    first, last = two_cards
    call, host = _kernel_case(name)
    ops = [t.to(first) for t in host]
    ops[-1] = ops[-1].to(last)
    before = dict(launches)
    with pytest.raises(ValueError, match="on cuda"):
        call(*ops)
    assert dict(launches) == before


def test_sharded_runners_split_over_every_card(two_cards):
    """The realization axis over every visible card: equal to the batched
    run bit for bit, ``placement_devices`` the card count."""
    from repro_torch.runtime import runners
    first, _ = two_cards
    ndev = torch.cuda.device_count()
    g = torch.Generator().manual_seed(1)
    m, r, p, n, R = 8, 64, 600, 512, 2 * ndev
    prob = EncodedProblem(SX=torch.randn((m, r, p), generator=g),
                          Sy=torch.randn((m, r), generator=g),
                          X=torch.randn((n, p), generator=g),
                          y=torch.randn(n, generator=g), lam=0.05, beta=1.0,
                          n=n).to(first)
    masks = (torch.rand((R, 10, m), generator=g) < 0.75).float()
    w0 = torch.zeros((R, p), device=first)
    assert runners.trials_device_count(R, first) == ndev
    before = launches["fused_masked_gradient"]
    w, tr, got = runners.sharded_scan_gd(prob, masks, 1e-3, w0)
    torch.cuda.synchronize()
    assert got == ndev and w.device == first
    assert launches["fused_masked_gradient"] == before + 10 * ndev
    wb, tb = runners.batched_scan_gd(prob, masks, 1e-3, w0)
    assert torch.equal(w, wb) and torch.equal(tr, tb)
