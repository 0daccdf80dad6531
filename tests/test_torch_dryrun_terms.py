"""The dry run's terms that read the partitioned program
(``repro_torch.launch.roofline``, ``launch.dryrun``, ``graphs.counting``)
against the whole trace and against the JAX package's compiled step on
the CPU.

Tolerances:
  * exact: the flops by operator, with the remat recompute, of a train
    and a prefill step whose loops are counted as one body times the trip
    count (``graphs.counting``) against the same step traced block by
    block, at the smoke variants of jamba (Mamba and attention's KV
    chunks), xlstm-350m (mLSTM chunks; the sLSTM token loop counted a
    token a block against 3 blocks of 8 and a shorter one) and gemma2-27b
    (attention only, local and global layers), each chunk loop at least
    5 blocks under ``"full"``;
  * exact: ``alias_bytes_per_device``'s rule (``roofline.alias_bytes``: the
    arguments the step writes in place and returns) against the
    reference's ``memory_analysis().alias_size_in_bytes`` of
    ``jax.jit(step, donate_argnums=...)`` at deepseek-7b's smoke variant:
    train (parameters, AdamW moments and count; XLA aliases every donated
    buffer) and decode (the caches);
  * bands: the live-bytes tracker's peak (``roofline.LiveBytes``, what
    ``temp_bytes_per_device`` reads) beside the reference's
    ``temp_size_in_bytes`` of the same step: train under ``"none"`` 1.0-2.0
    (measured 1.56: the port keeps each operator's output as PyTorch
    allocates it, where XLA fuses elementwise chains into one buffer),
    under ``"full"`` 2.0-4.0 (2.93: the reference's remat keeps only each
    period's carry, the port's eager program every activation the
    backward reads), decode 0.1-0.5 (0.17: XLA casts the whole cache to
    float32 for the scores, the port one KV chunk at a time); with loops
    counted by trip count, the tracker's peak equals the whole trace's
    for a prefill and is 0.8-1.0 of it for a train step (measured
    0.86-0.95: a run of like blocks' backward temporaries are seen once);
  * exact: the tracker's peak over a few operators on the CPU.
"""
import functools
import gc

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

import repro.configs as JCONF
import repro.launch.specs as JSP
import repro.models.transformer as JT
import repro.optim as JO
import repro.train.steps as JST
import repro_torch.models.transformer as PT
import repro_torch.models.xlstm as xl
from repro_torch import graphs
from repro_torch.configs import ARCHS
from repro_torch.launch import make_local_mesh
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.roofline import (LiveBytes, alias_bytes, count_flops,
                                        held_bytes)
from repro_torch.launch.specs import _extras_struct, cache_struct, \
    param_structs
from repro_torch.optim import adamw_init
from repro_torch.sharding import make_shardings
from repro_torch.train.steps import place_train_state

B, S = 4, 64


def _batch(cfg, b, s, kind="train"):
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    out = {"tokens": tok, **_extras_struct(cfg, b, s)}
    if kind == "train":
        out["labels"] = torch.empty((b, s), dtype=torch.int32, device="meta")
        out["weights"] = torch.empty((b,), device="meta")
    return out


# ---------------------------------------------------------------------------
# loops: one body times the trip count == the whole loop traced
# ---------------------------------------------------------------------------

# (arch, chunk of the Mamba / mLSTM and attention loops, sequence):
# every chunk loop 6 blocks or more, none ending in a shorter block (the
# chunk loops pad or need whole chunks); xlstm-350m's sLSTM, counted a
# token a block (``per_position``), traced whole in blocks of
# ``SLSTM_BLOCK`` tokens: 3 full and a shorter last one in 28.  The toy
# loop below holds a shorter last block counted by trip count
LOOPS = {"jamba-1.5-large-398b": (8, 48),
         "xlstm-350m": (4, 28),
         "gemma2-27b": (8, 48)}
SLSTM_BLOCK = 8


def _trace(cfg, kind, s, loops):
    params = param_structs(cfg)
    inputs = _batch(cfg, 2, s, kind)
    opt = adamw_init(params) if kind == "train" else None
    live = LiveBytes(known=(params, opt, inputs))
    counts, _ = trace_step(cfg, kind, params, inputs, s, opt=opt,
                           loops=loops, live=live)
    return counts, live.peak


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", sorted(LOOPS))
def test_loops_by_trip_count_equal_the_whole_trace(monkeypatch, arch, kind):
    chunk, s = LOOPS[arch]
    monkeypatch.setattr(xl, "_SLSTM_BLOCK", SLSTM_BLOCK)
    cfg = ARCHS[arch].smoke_variant().with_overrides(
        mamba_chunk=chunk, attn_chunk=chunk, remat_policy="full")
    runs = []                             # the blocks each block stood for
    counted_scan = graphs._counted_scan

    def spy(block, consts, xs, held, length, c, hook):
        def counted(run, times, alone):
            runs.append(times)
            return hook(run, times, alone)
        return counted_scan(block, consts, xs, held, length, c, counted)

    monkeypatch.setattr(graphs, "_counted_scan", spy)
    counted, peak = _trace(cfg, kind, s, loops=True)
    assert max(runs) > 1, "no run of blocks was counted as one"
    n_runs = len(runs)
    whole, whole_peak = _trace(cfg, kind, s, loops=False)
    assert len(runs) == n_runs            # the whole trace runs every block
    assert counted == whole
    assert counted["total"] > 0
    assert (counted["remat"] > 0) == (kind == "train")
    if kind == "prefill":
        assert peak == whole_peak
    else:
        assert 0.8 * whole_peak <= peak <= whole_peak, (peak, whole_peak)


def _toy_block(consts, xs, carry):
    """A recurrence with products in its body: h <- tanh(h W + x U)."""
    (w, u), (x,), (h,) = consts, xs, carry
    hs = []
    for t in range(x.shape[1]):
        h = torch.tanh(h @ w + x[:, t] @ u)
        hs.append(h)
    return (torch.stack(hs, dim=1),), (h,)


@pytest.mark.parametrize("grad", [True, False])
def test_a_shorter_last_block_counts_as_its_own_body(grad):
    """23 positions in blocks of 4 (5 full, one of 3), forward and, under
    ``torch.func.grad``, backward: the flops and the live-bytes peak
    counted by trip count against the loop traced block by block."""
    w, u = (torch.empty(16, 16, device="meta") for _ in range(2))
    x = torch.empty(2, 23, 16, device="meta")

    def loss(w, u):
        h0 = torch.zeros(2, 16, device="meta")
        ys, (h,) = graphs.scan("toy", _toy_block, (w, u), (x,), (h0,),
                               length=23, c=4, static=())
        return torch.cat([y for (y,) in ys], dim=1).sum() + h.sum()

    run = ((lambda: torch.func.grad(loss, argnums=(0, 1))(w, u)) if grad
           else (lambda: loss(w, u)))

    def trace(loops):
        live = LiveBytes(known=(w, u, x))
        return count_flops(run, loops=loops, live=live), live.peak

    runs = []

    def spy(run, times, alone):
        runs.append(times)
        return run()

    (counted, by_op), peak = trace(True)
    (whole, whole_by_op), whole_peak = trace(False)
    assert counted == whole and by_op == whole_by_op
    # a product of (2, 16) by (16, 16) is 1024 flops: 2 a position forward;
    # backward d w, d u and d h_{t-1} (none at t = 0: h0 needs no
    # gradient), never d x
    mm = 2 * 2 * 16 * 16
    assert counted == 23 * 2 * mm + ((23 * 3 - 1) * mm if grad else 0)
    with graphs.counting(spy):
        run()
    # block 0 (its carry the initial state), under grad block 1 (the carry
    # now requires grad), one block for the rest of the full blocks but
    # the last, the last full block, the block of 3
    assert runs == ([1, 1, 2, 1, 1] if grad else [1, 3, 1, 1])
    if grad:
        assert 0.8 * whole_peak <= peak <= whole_peak
    else:
        assert peak == whole_peak


# ---------------------------------------------------------------------------
# alias and temp bytes beside the reference's memory analysis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    m = make_local_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _ref_memory(kind, policy="full"):
    cfg = JCONF.ARCHS["deepseek-7b"].smoke_variant().with_overrides(
        remat_policy=policy)
    params = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.key(0)))
    if kind == "train":
        tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
        batch = {"tokens": tok, "labels": tok,
                 "weights": jax.ShapeDtypeStruct((B,), jnp.float32)}
        step = JST.build_train_step(cfg, JO.cosine_schedule(3e-4, 100,
                                                            10000))
        lowered = jax.jit(step, donate_argnums=(0, 1)).lower(
            params, jax.eval_shape(JO.adamw_init, params), batch)
    else:
        lowered = jax.jit(JST.build_decode_step(cfg),
                          donate_argnums=(2,)).lower(
            params, jax.ShapeDtypeStruct((2, 1), jnp.int32),
            JSP.cache_struct(cfg, 2, 2 * S), jax.ShapeDtypeStruct(
                (), jnp.int32))
    return lowered.compile().memory_analysis()


def _port_memory(mesh, kind, policy="full"):
    """(alias bytes, the tracker's peak) of the port's step at the same
    shapes, as the dry run reads them (one device: whole leaves)."""
    cfg = ARCHS["deepseek-7b"].smoke_variant().with_overrides(
        remat_policy=policy)
    params = param_structs(cfg)
    if kind == "train":
        sh = make_shardings(mesh, params, PT.param_axes(cfg))
        params, opt = place_train_state(params, adamw_init(params), sh)
        inputs = _batch(cfg, B, S)
        args = held_bytes(params) + held_bytes(opt) + held_bytes(inputs)
        step_in = dict(opt=opt, grad_specs=sh)
        seq = S
    else:
        token = torch.empty((2, 1), dtype=torch.int32, device="meta")
        inputs = (token, cache_struct(cfg, 2, 2 * S), None)
        args = held_bytes(params) + held_bytes(inputs[:2])
        step_in = {}
        seq = 2 * S
    live = LiveBytes(known=[t for t, _ in args])
    _, out = trace_step(cfg, kind, params, inputs, seq, live=live,
                        **step_in)
    return alias_bytes(args, out), live.peak


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_alias_bytes_equal_reference(mesh, kind):
    ref = _ref_memory(kind)
    alias, _ = _port_memory(mesh, kind)
    assert ref.alias_size_in_bytes > 0
    assert alias == ref.alias_size_in_bytes


@pytest.mark.parametrize("kind,policy,band", [
    ("train", "none", (1.0, 2.0)),
    ("train", "full", (2.0, 4.0)),
    ("decode", "full", (0.1, 0.5))])
def test_temp_bytes_beside_reference(mesh, kind, policy, band):
    ref = _ref_memory(kind, policy).temp_size_in_bytes
    _, peak = _port_memory(mesh, kind, policy)
    assert band[0] <= peak / ref <= band[1], (peak, ref, peak / ref)


def test_live_bytes_counts_new_storages_alive_at_once():
    x = torch.ones(256)                       # an argument: not counted
    with LiveBytes(known=x) as live:
        a = x * 2                             # 1024 bytes
        b = a + 1                             # 2048 alive
        v = b.view(16, 16)                    # a view: nothing new
        b.add_(1)                             # in place: nothing new
        del a
        gc.collect()
        c = torch.cat([v, v])                 # 1024 + 2048 alive
        assert live.live == 3072
        del b, v, c
        gc.collect()
    assert live.peak == 3072 and live.live == 0
