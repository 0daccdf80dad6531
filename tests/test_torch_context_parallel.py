"""Context-parallel decode (``sharding.seq_on_data``, ``tp.data_axis``,
``models.attention.merged_attention``) on the CPU.

At a batch the mesh's data axes do not take (batch 1 here, long_500k's in
the dry run) each attention cache whose length the data axes divide holds
its sequence there: rank r of n keeps slots [r C / n, (r + 1) C / n),
prefill (computed whole on every rank) hands each rank its slots, a decode
step writes the new key only on the rank that owns its slot, and the
softmax is merged over the data group.

* Gloo spawns of 2 ranks on a (2, 1) mesh and of 4 on (2, 2) (data 2,
  model 2: the heads, ff, experts and Mamba channels on ``model`` too), at
  smoke variants, batch 1, teacher-forced on numpy-seeded tokens from the
  JAX package's parameters (``jax.random.key(0)``, carried across with
  ``params_from_numpy``):
  - gemma2-27b with its local window cut to 8 and a prompt of 16: the
    ring wraps during decode; a cache of 22 (both layers split) and of 23
    (the global layer's cache stays whole: 2 does not divide it); a cache
    of 256 (the chunk loop on the whole cache and on each shard) and of
    128 (the chunk loop on the whole cache, the direct route on a shard);
  - whisper-small: its cross-attention cache of 16 frames split too;
  - jamba-1.5-large: attention beside Mamba and MoE layers.
  Each rank's attention caches after prefill are C / 2 slots where 2
  divides C and C where not; each decode step changes exactly one data
  rank's shard of a split self-attention cache (the owner of its slot),
  every rank's whole one, and no cross-attention cache.  Every logit of
  prefill and of every decode step lies within rel 1e-5 of max|logit| of
  the one-rank path and of the JAX package's ``prefill`` / ``decode_step``
  on the whole caches.
* A 1 x 1 mesh (one gloo rank): the serve steps given shards and the
  caches' length equal the one-device steps bit for bit; the one-device
  ``models.Decoder`` at batch 1 on the decode tests' stand-in card equals
  the eager loop bit for bit with one capture.
* The fault this repairs: ``decode_step`` on a rank's half of a split
  cache as if it were whole lies over 1e-2 of max|logit| off.
* The dry run on the fake 512-rank group at long_500k, one period deep,
  on both production meshes: rank 0's all-reduces add the data group's
  two a layer (the max, then the denominators and accumulators in one),
  their bytes from the shapes; its flops and its argument, output and
  alias bytes are the figures before context-parallel decode.

Order: the 1 x 1 tests make and destroy their own group, the spawned
ranks run in processes of their own, and the fake group, made for the
dry-run tests at the end, is destroyed at the module's end.
"""
import dataclasses
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as JC
import repro.models.transformer as JT
import repro_torch.configs as PC
import repro_torch.models.transformer as PT
from repro_torch import graphs
from repro_torch.launch import make_local_mesh
from repro_torch.launch.dryrun import dryrun_one, fake_group
from repro_torch.models import Decoder, params_from_numpy
from repro_torch.sharding import make_shardings
from repro_torch.train.steps import (build_decode_step, build_prefill_step,
                                     place_params)
from repro_torch.tree import tree_leaves, tree_map

from test_torch_decode_graph import _equal, stand_in_card  # noqa: F401

RTOL = 1e-5
# name: (arch, local window or None, prompt S, decode steps, cache length)
CASES = {
    "gemma2-ring": ("gemma2-27b", 8, 16, 6, 22),
    "gemma2-odd": ("gemma2-27b", 8, 16, 6, 23),
    "gemma2-long": ("gemma2-27b", 16, 96, 3, 256),
    "gemma2-mid": ("gemma2-27b", 16, 96, 3, 128),
    "whisper": ("whisper-small", None, 16, 4, 20),
    "jamba": ("jamba-1.5-large-398b", None, 16, 4, 20),
}
MESHES = ((2, 1), (2, 2))


def _cfgs(case):
    arch, window = CASES[case][:2]

    def cut(cfg):
        cfg = cfg.smoke_variant()
        if window:
            cfg = cfg.with_overrides(period=tuple(
                dataclasses.replace(b, window=window) if b.window else b
                for b in cfg.period))
        return cfg

    return cut(JC.get_config(arch)), cut(PC.get_config(arch))


def _inputs(cfg, case):
    """(tokens (1, S + NEW) int32, extras) from a numpy seed."""
    _, _, S, new, _ = CASES[case]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (1, S + new)).astype(np.int32)
    extras = {}
    if cfg.n_enc_layers:
        extras["enc_embeds"] = (rng.standard_normal(
            (1, cfg.n_enc_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, extras


def _attn_lengths(cfg, cache_len):
    """Per period position, the global length of each attention cache
    (self, and cross where there is one), as ``init_caches`` makes them;
    ``None`` for a block of another kind."""
    out = []
    for spec in cfg.period:
        if spec.kind != "attn":
            out.append(None)
            continue
        C = min(cache_len, spec.window) if spec.window else cache_len
        out.append((C, max(cfg.n_enc_frames, 1)) if spec.cross_attn
                   else (C,))
    return out


def _attn_leaves(cfg, caches, cache_len):
    """[(k or v leaf (n_periods, B, slots, K, hd), global length, cross)]
    of every attention cache."""
    out = []
    for cache, lens in zip(caches, _attn_lengths(cfg, cache_len)):
        if lens is None:
            continue
        parts = cache if len(lens) == 2 else (cache,)
        for i, (part, C) in enumerate(zip(parts, lens)):
            out += [(part.k, C, i == 1), (part.v, C, i == 1)]
    return out


def _serve(pre, dec, params, case, cfg, on_step=None):
    """Prefill on the prompt, then teacher-forced decode steps -> (the
    logits of prefill and of each step, the caches).  ``on_step(before,
    caches)`` after each step, ``before`` the caches' leaves before it."""
    _, _, S, new, _ = CASES[case]
    toks, extras = _inputs(cfg, case)
    toks = torch.from_numpy(toks)
    batch = {"tokens": toks[:, :S],
             **{k: torch.from_numpy(v) for k, v in extras.items()}}
    logits, caches = pre(params, batch)
    out = [logits]
    for i in range(new):
        before = [t.clone() for t in tree_leaves(caches)]
        logits, caches = dec(params, toks[:, S + i:S + i + 1], caches, S + i)
        if on_step:
            on_step(before, caches)
        out.append(logits)
    return out, caches


def _one_rank(case, params):
    """The one-device path: ``models.prefill`` / ``decode_step``."""
    _, cfg = _cfgs(case)
    cache_len = CASES[case][4]

    def pre(p, batch):
        return PT.prefill(p, cfg, batch.pop("tokens"), cache_len=cache_len,
                          **batch)

    def dec(p, tok, caches, i):
        return PT.decode_step(p, cfg, tok, caches, i)

    with torch.no_grad():
        return _serve(pre, dec, params, case, cfg)


def _reference(case, jp):
    """The JAX package's prefill and decode steps on the whole caches."""
    jcfg, _ = _cfgs(case)
    _, _, S, new, cache_len = CASES[case]
    toks, extras = _inputs(jcfg, case)
    kw = {k: jnp.asarray(v) for k, v in extras.items()}
    logits, caches = jax.jit(functools.partial(
        JT.prefill, cfg=jcfg, cache_len=cache_len))(
            jp, tokens=jnp.asarray(toks[:, :S]), **kw)
    dec = jax.jit(JT.decode_step, static_argnums=1)
    out = [np.asarray(logits)]
    for i in range(new):
        logits, caches = dec(jp, jcfg, jnp.asarray(toks[:, S + i:S + i + 1]),
                             caches, S + i)
        out.append(np.asarray(logits))
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# 1 x 1: a data axis of one rank is the one-device program, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def local_mesh():
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("case", ["gemma2-ring", "whisper"])
def test_one_by_one_mesh_serve_bit_for_bit(local_mesh, case):
    _, cfg = _cfgs(case)
    cache_len = CASES[case][4]
    params = PT.init_params(cfg, 0, device="cpu")
    lp = place_params(params, make_shardings(local_mesh, params,
                                             PT.param_axes(cfg)))
    want = _one_rank(case, params)
    got = _serve(build_prefill_step(cfg, cache_len, global_batch=1),
                 build_decode_step(cfg, cache_len, global_batch=1), lp, case,
                 cfg)
    _equal(got, want)


def test_decoder_at_batch_one_is_unchanged(stand_in_card):  # noqa: F811
    """The one-device ``Decoder`` (no mesh, no data axis) at batch 1 over
    gemma2's ring: greedy tokens, the last logits and every cache leaf
    equal the eager ``decode_step`` loop bit for bit, one capture."""
    case = "gemma2-ring"
    _, cfg = _cfgs(case)
    _, _, S, new, cache_len = CASES[case]
    params = PT.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_inputs(cfg, case)[0][:, :S])
    with torch.no_grad():
        lg, caches = PT.prefill(params, cfg, toks, cache_len=cache_len)
    tok = torch.argmax(lg[:, -1], dim=-1)[:, None].int()
    dec = Decoder(params, cfg, 1, cache_len)
    dec.load(caches, S)
    out, t = [], tok
    with torch.no_grad(), graphs.capturing(False):
        for i in range(new):
            lg, caches = PT.decode_step(params, cfg, t, caches, S + i)
            t = torch.argmax(lg[:, -1], dim=-1)[:, None].int()
            out.append(t)
    _equal(dec.generate(new, token=tok), torch.cat(out, dim=1))
    _equal(dec.logits, lg)
    _equal(dec.caches, caches)
    assert dec.captures == 1 and stand_in_card.replays == new - 1


# ---------------------------------------------------------------------------
# (2, 1) and (2, 2): gloo processes, the data group of 2 at batch 1
# ---------------------------------------------------------------------------

def _rank_worker(rank, world, data, model, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)
        mesh = make_local_mesh(data, model, device="cpu")
        res = {}
        for case in CASES:
            _, cfg = _cfgs(case)
            cache_len = CASES[case][4]
            params = torch.load(f"{out}/{case}.pt")
            lp = place_params(params, make_shardings(mesh, params,
                                                     PT.param_axes(cfg)))
            changed = []

            def on_step(before, caches):
                now = tree_leaves(caches)
                ids = {id(t): i for i, t in enumerate(now)}
                changed.append([
                    not torch.equal(before[ids[id(t)]], t)
                    for t, _, _ in _attn_leaves(cfg, caches, cache_len)])

            logits, caches = _serve(
                build_prefill_step(cfg, cache_len, global_batch=1),
                build_decode_step(cfg, cache_len, global_batch=1), lp, case,
                cfg, on_step)
            res[case] = {"logits": logits, "changed": changed,
                         "slots": [(t.shape[2], C, cross) for t, C, cross in
                                   _attn_leaves(cfg, caches, cache_len)]}
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's reference parameters, and what each rank of each mesh
    computed from them: {mesh: [rank's results]}."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("context_parallel")
    ref = {}
    for case in CASES:
        jcfg, _ = _cfgs(case)
        ref[case] = jax.tree.map(np.asarray, JT.init_params(
            jcfg, jax.random.key(0)))
        torch.save(params_from_numpy(ref[case], "cpu"), out / f"{case}.pt")
    got = {}
    for data, model in MESHES:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        n = data * model
        mp.spawn(_rank_worker, args=(n, data, model, port, str(out)),
                 nprocs=n)
        got[data, model] = [torch.load(out / f"rank{r}.pt")
                            for r in range(n)]
    return ref, got


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_hands_each_rank_its_slots(ranks, mesh, case):
    _, got = ranks
    data = mesh[0]
    for r in got[mesh]:
        slots = r[case]["slots"]
        assert slots
        for held, C, _ in slots:
            assert held == (C // data if C % data == 0 else C)
    if case == "gemma2-odd":        # the global layer's 23 slots stay whole
        assert (23, 23, False) in got[mesh][0][case]["slots"]
    if case == "whisper":           # the 16 frames split
        assert (8, 16, True) in got[mesh][0][case]["slots"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_writes_only_on_the_slots_owner(ranks, mesh, case):
    """A split self-attention cache changes on exactly one rank of each
    data group a step, the owner of slot ``pos % C``; a whole one on
    every rank; a cross-attention cache on none."""
    _, got = ranks
    data, model = mesh
    _, _, S, new, _ = CASES[case]
    slots = got[mesh][0][case]["slots"]
    for step in range(new):
        pos = S + step
        for j, (held, C, cross) in enumerate(slots):
            for m in range(model):
                # the data group of model rank m: ranks m, model + m, ...
                ch = [got[mesh][d * model + m][case]["changed"][step][j]
                      for d in range(data)]
                if cross:
                    assert not any(ch)
                elif held == C:
                    assert all(ch)
                else:
                    assert ch == [d == (pos % C) // held
                                  for d in range(data)], (step, j)


@pytest.fixture(scope="module")
def wants(ranks):
    """{case: (the one-rank path's logits, the JAX package's)}."""
    ref, _ = ranks
    return {case: (_one_rank(case, params_from_numpy(ref[case], "cpu"))[0],
                   _reference(case, jax.tree.map(jnp.asarray, ref[case])))
            for case in CASES}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_logits_match_one_rank_and_reference(ranks, wants, mesh,
                                                    case):
    _, got = ranks
    want, jax_want = wants[case]
    assert len(want) == len(jax_want) == CASES[case][3] + 1
    for r in got[mesh]:
        logits = r[case]["logits"]
        assert len(logits) == len(want)
        for x, y, z in zip(logits, want, jax_want):
            assert x.shape == y.shape == (1, 1, _cfgs(case)[1].vocab)
            assert _rel(x, y) <= RTOL
            assert _rel(x, z) <= RTOL


def test_decode_on_a_shard_as_if_whole_is_far_off():
    """The fault context-parallel decode repairs: ``decode_step`` without
    the caches' global length treats each rank's half of a split cache
    as a whole ring (its slot ``pos % (C / 2)``, its softmax over the half
    alone), the program the dry run traced before.  At gemma2's ring
    case its logits lie over 1e-2 of max|logit| from the one-rank
    decode on either half."""
    case = "gemma2-ring"
    _, cfg = _cfgs(case)
    _, _, S, new, cache_len = CASES[case]
    params = PT.init_params(cfg, 0, device="cpu")
    want, _ = _one_rank(case, params)
    toks = torch.from_numpy(_inputs(cfg, case)[0])
    with torch.no_grad():
        _, whole = PT.prefill(params, cfg, toks[:, :S], cache_len=cache_len)
        for r in range(2):
            caches = tree_map(lambda t: t[:, :, r * t.shape[2] // 2:(
                r + 1) * t.shape[2] // 2].clone(), whole)
            for i in range(new):
                lg, caches = PT.decode_step(params, cfg,
                                            toks[:, S + i:S + i + 1],
                                            caches, S + i)
                assert _rel(lg, want[i + 1]) > 1e-2


# ---------------------------------------------------------------------------
# the dry run: rank 0's long_500k decode on the fake 512-rank group
# ---------------------------------------------------------------------------

# rank 0's flops and all-reduces (bytes, calls) and its argument, output
# and alias bytes at long_500k, one period deep, before context-parallel
# decode (the dry run of the commit that traced decode on the shard alone)
BEFORE = {
    ("deepseek-7b", False): (77987840.0, 24576.0, 15,
                             (5121544, 671744, 262144)),
    ("deepseek-7b", True): (77856768.0, 24576.0, 15,
                            (2560776, 540672, 131072)),
    ("gemma2-27b", False): (289538048.0, 46080.0, 30,
                            (18330696, 1286144, 262144)),
    ("gemma2-27b", True): (289275904.0, 46080.0, 30,
                           (9165352, 1155072, 131072)),
}


@pytest.fixture(scope="module")
def fake():
    assert not dist.is_initialized()
    fake_group()
    yield
    dist.destroy_process_group()


def _merge_bytes(cfg, n_model: int) -> float:
    """The data group's all-reduce bytes of one attention layer's decode:
    the max (B, K_l, G, 1) and the denominators beside the accumulators
    (B, K_l, G, 1, hd + 1), float32, K_l G = the rank's query heads."""
    heads = cfg.n_heads // n_model if cfg.n_heads % n_model == 0 \
        else cfg.n_heads
    return 4.0 * heads * (1 + cfg.hd + 1)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-27b"])
def test_dryrun_records_the_data_groups_all_reduces(fake, arch, multi):
    """deepseek-7b (dense: every block windowed at long_500k) and
    gemma2-27b (its own local window beside the windowed global layer),
    one period: each layer's cache of 4096 slots is 4096 / 16 (or / 32
    over two pods) slots on rank 0, and its decode adds two all-reduces
    over the data group."""
    base = PC.ARCHS[arch]
    layers = len(base.period)
    rec = dryrun_one(arch, "long_500k", multi, verbose=False,
                     extra_overrides={"n_layers": layers})
    flops, reduced, calls, mem = BEFORE[arch, multi]
    coll = rec["collectives"]
    assert coll["count"] == calls + 2 * layers
    assert coll["all-reduce"] == reduced + layers * _merge_bytes(base, 16)
    got = rec["roofline"]["hlo_flops_per_device"]
    assert flops <= got <= 1.01 * flops
    m = rec["memory"]
    assert (m["argument_bytes_per_device"], m["output_bytes_per_device"],
            m["alias_bytes_per_device"]) == mem
