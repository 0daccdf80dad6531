"""The ``model`` axis computed on shards (``repro_torch.sharding.tp``:
attention heads, MLP ff columns, vocabulary rows and experts on each
rank's shard, with their activation all-reduces), on the CPU.

* A 1 x 1 mesh (a one-rank gloo group): the train, prefill and decode
  steps given ``DTensor`` shards (the model axis set, one rank wide) equal
  the steps on plain parameters bit for bit, at deepseek-7b's and
  phi3.5-moe's smoke variants (2 layers, d_model 128).
* A 1 x 2 mesh (two gloo processes, one spawn for the module; both ranks
  take the same batch, as the ranks of one model group do), from the JAX
  package's parameters (``jax.random.key(0)``, carried across as numpy) and
  a numpy-seeded batch, at deepseek-7b, phi3.5-moe and deepseek-7b with one
  kv head (GQA whose kv heads the axis does not divide: each rank picks
  the kv head of its query heads):
  - the train step's loss, ``grad_norm`` and gathered moments within rel
    1e-5 of the one-rank step on the same batch (each leaf's largest entry
    the scale: float32 sums in another order);
  - step 1's first moment, (1 - b1) times the clipped gradient, with the
    clip undone by the port's ``grad_norm``, within rel 1e-5 of each
    leaf's largest entry of the JAX package's ``jax.grad`` of the same
    loss on the same parameters and batch;
  - each rank holds half the rows of every model-sharded leaf;
  - prefill and 3 greedy decode steps: logits within rel 1e-4 of the
    one-rank path's largest logit.
* The dry run on the fake 512-rank group at 16 x 16, one period deep:
  the all-reduce bytes equal the count worked out from the shapes
  (``_all_reduce_bytes`` states it); rank 0's flops equal the global
  program's over ``n_chips`` to rel 1e-2 where every dim divides
  (deepseek-7b) and exceed it where one falls back to replication (phi3.5-
  moe's 8 kv heads, qwen2-vl's 28 heads).

Order: the 1 x 1 tests make and destroy their own group, the spawned
ranks run in processes of their own, and the fake group, made once for
the dry-run tests, is destroyed at the module's end.
"""
import importlib.util
import math
import socket
from pathlib import Path

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
from repro_torch.configs import SHAPES
from repro_torch.launch import make_local_mesh, make_production_mesh
from repro_torch.launch.dryrun import (_rank_inputs, dryrun_one, fake_group,
                                       trace_step)
from repro_torch.launch.specs import (input_shardings, input_specs,
                                      param_structs, shape_config)
from repro_torch.models import params_from_numpy
from repro_torch.models import xlstm as PX
from repro_torch.models.common import Dtype
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.sharding import make_shardings, tp
from repro_torch.train.steps import (build_decode_step, build_prefill_step,
                                     build_train_step, gather, place_params,
                                     place_train_state)
from repro_torch.tree import tree_leaves, tree_paths

RTOL, LOGIT_RTOL, B1 = 1e-5, 1e-4, 0.9
B, S, NEW = 2, 16, 3
LR = cosine_schedule(3e-3, 2, 10)
CASES = {"deepseek-7b": ("deepseek-7b", {}),
         "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}),
         "gqa-one-kv": ("deepseek-7b", {"n_kv": 1}),
         "jamba": ("jamba-1.5-large-398b", {}),
         "xlstm": ("xlstm-350m", {}),
         "xlstm-one-head": ("xlstm-350m", {"n_heads": 1, "n_kv": 1})}


# A leaf float32 cannot resolve to RTOL in any order of its sums: at one
# head the mLSTM's input-gate bias bi barely moves the loss (a shift of the
# head's log input gates cancels in its normalised read-out but where the
# normaliser's floor binds), so its gradient is about 1e-4 of the gate
# weights' and a sum of terms that nearly cancel.  Such a leaf is held, as
# the n-rank check on the card holds every leaf, within WITNESS_X times the
# witness's distance: the one-rank step's own gradient against the same
# step on the mirrored model (``chip_smoke._mirror``: every sum the model
# axis splits in another order), mirrored back.  ``_witness`` requires that
# distance to exceed RTOL; every other leaf stays at RTOL.
CANCELLING = {"xlstm-one-head": [("blocks", "0", "bi")]}
WITNESS_X = 10.0
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(case):
    arch, over = CASES[case]
    return (JC.get_config(arch).smoke_variant().with_overrides(**over),
            PC.get_config(arch).smoke_variant().with_overrides(**over))


def _batch(cfg):
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, 1),
            "weights": np.array([0.5, 1.5], np.float32)}


def _torch_batch(cfg):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}


def _serve(step_pre, step_dec, params, tok):
    """Prefill then NEW greedy decode steps -> (every step's logits, the
    caches)."""
    logits, caches = step_pre(params, {"tokens": tok})
    out = [logits]
    for i in range(NEW):
        t = logits[:, -1:].argmax(-1).to(torch.int32)
        logits, caches = step_dec(params, t, caches, S + i)
        out.append(logits)
    return out, caches


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# 1 x 1: the model axis of one rank is the one-device program, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def local_mesh():
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b", "xlstm-350m"])
def test_one_by_one_mesh_steps_bit_for_bit(local_mesh, arch, kind):
    cfg = PC.get_config(arch).smoke_variant()
    params = PT.init_params(cfg, 0, device="cpu")
    sh = make_shardings(local_mesh, params, PT.param_axes(cfg))
    batch = _torch_batch(cfg)
    if kind == "train":
        plain = build_train_step(cfg, LR)(params, adamw_init(params), batch)
        lp, lo = place_train_state(params, adamw_init(params), sh)
        laid = build_train_step(cfg, LR, grad_specs=sh)(lp, lo, batch)
        pairs = [(tree_leaves(plain[:2]), tree_leaves(gather(laid[:2]))),
                 ([plain[2][k] for k in sorted(plain[2])],
                  [laid[2][k] for k in sorted(laid[2])])]
    else:
        pre = build_prefill_step(cfg, cache_len=S + NEW)
        dec = build_decode_step(cfg)
        plain = _serve(pre, dec, params, batch["tokens"])
        laid = _serve(pre, dec, place_params(params, sh), batch["tokens"])
        pairs = [(tree_leaves(plain), tree_leaves(laid))]
    for a, b in pairs:
        assert len(a) == len(b) > 0
        assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# 1 x 2: two gloo processes, one model group
# ---------------------------------------------------------------------------

def _rank_worker(rank, port, out):
    from torch.distributed.tensor import DTensor

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_local_mesh(1, 2, device="cpu")
        res = {}
        for case in CASES:
            _, cfg = _cfgs(case)
            params = torch.load(f"{out}/{case}.pt")
            sh = make_shardings(mesh, params, PT.param_axes(cfg))
            lp, lo = place_train_state(params, adamw_init(params), sh)
            _, o, met = build_train_step(cfg, LR, grad_specs=sh)(
                lp, lo, _torch_batch(cfg))
            rows = [(tuple(x.to_local().shape), tuple(x.shape), [
                pl.dim for n, pl in zip(mesh.mesh_dim_names, x.placements)
                if n == "model" and pl.is_shard()])
                for x, s in zip(tree_leaves(lp),
                                tree_leaves(PT.model_shards(cfg)))
                if s and isinstance(x, DTensor)]
            logits, _ = _serve(build_prefill_step(cfg, cache_len=S + NEW),
                               build_decode_step(cfg),
                               place_params(params, sh),
                               _torch_batch(cfg)["tokens"])
            res[case] = {"loss": met["loss"], "grad_norm": met["grad_norm"],
                         "m": gather(o.m), "v": gather(o.v), "rows": rows,
                         "logits": logits}
        res["slstm_calls"] = _slstm_calls(mesh)
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _slstm_calls(mesh):
    """The collectives of xlstm-350m's smoke sLSTM layer on the rank's
    heads (the period's first, placed and gathered as the train step
    does) over a forward and a backward pass, under a ``tp.Recorder``,
    at S = 16 and 32: {S: (calls, bytes by kind)} of each pass."""
    _, cfg = _cfgs("xlstm")
    params = PT.init_params(cfg, 0, device="cpu")
    laid = gather(place_params(params, make_shardings(
        mesh, params, PT.param_axes(cfg))), PT.model_shards(cfg))
    bp = {k: v[0] for k, v in laid["blocks"]["1"].items()}
    assert bp["wz"].shape[1] * 2 == cfg.n_heads
    gen = torch.Generator().manual_seed(5)
    calls = {}
    for s in (16, 32):
        x = torch.randn(B, s, cfg.d_model, generator=gen,
                        requires_grad=True)
        fwd, bwd = tp.Recorder(), tp.Recorder()
        with tp.model_axis(mesh):
            with tp.recording(fwd):
                out = PX.slstm_apply(bp, x, cfg)
            with tp.recording(bwd):
                out.sum().backward()
        calls[s] = [(r.count, dict(r.bytes)) for r in (fwd, bwd)]
    return calls


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case's reference parameters (as the port's tree), and what
    each of the two ranks computed from them."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("model_axis")
    ref = {}
    for case in CASES:
        jcfg, _ = _cfgs(case)
        jp = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                     jax.random.key(0)))
        ref[case] = jp
        torch.save(params_from_numpy(jp, "cpu"), out / f"{case}.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank_worker, args=(port, str(out)), nprocs=2)
    ranks = [torch.load(out / f"rank{r}.pt") for r in (0, 1)]
    return ref, ranks


@pytest.fixture(scope="module")
def witness(two_ranks):
    """{(case, path): the one-rank gradient's and its square's distance
    from the mirrored model's, mirrored back, to the leaf's largest entry}
    for the ``CANCELLING`` leaves, each required to exceed RTOL."""
    from torch.func import grad

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ref, _ = two_ranks
    out = {}
    for case, paths in CANCELLING.items():
        _, cfg = _cfgs(case)
        batch = _torch_batch(cfg)
        w = batch["weights"][:, None] * torch.ones(batch["labels"].shape)

        def loss(p, tok, lab):
            return PT.lm_loss(PT.forward(p, cfg, tok)[0], lab, w)

        params = params_from_numpy(ref[case], "cpu")
        axes = PT.param_axes(cfg)
        flip = cfg.vocab - 1
        g = dict(tree_paths(grad(loss)(params, batch["tokens"],
                                       batch["labels"])))
        gm = dict(tree_paths(smoke._mirror(grad(loss)(
            smoke._mirror(params, axes, cfg), flip - batch["tokens"],
            flip - batch["labels"]), axes, cfg)))
        for path in paths:
            out[case, path] = {"m": _rel(gm[path], g[path]),
                               "v": _rel(gm[path] ** 2, g[path] ** 2)}
            assert min(out[case, path].values()) > RTOL
    return out


def _gate(witness, case, path, k) -> float:
    """RTOL, or for a ``CANCELLING`` leaf WITNESS_X times its witness."""
    if path in CANCELLING.get(case, ()):
        return WITNESS_X * witness[case, path][k]
    return RTOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_train_step_is_the_one_rank_step(two_ranks, witness,
                                                   case):
    ref, ranks = two_ranks
    _, cfg = _cfgs(case)
    params = params_from_numpy(ref[case], "cpu")
    _, opt, met = build_train_step(cfg, LR)(params, adamw_init(params),
                                            _torch_batch(cfg))
    for r in ranks:
        got = r[case]
        assert _rel(got["loss"], met["loss"]) <= RTOL
        assert _rel(got["grad_norm"], met["grad_norm"]) <= RTOL
        for k in ("m", "v"):
            a, b = tree_leaves(got[k]), list(tree_paths(getattr(opt, k)))
            assert len(a) == len(b)
            for x, (path, y) in zip(a, b):
                assert x.shape == y.shape
                assert _rel(x, y) <= _gate(witness, case, path, k), (k, path)
        # the model-sharded leaves: half the rows of their model dim
        halves = [(loc, glob, d) for loc, glob, d in got["rows"] if d]
        assert halves
        for loc, glob, (d,) in halves:
            assert 2 * loc[d] == glob[d]
    # the embedding and each (stacked) weight of attention and the MLP or
    # the experts; with one kv head, wk and wv stay whole; jamba's Mamba
    # layer's 9 d_inner leaves; the mLSTM's 8 on d_inner and the sLSTM's
    # 12 gate leaves on heads (whole with one head) and 3 on ff
    n = {"deepseek-7b": 8, "phi3.5-moe": 8, "gqa-one-kv": 6, "jamba": 20,
         "xlstm": 24, "xlstm-one-head": 12}[case]
    assert len([1 for *_, d in ranks[0][case]["rows"] if d]) == n


def _ref_loss(jcfg, batch):
    """The reference train step's loss (``repro.train.steps``' loss_fn)."""
    def loss(p):
        logits, aux = JT.forward(p, jcfg, batch["tokens"])
        w = batch["weights"][:, None] * jnp.ones_like(batch["labels"],
                                                      jnp.float32)
        return (JT.lm_loss(logits, batch["labels"], w)
                + jcfg.router_aux_weight * aux.get("load_balance", 0.0)
                + 1e-3 * aux.get("router_z", 0.0))
    return loss


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_first_moment_is_the_reference_gradient(two_ranks, witness,
                                                          case):
    ref, ranks = two_ranks
    jcfg, _ = _cfgs(case)
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    g = jax.tree_util.tree_leaves(jax.jit(jax.grad(_ref_loss(jcfg, batch)))(
        jax.tree.map(jnp.asarray, ref[case])))
    for r in ranks:
        got = r[case]
        scale = min(1.0, 1.0 / float(got["grad_norm"]))
        m = list(tree_paths(got["m"]))
        assert len(m) == len(g)
        for (path, x), y in zip(m, g):
            y = np.asarray(y, np.float64)
            x = x.double().numpy() / ((1 - B1) * scale)
            assert x.shape == y.shape
            assert np.abs(x - y).max() <= _gate(witness, case, path, "m") \
                * max(np.abs(y).max(), 1e-30), path


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_decode_is_the_one_rank_decode(two_ranks, case):
    ref, ranks = two_ranks
    _, cfg = _cfgs(case)
    params = params_from_numpy(ref[case], "cpu")
    want, _ = _serve(build_prefill_step(cfg, cache_len=S + NEW),
                     build_decode_step(cfg), params,
                     _torch_batch(cfg)["tokens"])
    for r in ranks:
        got = r[case]["logits"]
        assert len(got) == len(want) == NEW + 1
        for x, y in zip(got, want):
            assert x.shape == y.shape == (B, 1, cfg.vocab)
            assert _rel(x, y) <= LOGIT_RTOL


def test_two_ranks_slstm_loop_has_no_collective_a_token(two_ranks):
    """The sLSTM on the rank's heads meets the other rank only outside its
    token loop: its forward and its backward record the same collective
    calls at S = 16 and S = 32 (the all-gather of the hidden states and
    the post-projection's all-reduce; their backward counterparts)."""
    _, ranks = two_ranks
    for r in ranks:
        calls = r["slstm_calls"]
        for (n16, by16), (n32, by32) in zip(calls[16], calls[32]):
            assert n16 == n32 > 0
            assert sorted(by16) == sorted(by32)
            assert all(by32[k] == 2 * by16[k] for k in by16)


# ---------------------------------------------------------------------------
# the dry run: rank 0's program on the fake 512-rank group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake():
    assert not dist.is_initialized()
    fake_group()
    yield
    dist.destroy_process_group()


def _layers(arch) -> int:
    """One period of ``arch``'s layers (one layer where the period is)."""
    return len(PC.ARCHS[arch].period)


def _record(arch, shape):
    return dryrun_one(arch, shape, False, verbose=False,
                      extra_overrides={"n_layers": _layers(arch)})


def _all_reduce_bytes(cfg, shape) -> float:
    """A rank's all-reduce output bytes on 16 x 16, one layer (L = 1): the
    batch's local rows B_l = B / 16, activations of ``cfg.dtype`` (``it``
    bytes), X = B_l x S x d x it one activation all-reduce.

    train: 2 forward (attention's output projection, the MLP's or the
    experts' combine) and 2 backward (their inputs' ``tp.copy_to``) a
    layer, the embedding's lookup forward and the tied logits' input
    backward, the loss's three float32 (B_l, S) reductions (max, sum of
    exponentials, target logit), and under ``"full"`` remat the layer's 2
    forward once more: (4 L + 2 + 2 L) X + 3 B_l S 4.  With MoE a layer
    adds the combine weights' gradient, B_l x S x top_k x it, and where
    the kv heads fall back to replication (phi3.5-moe's 8 on 16) the
    whole kv weights' gradient, 2 x d x n_kv x hd x the parameters'
    itemsize.  decode: one token, (2 L + 1) X with S = 1."""
    L = 1
    shp = SHAPES[shape]
    bl, d = shp["global_batch"] // 16, cfg.d_model
    it = Dtype.of(cfg.dtype).itemsize
    if shp["kind"] == "decode":
        return (2 * L + 1) * bl * d * it
    s = shp["seq_len"]
    x = bl * s * d * it
    out = (4 * L + 2 + (2 * L if cfg.remat_policy == "full" else 0)) * x \
        + 3 * bl * s * 4
    if cfg.n_experts:
        out += L * bl * s * cfg.top_k * it
    if cfg.n_kv % 16:
        out += L * 2 * d * cfg.n_kv * cfg.hd * Dtype.of(
            cfg.param_dtype).itemsize
    return out


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "phi3.5-moe-42b-a6.6b"])
def test_dryrun_all_reduce_bytes_from_the_shapes(fake, arch, shape):
    rec = _record(arch, shape)
    cfg = shape_config(PC.ARCHS[arch], shape).with_overrides(n_layers=1)
    assert cfg.remat_policy == "full"
    assert rec["collectives"]["all-reduce"] == _all_reduce_bytes(cfg, shape)
    assert rec["roofline"]["collective_bytes_per_device"] >= \
        rec["collectives"]["all-reduce"]


def _global_flops(arch, shape):
    """The whole program's flops (every leaf and input whole, no mesh)."""
    cfg = shape_config(PC.ARCHS[arch], shape).with_overrides(
        n_layers=_layers(arch))
    params = param_structs(cfg)
    _, inputs = input_specs(cfg, shape)
    counts, _ = trace_step(cfg, "train", params, inputs,
                           SHAPES[shape]["seq_len"], opt=adamw_init(params))
    return counts["total"]


@pytest.mark.parametrize("arch", ["deepseek-7b", "phi3.5-moe-42b-a6.6b",
                                  "qwen2-vl-7b", "jamba-1.5-large-398b"])
def test_dryrun_flops_are_rank_zeros(fake, arch):
    """deepseek-7b: every sharded dim divides 16, so rank 0 does 1/256 of
    the work; phi3.5-moe repeats its kv projections (8 kv heads on 16
    ranks), qwen2-vl its attention (28 heads): more than 1/256.
    jamba-1.5-large (one period: attention and 7 Mamba layers, 4 with
    experts) computes its Mamba layers on the rank's d_inner channels:
    within 1.10x of 1/256 (only its 8 kv heads' projections repeat)."""
    rec = _record(arch, "train_4k")
    per = rec["roofline"]["hlo_flops_per_device"]
    share = _global_flops(arch, "train_4k") / rec["n_chips"]
    if arch == "deepseek-7b":
        assert abs(per - share) <= 1e-2 * share
    elif arch.startswith("jamba"):
        assert share <= per <= 1.10 * share
    else:
        assert per > (1 + 1e-2) * share
    assert math.isclose(rec["roofline"]["useful_ratio"],
                        rec["roofline"]["model_flops"] / (per * 256))


@pytest.mark.parametrize("arch,over", [
    ("jamba-1.5-large-398b", {}),
    ("xlstm-350m", {"n_heads": 16, "n_kv": 16})])
def test_dryrun_decode_holds_the_recurrent_caches_on_shards(fake, arch,
                                                             over):
    """Rank 0's decode inputs hold its model shard of the Mamba caches'
    d_inner channels and of the mLSTM's and sLSTM's heads (xlstm-350m with
    16 heads, so the heads divide the 16-way model axis), and the traced
    decode step returns caches of those shapes, written in place."""
    cfg = PC.ARCHS[arch].with_overrides(n_layers=_layers(arch), **over)
    mesh = make_production_mesh(multi_pod=False)
    _, inputs = input_specs(cfg, "decode_32k")
    token, caches, index = _rank_inputs(
        inputs, input_shardings(cfg, "decode_32k", mesh))
    di, H = cfg.mamba_expand * cfg.d_model, cfg.n_heads
    kinds = [spec.kind for spec in cfg.period]
    for kind, c in zip(kinds, caches):
        if kind == "mamba":
            assert c.conv.shape[-1] == c.ssm.shape[-2] == di // 16
        elif kind in ("mlstm", "slstm"):
            assert all(t.shape[2] == H // 16 for t in c)
    assert {"mamba", "mlstm", "slstm"} & set(kinds)
    params = param_structs(cfg)
    params = place_params(params, make_shardings(mesh, params,
                                                 PT.param_axes(cfg)))
    _, (logits, out) = trace_step(cfg, "decode", params,
                                  (token, caches, index),
                                  SHAPES["decode_32k"]["seq_len"])
    assert logits.shape[-1] == cfg.vocab
    for a, b in zip(tree_leaves(out), tree_leaves(caches)):
        assert a.shape == b.shape
