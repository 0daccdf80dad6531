"""The port's placement rules (``repro_torch.sharding``) against the JAX
package's (``repro.sharding``), on the CPU.

Exact throughout: specs entry by entry against the reference's
``PartitionSpec``s on its ``AbstractMesh`` (16 x 16 and 2 x 16 x 16), each
DTensor's local shape on a ``DeviceMesh`` of a fake 512-rank process group
against the reference ``NamedSharding.shard_shape``, and a train step with
``grad_specs`` on a 1 x 1 mesh (a one-rank gloo group) against the step
without it, bit for bit.  On a 2 x 1 and a 1 x 2 mesh (two gloo
processes) the step is the partitioned program: each rank holds half of
every leaf its layout shards (parameters and AdamW moments) and the same
copy of every leaf replicated on the mesh's two ranks, and the ranks'
shards put together are the one-process step's: parameters, moments and
the gradient norm to rel 1e-5 of each leaf's largest entry (float32 sums
in another order).  On 2 x 1 each rank takes its own batch and the
one-process step runs on both; on 1 x 2 the ranks form one model group,
take the same batch (the batch is sharded over the data axes only) and
compute on their model shards, and the one-process step runs on that
batch.  On the 1 x 2 mesh the norms and every leaf not split over
``model`` are replicated on both ranks, so a norm that summed them once a
rank would be off (up to sqrt(2)); there a ``grad_specs`` that leaves a
gradient out raises.

The grad_specs tests come first: each makes and destroys its own group.
The fake group is made once for the tests after them and destroyed at
the module's end (a test file stays on one xdist worker).
"""
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

import repro.configs as JCONF
import repro.models.transformer as JT
import repro.sharding as JS
import repro_torch.models.transformer as PT
from repro_torch.configs import ARCHS
from repro_torch.launch import make_local_mesh, make_production_mesh
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.specs import param_structs
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.sharding import (logical_rules, make_shardings, make_specs,
                                  placements_for, spec_for_shape)
from repro_torch.train.steps import (build_train_step, gather,
                                     place_train_state)
from repro_torch.tree import tree_leaves

ARCH_NAMES = sorted(ARCHS)


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(tuple(sizes), tuple(names))


REF_MESH = {False: _abstract_mesh((16, 16), ("data", "model")),
            True: _abstract_mesh((2, 16, 16), ("pod", "data", "model"))}


def _ref_shapes(arch):
    """The reference's parameter shapes (``ShapeDtypeStruct``s straight
    from its ``param_defs``, as ``jax.eval_shape(init_params)`` gives)."""
    defs = JT.param_defs(JCONF.ARCHS[arch])

    def walk(d):
        if isinstance(d, dict) and d.get("__pdef__") is True:
            return jax.ShapeDtypeStruct(d["shape"], np.float32)
        return {k: walk(v) for k, v in d.items() if k != "__pdef__"}

    return walk(defs)


def _ref_specs(arch, multi, fsdp):
    specs = JS.make_specs(REF_MESH[multi], _ref_shapes(arch),
                          JT.param_axes(JCONF.ARCHS[arch]),
                          fsdp_min_elems=fsdp)
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))


def _norm(spec) -> tuple:
    """A spec with each one-name tuple entry as the bare name, the form
    ``PartitionSpec`` normalizes its entries to."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# grad_specs on a 1 x 1 mesh (a one-rank gloo group of its own)
# ---------------------------------------------------------------------------

@pytest.fixture
def local_mesh():
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["deepseek-7b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-350m"])
def test_grad_specs_on_one_by_one_mesh_bit_for_bit(local_mesh, arch):
    cfg = ARCHS[arch].smoke_variant().with_overrides(
        dtype="float32", param_dtype="float32")
    params = PT.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    B, S = 2, 4
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                          dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1),
             "weights": torch.as_tensor(rng.random(B), dtype=torch.float32)}
    sh = make_shardings(local_mesh, params, PT.param_axes(cfg))
    assert local_mesh.shape == (1, 1)
    lr = cosine_schedule(3e-3, 2, 10)
    plain = build_train_step(cfg, lr)(params, opt, batch)
    lp, lo = place_train_state(params, opt, sh)
    laid = build_train_step(cfg, lr, grad_specs=sh)(lp, lo, batch)
    # the partitioned step writes into the shards it was given
    assert laid[0] is lp and laid[1] is lo
    a, b = tree_leaves(plain[:2]), tree_leaves(gather(laid[:2]))
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert set(plain[2]) == set(laid[2])
    for k in plain[2]:
        assert torch.equal(torch.as_tensor(plain[2][k]),
                           torch.as_tensor(laid[2][k])), k


def test_grad_specs_prefix_and_non_shardings(local_mesh):
    """One ``NamedSharding`` stands for every leaf below it (a prefix, as
    ``with_sharding_constraint`` takes); a spec that is not a sharding
    leaves its part of the tree as it is."""
    from repro_torch.sharding import NamedSharding
    from repro_torch.train.steps import _constrain

    rng = np.random.default_rng(1)
    grads = {"a": torch.as_tensor(rng.standard_normal((4, 6)),
                                  dtype=torch.float32),
             "b": {"c": torch.as_tensor(rng.standard_normal(5),
                                        dtype=torch.float32)}}
    one = NamedSharding(local_mesh, (), placements_for(local_mesh, ()))
    for specs in (one, {"a": one, "b": None}, {"b": one}, object()):
        out = gather(_constrain(grads, specs))
        assert torch.equal(out["a"], grads["a"])
        assert torch.equal(out["b"]["c"], grads["b"]["c"])
    assert _constrain(grads, object()) is grads


def _dense_cfg():
    return ARCHS["deepseek-7b"].smoke_variant().with_overrides(
        dtype="float32", param_dtype="float32")


def _rank_batch(cfg, rank):
    """Rank ``rank``'s batch of two rows; the weights of each rank sum to 2,
    so the mean of the ranks' gradients is the gradient of both batches."""
    rng = np.random.default_rng(10 + rank)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 4)),
                          dtype=torch.int32)
    w = (0.25, 1.75) if rank == 0 else (1.5, 0.5)
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1),
            "weights": torch.tensor(w, dtype=torch.float32)}


def _two_rank_worker(rank, port, out, data, model):
    from torch.distributed.tensor import DTensor

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = make_local_mesh(data, model, device="cpu")
        assert mesh.shape == (data, model)
        cfg = _dense_cfg()
        params = PT.init_params(cfg, 0, device="cpu")
        sh = make_shardings(mesh, params, PT.param_axes(cfg))
        step = build_train_step(cfg, cosine_schedule(3e-3, 2, 10),
                                grad_specs=sh)
        lp, lo = place_train_state(params, adamw_init(params), sh)
        # the ranks of one model group take the same rows
        p, o, met = step(lp, lo, _rank_batch(cfg, rank // model))
        assert p is lp and o is lo
        assert all(isinstance(x, DTensor) for x in tree_leaves((p, o.m,
                                                                o.v)))
        local = lambda t: [(x.to_local().clone(), [  # noqa: E731
            pl.dim if pl.is_shard() else None for pl in x.placements])
            for x in tree_leaves(t)]
        torch.save({"params": local(p), "m": local(o.m), "v": local(o.v),
                    "count": o.count, "grad_norm": met["grad_norm"]},
                   f"{out}/rank{rank}.pt")
        part = {k: v for k, v in sh.items() if k != "embed"}
        lp, lo = place_train_state(params, adamw_init(params), sh)
        with pytest.raises(ValueError, match="on a group of 2 ranks"):
            build_train_step(cfg, cosine_schedule(3e-3, 2, 10),
                             grad_specs=part)(lp, lo,
                                              _rank_batch(cfg, rank // model))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_grad_specs_on_two_ranks_step_with_the_mean_gradient(tmp_path, data,
                                                              model):
    """Each rank holds half of each sharded leaf of the parameters, ``m``
    and ``v``; put together they are the one-rank step's over the data
    ranks' batches (both at 2 x 1, the one batch of the model group at
    1 x 2), and ``grad_norm`` is that step's on both ranks (module
    docstring)."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_two_rank_worker, args=(port, str(tmp_path), data, model),
             nprocs=2)
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in (0, 1))
    axis = 0 if data == 2 else 1          # the mesh dim of two ranks

    def whole(k):
        out, halves = [], 0
        for (x, pl), (y, _) in zip(r0[k], r1[k]):
            if pl[axis] is None:          # replicated: the same on both
                assert torch.equal(x, y), k
                out.append(x)
            else:
                halves += 1
                out.append(torch.cat([x, y], dim=pl[axis]))
        assert halves > 0, k
        # on 1 x 2 the norms (and whatever else no "model" axis splits)
        # are on both ranks: the norm's trap
        assert (halves < len(out)) == (model == 2), (k, halves)
        return out

    cfg = _dense_cfg()
    params = PT.init_params(cfg, 0, device="cpu")
    bs = [_rank_batch(cfg, r) for r in range(data)]
    both = {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
    p1, opt, met = build_train_step(cfg, cosine_schedule(3e-3, 2, 10))(
        params, adamw_init(params), both)
    for r in (r0, r1):
        torch.testing.assert_close(r["grad_norm"], met["grad_norm"],
                                   rtol=1e-5, atol=0)
        assert int(r["count"]) == 1
    for k, ref in (("m", opt.m), ("v", opt.v)):
        got = whole(k)
        assert len(got) == len(tree_leaves(ref))
        for x, y in zip(got, tree_leaves(ref)):
            assert x.shape == y.shape, k
            torch.testing.assert_close(x, y, rtol=1e-5,
                                       atol=1e-5 * y.abs().max().item())
    # each rank's parameter shard is AdamW's update from its own moment
    # shards, bit for bit (the one-rank step's parameters are not compared
    # directly: where |g| is near AdamW's eps the first update
    # g / (|g| + eps) magnifies the float32 rounding of g)
    lr = cosine_schedule(3e-3, 2, 10)(0)
    cf = torch.ones((), dtype=torch.float32)
    c1, c2 = 1.0 - 0.9 ** cf, 1.0 - 0.95 ** cf
    got = whole("params")
    for x, p0, m, v in zip(got, tree_leaves(params), whole("m"), whole("v")):
        step = lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8)
        step = step + lr * 0.1 * p0.float()
        assert torch.equal(x, (p0.float() - step).to(p0.dtype))
    for x, y in zip(got, tree_leaves(p1)):
        assert x.shape == y.shape


def test_local_mesh_checks_the_group_size(local_mesh):
    with pytest.raises(ValueError, match=r"data 2 x model 1 = 2 ranks over "
                                         r"a process group of 1"):
        make_local_mesh(2, device="cpu")
    assert make_local_mesh(device="cpu").mesh_dim_names == ("data",
                                                            "model")


def test_local_mesh_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the production meshes, on a fake 512-rank group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    assert not dist.is_initialized()
    fake_group()
    yield {False: make_production_mesh(),
           True: make_production_mesh(multi_pod=True)}
    dist.destroy_process_group()


def test_production_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks or more"):
        make_production_mesh()


def test_spec_divisible_dims_sharded(meshes):
    s = spec_for_shape(meshes[False], (5120, 13824), ("embed", "ff"))
    assert s == (("data",), "model")
    assert _norm(s) == _norm(P(("data",), "model"))


def test_spec_non_divisible_falls_back(meshes):
    # 28 heads % 16 != 0 -> replicated head dim
    s = spec_for_shape(meshes[False], (3584, 28, 128),
                       ("embed", "heads", "head_dim"))
    assert s == (("data",), None, None)


def test_spec_axis_used_once(meshes):
    # expert dim takes `model`; ff cannot reuse it
    s = spec_for_shape(meshes[False], (16, 4096, 6400),
                       ("expert", "embed", "ff"))
    assert s == ("model", ("data",), None)


def test_spec_multipod_fsdp(meshes):
    s = spec_for_shape(meshes[True], (8192, 24576), ("embed", "ff"))
    assert s == (("pod", "data"), "model")


@pytest.mark.parametrize("multi", [False, True])
def test_logical_rules_equal_reference(meshes, multi):
    assert logical_rules(meshes[multi]) == JS.logical_rules(REF_MESH[multi])


@pytest.mark.parametrize("fsdp", ["config", 1 << 22])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_make_specs_equal_reference(meshes, arch, multi, fsdp):
    cfg = ARCHS[arch]
    fsdp = cfg.fsdp_min_elems if fsdp == "config" else fsdp
    ref = _ref_specs(arch, multi, fsdp)
    params = param_structs(cfg)
    got = _spec_leaves(make_specs(meshes[multi], params, PT.param_axes(cfg),
                                  fsdp_min_elems=fsdp))
    assert len(got) == len(ref) == len(tree_leaves(params))
    assert [_norm(s) for s in got] == [_norm(s) for s in ref]
    # the parameter trees line up leaf for leaf
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(s.shape) for s in jax.tree.leaves(_ref_shapes(arch))]
    sh = tree_leaves(make_shardings(meshes[multi], params, PT.param_axes(cfg),
                                    fsdp_min_elems=fsdp))
    assert [s.spec for s in sh] == got
    assert [s.placements for s in sh] == [placements_for(meshes[multi], s)
                                          for s in got]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_local_shapes_equal_reference_shard_shape(meshes, arch, multi):
    """Each parameter as a DTensor of the fake mesh: its local shape is the
    reference ``NamedSharding``'s shard shape for the same spec."""
    from torch.distributed.tensor import distribute_tensor

    cfg = ARCHS[arch]
    params = param_structs(cfg)
    sh = tree_leaves(make_shardings(meshes[multi], params,
                                    PT.param_axes(cfg)))
    ref = _ref_specs(arch, multi, 0)
    for t, s, r in zip(tree_leaves(params), sh, ref):
        want = NamedSharding(REF_MESH[multi], r).shard_shape(tuple(t.shape))
        d = distribute_tensor(t, s.mesh, s.placements, src_data_rank=None)
        assert tuple(d.to_local().shape) == tuple(want)
        assert s.shard_shape(tuple(t.shape)) == tuple(want)
