"""The port's launchers (``repro_torch.launch``: input stand-ins and their
placements, the coded training CLI, the meta-device dry run's records)
against the JAX package's (``repro.launch``), on the CPU.

Tolerances:
  * exact: input shapes, dtypes and spec entries for every (arch, shape)
    pair on both production meshes, caches included; the CLI's simulated
    times (the same engine draws); the dry run's parameter counts and its
    argument bytes a device, against the sum of the reference's
    ``NamedSharding.shard_shape`` bytes for the same specs;
  * rel 1e-4: the CLI's losses over 3 steps from the reference's initial
    parameters (AdamW's first steps move each weight by about lr whatever
    the gradient's size; ``test_torch_coded_sgd``'s bound).

The dry-run tests share one fake 512-rank process group, made once and
destroyed at the module's end (a test file stays on one xdist worker).
"""
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

import repro.configs as JCONF
import repro.launch.specs as JSP
import repro.launch.train as JL
import repro.models.transformer as JT
import repro.sharding as JS
import repro_torch.launch.train as PL
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import make_production_mesh
from repro_torch.launch.dryrun import dryrun_one, fake_group
from repro_torch.launch.specs import (input_shardings, input_specs,
                                      shape_config)
from repro_torch.models import params_from_numpy
from repro_torch.tree import tree_leaves

ARCH_NAMES = sorted(ARCHS)
SHAPE_NAMES = sorted(SHAPES)
LOSS_RTOL = 1e-4


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return AbstractMesh(tuple(sizes), tuple(names))


REF_MESH = {False: _abstract_mesh((16, 16), ("data", "model")),
            True: _abstract_mesh((2, 16, 16), ("pod", "data", "model"))}


def _norm(spec) -> tuple:
    """A spec with each one-name tuple entry as the bare name, the form
    ``PartitionSpec`` normalizes its entries to."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, (NamedSharding, P)))


# ---------------------------------------------------------------------------
# the coded training CLI
# ---------------------------------------------------------------------------

CLI_ARGV = ["--arch", "deepseek-7b", "--smoke", "--steps", "3",
            "--seq-len", "32", "--rows-per-worker", "1", "--m-workers", "4",
            "--wait-k", "3"]


def test_train_cli_matches_reference_from_its_parameters(tmp_path,
                                                         monkeypatch):
    """``repro.launch.train`` as a user runs it, and the port's body from
    the reference's initial parameters (the reference trainer's seeded
    ``init_params``, carried across)."""
    out = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", ["train"] + CLI_ARGV
                        + ["--history-out", str(out)])
    JL.main()
    ref = json.loads(out.read_text())
    jp = JT.init_params(JCONF.ARCHS["deepseek-7b"].smoke_variant(),
                        jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    args = PL.parser().parse_args(CLI_ARGV + ["--device", "cpu"])
    _, _, hist = PL.train(ARCHS["deepseek-7b"].smoke_variant(), args, params)
    assert len(hist) == len(ref) == 3
    assert [h["sim_time_s"] for h in hist] == [r["sim_time_s"] for r in ref]
    assert [h["active"] for h in hist] == [r["active"] for r in ref]
    assert [h["exact"] for h in hist] == [r["exact"] for r in ref]
    pl = np.asarray([h["loss"] for h in hist])
    rl = np.asarray([r["loss"] for r in ref])
    assert np.max(np.abs(pl - rl) / np.abs(rl)) <= LOSS_RTOL
    assert set(hist[0]) == set(ref[0])


def test_train_main_on_cpu(tmp_path, capsys):
    out = tmp_path / "hist.json"
    argv = ["--arch", "deepseek-7b", "--smoke", "--steps", "2", "--seq-len",
            "16", "--device", "cpu", "--history-out", str(out)]
    assert PL.main(argv) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    hist = json.loads(out.read_text())
    assert len(hist) == 2 and [h["step"] for h in hist] == [0, 1]
    assert last == (f"final loss: {hist[-1]['loss']:.4f}; simulated "
                    f"wall-clock: {hist[-1]['sim_time_s']:.1f}s")


def test_train_main_flags_are_the_reference_flags_and_device():
    import argparse

    def flags(ap):
        return {a.dest for a in ap._actions
                if not isinstance(a, argparse._HelpAction)}

    captured = {}

    def fake_parse(self, *a, **k):
        captured["flags"] = flags(self)
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", fake_parse)
        with pytest.raises(SystemExit):
            JL.main()
    assert flags(PL.parser()) == captured["flags"] | {"device"}


def test_train_main_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.main(["--smoke", "--steps", "1"])


# ---------------------------------------------------------------------------
# input stand-ins and their placements
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    assert not dist.is_initialized()
    fake_group()
    yield {False: make_production_mesh(),
           True: make_production_mesh(multi_pod=True)}
    dist.destroy_process_group()


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_and_shardings_equal_reference(meshes, arch, shape):
    jcfg = JSP.shape_config(JCONF.ARCHS[arch], shape)
    cfg = shape_config(ARCHS[arch], shape)
    assert cfg.period == tuple(type(cfg.period[0])(**vars(b))
                               for b in jcfg.period)
    jkind, jin = JSP.input_specs(jcfg, shape)
    kind, inputs = input_specs(cfg, shape)
    assert kind == jkind
    ref = jax.tree.leaves(jin)
    got = tree_leaves(inputs)
    assert [tuple(r.shape) for r in ref] == [tuple(g.shape) for g in got]
    assert [_dtype_name(r.dtype) for r in ref] == [_dtype_name(g.dtype)
                                                   for g in got]
    assert all(g.device.type == "meta" for g in got)
    for multi in (False, True):
        rsh = _ref_leaves(JSP.input_shardings(jcfg, shape, REF_MESH[multi]))
        gsh = tree_leaves(input_shardings(cfg, shape, meshes[multi]))
        assert len(rsh) == len(gsh) == len(got)
        assert [_norm(g.spec) for g in gsh] == [_norm(r.spec) for r in rsh]
        assert [g.shard_shape(tuple(t.shape)) for g, t in zip(gsh, got)] \
            == [tuple(r.shard_shape(tuple(t.shape)))
                for r, t in zip(rsh, got)]


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "kind", "mesh", "n_chips", "lower_s",
            "compile_s", "param_count", "param_count_active", "memory",
            "roofline", "collectives"}
MEMORY_KEYS = {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "alias_bytes_per_device"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "bottleneck",
                 "hlo_flops_per_device", "hlo_bytes_per_device",
                 "hlo_bytes_cost_analysis", "hlo_bytes_traffic_est",
                 "collective_bytes_per_device", "collective_count",
                 "unknown_trip_counts", "n_chips", "model_flops",
                 "useful_ratio"}
COLL_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute", "count"}


def _ref_argument_bytes(arch, shape, multi, overrides):
    """A device's argument bytes under the reference's own specs: each
    leaf's ``NamedSharding.shard_shape`` bytes (parameters, for a train
    step the AdamW moments with the parameters' specs and the int32
    count, and the inputs)."""
    mesh = REF_MESH[multi]
    cfg = JSP.shape_config(JCONF.ARCHS[arch], shape)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    pdt = np.dtype(jnp.dtype(cfg.param_dtype))
    defs = JT.param_defs(cfg)

    def walk(d):
        if isinstance(d, dict) and d.get("__pdef__") is True:
            return jax.ShapeDtypeStruct(d["shape"], pdt)
        return {k: walk(v) for k, v in d.items() if k != "__pdef__"}

    params = walk(defs)
    specs = JS.make_specs(mesh, params, JT.param_axes(cfg),
                          fsdp_min_elems=cfg.fsdp_min_elems)

    def nbytes(leaves, shardings):
        return sum(math.prod(s.shard_shape(tuple(t.shape)))
                   * np.dtype(t.dtype).itemsize
                   for t, s in zip(leaves, shardings))

    pl = jax.tree.leaves(params)
    ps = [NamedSharding(mesh, s) for s in _ref_leaves(specs)]
    total = nbytes(pl, ps)
    kind, inputs = JSP.input_specs(cfg, shape)
    total += nbytes(jax.tree.leaves(inputs),
                    _ref_leaves(JSP.input_shardings(cfg, shape, mesh)))
    if kind == "train":
        odt = np.dtype(jnp.dtype(cfg.optstate_dtype)).itemsize
        total += 2 * sum(math.prod(s.shard_shape(tuple(t.shape))) * odt
                         for t, s in zip(pl, ps)) + 4
    return total


_RECORDS: dict = {}


def _record(arch, shape, multi, overrides=None):
    key = (arch, shape, multi, json.dumps(overrides, sort_keys=True))
    if key not in _RECORDS:
        _RECORDS[key] = dryrun_one(arch, shape, multi, verbose=False,
                                   extra_overrides=overrides)
    return _RECORDS[key]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dryrun_record_equals_reference_counts_and_bytes(meshes, arch):
    """Decode at 524 288 positions (batch 1: the caches' sequence dim over
    the data axes), the full depth of every architecture."""
    rec = _record(arch, "long_500k", False)
    jcfg = JSP.shape_config(JCONF.ARCHS[arch], "long_500k")
    assert set(rec) == REF_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["collectives"]) == COLL_KEYS
    assert rec["param_count"] == JT.count_params(jcfg)
    assert rec["param_count_active"] == JT.count_params(jcfg,
                                                        active_only=True)
    assert rec["kind"] == "decode" and rec["n_chips"] == 256
    assert rec["memory"]["argument_bytes_per_device"] == \
        _ref_argument_bytes(arch, "long_500k", False, None)
    mem = rec["memory"]
    # decode writes into its caches: they are its aliased arguments
    assert 0 < mem["alias_bytes_per_device"] < mem[
        "argument_bytes_per_device"]
    assert isinstance(mem["temp_bytes_per_device"], int)
    assert mem["temp_bytes_per_device"] > 0
    assert rec["compile_s"] == 0.0
    assert rec["roofline"]["hlo_flops_per_device"] > 0
    assert rec["roofline"]["model_flops"] == 2.0 * rec[
        "param_count_active"]


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch,shape", [("deepseek-7b", "train_4k"),
                                        ("phi3.5-moe-42b-a6.6b", "train_4k"),
                                        ("qwen2-vl-7b", "prefill_32k"),
                                        ("whisper-small", "decode_32k")])
def test_dryrun_argument_bytes_equal_reference(meshes, arch, shape, multi):
    """Train (parameters, AdamW moments, count and batch), prefill with
    patch inputs and decode with cross-attention caches, one period deep
    so the trace stays short."""
    ov = {"n_layers": len(ARCHS[arch].period)}
    rec = _record(arch, shape, multi, ov)
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert rec["n_chips"] == (512 if multi else 256)
    assert rec["memory"]["argument_bytes_per_device"] == \
        _ref_argument_bytes(arch, shape, multi, ov)
    alias = rec["memory"]["alias_bytes_per_device"]
    if SHAPES[shape]["kind"] == "prefill":
        assert alias == 0
    else:   # train: parameters, moments and count; decode: the caches
        assert 0 < alias < rec["memory"]["argument_bytes_per_device"]
    coll = rec["collectives"]
    if SHAPES[shape]["kind"] == "train":
        # full remat: 3 all-gathers of each FSDP-sharded parameter (forward,
        # recompute, backward) to one reduce-scatter of its gradient
        assert coll["reduce-scatter"] > 0
        assert coll["all-gather"] > coll["reduce-scatter"]
        assert rec["roofline"]["collective_count"] == coll["count"]
    else:
        assert coll["reduce-scatter"] == 0
