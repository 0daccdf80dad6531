"""Multi-pod dry run on the meta device: trace every (arch x shape) step on
the production mesh's placements and extract H100 roofline terms (port of
``repro.launch.dryrun``).

The reference lowers and compiles each step for 512 placeholder devices.
Here rank 0's program runs once on meta tensors (shapes and dtypes, no
storage) under ``FlopCounterMode`` and ``roofline.LiveBytes``, on a
``DeviceMesh`` of a fake 512-rank process group: the parameters (and a
train step's AdamW moments) are ``DTensor`` shards laid out by
``sharding.make_shardings`` (``train.steps.place_params`` /
``place_train_state``, the reference's ``in_shardings``), the inputs are
rank 0's shards as ``launch.specs.input_shardings`` lays them, and the
step is the partitioned program (``build_train_step(grad_specs=)`` and
the serve steps given shards): the data axes gathered, the model axis
computed on shards with its collectives recorded (``sharding.tp``), and
long_500k's decode on the rank's sequence shard of each attention cache
with the data group's all-reduces of the merged softmax recorded
(context-parallel decode).
Nothing is allocated, so every configuration runs on the CPU.
``launch.roofline`` says what each term counts and what it cannot see.

Runs as its own process: ``main`` creates the fake group (which serves the
16 x 16 and the 2 x 16 x 16 mesh), importing this module does not.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out runs/dryrun
  (--mesh single|multi|both; one JSON record per combination)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.models import transformer as T
from repro_torch.models.common import Dtype
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.sharding import axis_size, make_shardings, tp
from repro_torch.train.steps import (batch_extras, build_decode_step,
                                     build_prefill_step, build_train_step,
                                     gather, mesh_of, place_params,
                                     place_train_state)
from repro_torch.tree import tree_leaves, tree_map

from .mesh import make_production_mesh
from .roofline import (COLLECTIVES, LiveBytes, alias_bytes,
                       collective_bytes, count_flops, held_bytes,
                       remat_flops, roofline)
from .specs import (cache_struct, input_shardings, input_specs,
                    output_shardings, param_structs, shape_config)

__all__ = ["dryrun_one", "trace_step", "fake_group", "main"]

WORLD = 512


def fake_group() -> None:
    """A fake process group of 512 ranks in this process (rank 0), enough
    for both production meshes; its collectives move no data."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)


def trace_step(cfg, kind: str, params, inputs, seq_len: int, *, opt=None,
               grad_specs=None, loops: bool = True,
               live: LiveBytes | None = None,
               collectives: tp.Recorder | None = None,
               global_batch: int | None = None) -> tuple[dict, tuple]:
    """Run one ``kind`` step ("train", "prefill" or "decode") on meta
    ``params`` and ``inputs`` (``specs.input_specs``' structure; ``opt``
    the AdamW state of a train step) under the flop counters -> (flops by
    operator, with the traced program's ``"total"`` and the ``"remat"``
    recompute it includes, zero but for a train step; the step's
    outputs).  ``DTensor`` parameters make it the rank's program on their
    mesh (``train.steps``).  ``seq_len`` is prefill's cache length and
    decode's position plus one.  ``loops``: each ``graphs.scan`` loop
    counted as one body times its trip count (``roofline.count_flops``);
    ``False`` traces every block.  ``live``: a ``roofline.LiveBytes`` that
    the step runs under.  ``collectives``: a ``tp.Recorder`` that takes
    the model axis's collectives (under ``"full"`` remat the periods'
    forward ones twice) and, at a batch the data axes do not take, the
    data axis's (context-parallel decode).  ``global_batch``: the batch
    the inputs are rank 0's share of (``specs.input_shardings``), which
    the serve steps take to place the caches; unset, every cache whole
    (``build_prefill_step``)."""
    outs: dict = {}
    forward = None
    if kind == "train":
        step = build_train_step(cfg, cosine_schedule(3e-4, 100, 10000),
                                grad_specs=grad_specs)
        run = lambda: step(params, opt, inputs)  # noqa: E731

        def forward():
            pgrad = tree_map(lambda p: p.detach().requires_grad_(),
                             gather(params, T.model_shards(cfg)))
            with tp.model_axis(mesh_of(params)):
                return T.forward(pgrad, cfg, inputs["tokens"],
                                 **batch_extras(cfg, inputs))
    elif kind == "prefill":
        step = build_prefill_step(cfg, cache_len=seq_len,
                                  global_batch=global_batch)
        run = lambda: step(params, inputs)  # noqa: E731
    else:  # decode: position seq_len - 1 being generated
        token, caches, _ = inputs
        step = build_decode_step(cfg, cache_len=seq_len,
                                 global_batch=global_batch)
        run = lambda: step(params, token, caches, seq_len - 1)  # noqa: E731

    with tp.recording(collectives):
        flops, by_op = count_flops(lambda: outs.update(out=run()),
                                   loops=loops, live=live)
    re = remat_flops(cfg, forward, loops=loops,
                     collectives=collectives) if forward else 0.0
    return {"total": flops + re, "remat": re, **by_op}, outs["out"]


def _rank_inputs(inputs, shardings):
    """Rank 0's shard of each meta input (``specs.input_specs``'
    structure) under ``shardings`` (``specs.input_shardings``'): the batch
    over the data axes where it divides, the attention caches' kv heads,
    the Mamba caches' d_inner channels and the xLSTM caches' heads on
    ``model`` where they divide (as the layers compute on those shards),
    the attention caches' sequence over the data axes for a batch of
    one."""
    def local(t, sh):
        shape = list(t.shape)
        for d, e in enumerate(sh.spec):
            if e is not None:
                shape[d] //= axis_size(sh.mesh, e)
        return torch.empty(shape, dtype=t.dtype, device="meta")

    return tree_map(local, inputs, shardings)


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True, extra_overrides: dict | None = None,
               hotspots: bool = False) -> dict:
    """Trace one (arch, shape, mesh) combination; return its record, with
    the reference's keys.

    ``lower_s`` is the host time of the traces on meta.  ``compile_s`` is
    0.0: PyTorch compiles nothing here.  The memory entries are a
    device's bytes: ``argument_bytes_per_device`` the shards the program
    holds (parameters; for a train step the AdamW moments' shards, which
    take the parameters' placements, and the replicated step count; the
    inputs), ``output_bytes_per_device`` likewise of what it returns (a
    train step's new parameters, state and replicated metrics; prefill's
    last-position logits and caches; decode's logits and caches),
    ``alias_bytes_per_device`` the arguments it writes in place and
    returns (``roofline.alias_bytes``: a train step's parameters, moments
    and count, decode's caches; prefill none) and ``temp_bytes_per_device``
    rank 0's traced step's peak live bytes above its arguments
    (``roofline.LiveBytes``): an estimate of the eager, un-rematerialised
    program, high where the reference rematerialises and low in a train
    step's counted loops (``launch.roofline`` names both biases).  The
    argument and output bytes come from the placements of the whole
    tensors; flops and temp bytes from rank 0's trace
    (``hlo_flops_per_device``), collectives from the placements (FSDP) and
    the trace (the model axis; ``launch.roofline``).
    """
    cfg = shape_config(ARCHS[arch], shape_name)
    if extra_overrides:
        cfg = cfg.with_overrides(**extra_overrides)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    shp = SHAPES[shape_name]
    B, S = shp["global_batch"], shp["seq_len"]
    kind, inputs = input_specs(cfg, shape_name)
    in_sh = input_shardings(cfg, shape_name, mesh)

    params = param_structs(cfg)
    axes = T.param_axes(cfg)
    psh = make_shardings(mesh, params, axes,
                         fsdp_min_elems=cfg.fsdp_min_elems)
    opt = None
    if kind == "train":
        opt = adamw_init(params, dtype=Dtype.of(cfg.optstate_dtype))
        # the moments take the parameters' placements, the count replicated
        params, opt = place_train_state(params, opt, psh)
        args = held_bytes(params) + held_bytes(opt)
    else:
        params = place_params(params, psh)
        args = held_bytes(params)
    # rank 0's inputs, each with the bytes its placement holds
    local = _rank_inputs(inputs, in_sh)
    args += [(t, n) for t, (_, n) in zip(tree_leaves(local), held_bytes(
        inputs, in_sh))]
    live = LiveBytes(known=[t for t, _ in args])
    rec = tp.Recorder()

    t0 = time.perf_counter()
    counts, out = trace_step(cfg, kind, params, local, S, opt=opt,
                             grad_specs=psh, live=live, collectives=rec,
                             global_batch=B)
    t_lower = time.perf_counter() - t0
    flops = counts.pop("total")

    if kind == "train":
        out_bytes = sum(n for _, n in held_bytes(out))
    else:   # the whole outputs' structure under their placements
        whole = (torch.empty((B, 1, cfg.vocab), device="meta"),
                 cache_struct(cfg, B, S))
        out_bytes = sum(n for _, n in held_bytes(
            whole, output_shardings(cfg, shape_name, mesh)))

    if hotspots:
        print("--- top operators by flops (FlopCounterMode) ---")
        for op, f in sorted(counts.items(), key=lambda kv: -kv[1])[:18]:
            if f:
                name = "remat recompute" if op == "remat" else op
                print(f"  {name:30s} flops={f:.3e} ({f / flops:.1%})")

    n_tokens = B * (S if kind in ("train", "prefill") else 1)
    n_active = T.count_params(cfg, active_only=True)
    mult = 6.0 if kind == "train" else 2.0
    model_flops = mult * n_active * n_tokens
    passes = 1
    if kind == "train":
        passes = 3 if cfg.remat_policy == "full" else 2
    coll = collective_bytes(params, psh, axes, passes=passes,
                            reduce_scatter=kind == "train")
    for k, n in rec.bytes.items():
        coll[k] += n
    coll["count"] += rec.count
    arg_bytes = sum(n for _, n in args)
    rl = roofline(flops * n_chips, arg_bytes + out_bytes, coll, n_chips,
                  model_flops=model_flops)

    rec = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "param_count": T.count_params(cfg),
        "param_count_active": n_active,
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": live.peak,
            "alias_bytes_per_device": alias_bytes(args, out),
        },
        "roofline": rl,
        "collectives": {**{k: coll[k] for k in COLLECTIVES},
                        "count": coll["count"]},
    }
    if verbose:
        print(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON records")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--override", default=None,
                    help="JSON dict of ArchConfig overrides (perf iteration)")
    ap.add_argument("--hotspots", action="store_true",
                    help="print FlopCounterMode's top operators")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    overrides = json.loads(args.override) if args.override else None

    import logging

    import torch.distributed as dist
    # DTensor warns of sequential all-gathers on the two-pod FSDP axes;
    # the fake group moves no data
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    own = not dist.is_initialized()
    if own:
        fake_group()
    failures = []
    try:
        for arch in archs:
            for shape in shapes:
                for multi in meshes:
                    tag = f"{arch}|{shape}|{'multi' if multi else 'single'}"
                    try:
                        rec = dryrun_one(arch, shape, multi,
                                         verbose=not args.quiet,
                                         extra_overrides=overrides,
                                         hotspots=args.hotspots)
                        status = "OK"
                    except Exception as e:  # noqa: BLE001 — report, go on
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if multi else "16x16",
                               "error": repr(e)}
                        failures.append(tag)
                        status = "FAIL"
                    print(f"[{status}] {tag}", flush=True)
                    if args.out:
                        os.makedirs(args.out, exist_ok=True)
                        fname = tag.replace("|", "__") + ".json"
                        with open(os.path.join(args.out, fname), "w") as f:
                            json.dump(rec, f, indent=2)
    finally:
        if own:
            dist.destroy_process_group()
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all dry-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
