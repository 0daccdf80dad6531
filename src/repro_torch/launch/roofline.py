"""Roofline terms of a step traced on the meta device (the port's counterpart
of ``repro.launch.hlo_analysis``).

The reference parses the compiled, SPMD-partitioned XLA HLO text: dot flops
with while bodies multiplied by their trip counts, an HBM-traffic estimate
and collective bytes by kind (``analyze_hlo``, ``top_hotspots``,
``_shape_bytes``).  PyTorch has no HLO and no partitioner, so that parser
has no counterpart here.  The three terms come from:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode`` over the step run
  on meta tensors (shapes and dtypes, no storage), which counts the matrix
  products (``mm``, ``bmm``) of the whole, unpartitioned program.  Per
  device is that total over ``n_chips``: a lower bound wherever a dim falls
  back to replication, since the partitioned program repeats the
  replicated work on every device.  Two corrections make the count the
  reference's:

  - the recompute that ``cfg.remat_policy`` implies for a train step (the
    reference wraps each scanned period in ``jax.checkpoint``; PyTorch's
    ``torch.utils.checkpoint`` cannot run under ``torch.func.grad``).  The
    forward of every period is recorded with its dataflow, and the products
    whose outputs the backward pass needs are counted once more: under
    ``"full"`` every such product (XLA drops the rest, e.g. the last
    projection of a period, whose output only feeds the carried residual),
    under ``"dots"`` only those with batch dims (attention's scores and
    values, the experts' batched products), since
    ``dots_with_no_batch_dims_saveable`` saves the others; ``"none"`` adds
    nothing.  The rule is held against the reference's analysis
    (``tests/test_torch_roofline.py``) at the smoke variants of
    deepseek-7b and phi3.5-moe under each policy and of jamba, xlstm-350m
    and whisper-small under ``"full"``; the other architectures' recompute
    is not checked against it;
  - the sLSTM's token loop (``models.xlstm._slstm_loop``): the step is
    traced with the loop cut to one and to two tokens, and the difference,
    one step of the loop, is multiplied by the trip count, as the
    reference's analysis multiplies a while body.

* **bytes**: the argument bytes a device holds (each leaf's local shard
  under its placements) plus the step's output bytes.

* **collectives**: what the placements imply: one all-gather of each
  FSDP-sharded parameter in the forward pass, one in the backward pass and,
  under ``"full"`` remat, one in the recompute; one reduce-scatter of its
  gradient.  Activation collectives on the ``model`` axis (the tensor
  parallel all-reduces, MoE all-to-alls) are not counted: without a
  partitioner nothing says where they fall.

Constants are the H100 SXM5's (``H100``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, bmm_flop, mm_flop

from repro_torch.models import transformer as T
from repro_torch.models import xlstm as xl

__all__ = ["H100", "COLLECTIVES", "count_flops", "step_flops",
           "remat_flops", "slstm_trips", "local_bytes", "collective_bytes",
           "roofline"]

H100 = {
    # dense bfloat16 tensor-core peak, FLOP/s (NVIDIA H100 SXM5 datasheet)
    "peak_flops": 989e12,
    # HBM3 bytes/s, the figure the port's kernel bounds use (PERF.md)
    "hbm_bw": 3.35e12,
    # NVLink 4, bytes/s a direction (NVIDIA H100 SXM5 datasheet: 900 GB/s
    # both directions)
    "link_bw": 450e9,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def count_flops(fn: Callable) -> tuple[float, dict]:
    """(total flops, flops by operator) of ``fn()`` by ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as fc:
        fn()
    by_op = {str(k): float(v)
             for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return float(fc.get_total_flops()), by_op


# ------------------------------------------------------------ sLSTM trips --

@contextlib.contextmanager
def slstm_trips(steps: int):
    """Run the sLSTM token loop for its first ``steps`` tokens only, the
    last hidden state standing in for the rest (same shapes, the loop's
    own flops ``steps`` times)."""
    full = xl._slstm_loop

    def cut(p, R, xz, xi, xf, xo, state):
        hs, state = full(p, R, xz[:, :steps], xi[:, :steps], xf[:, :steps],
                         xo[:, :steps], state)
        rest = hs[:, -1:].expand(-1, xz.shape[1] - steps, -1, -1)
        return torch.cat([hs, rest], dim=1), state

    xl._slstm_loop = cut
    try:
        yield
    finally:
        xl._slstm_loop = full


def _has_slstm(cfg) -> bool:
    return any(b.kind == "slstm" for b in cfg.period)


def step_flops(cfg, fn: Callable[[], dict], trips: int) -> dict:
    """``fn()`` -> a dict of flop counts, with the sLSTM loop's ``trips``
    tokens counted as one traced step times the trip count: ``fn`` is
    traced with the loop cut to 1 and to 2 tokens and each count
    extrapolated, f1 + (trips - 1) (f2 - f1).  Other architectures trace
    once."""
    if not _has_slstm(cfg) or trips <= 2:
        return fn()
    with slstm_trips(1):
        f1 = fn()
    with slstm_trips(2):
        f2 = fn()
    return {k: f1.get(k, 0.0) + (trips - 1) * (f2.get(k, 0.0) - f1.get(k, 0.0))
            for k in set(f1) | set(f2)}


# ---------------------------------------------------------- remat recompute --

# operators whose derivative needs none of their floating inputs' values
_LINEAR = frozenset("""
add sub rsub neg sub_ add_ view _unsafe_view reshape expand permute transpose
t unsqueeze squeeze slice select split split_with_sizes unbind cat stack
clone contiguous _to_copy copy_ detach alias sum mean constant_pad_nd flip
index gather embedding where masked_fill masked_fill_ zeros_like ones_like
empty_like new_zeros new_ones fill_ tril triu cumsum lift_fresh
scalar_tensor index_put index_put_ scatter scatter_add select_backward
slice_backward
""".split())
# bilinear operators: an input is needed when another input needs a grad
_BILINEAR = frozenset(("mul", "mm", "bmm", "dot", "matmul"))
_PRODUCTS = {"mm": mm_flop, "bmm": bmm_flop}


class _Tape(TorchDispatchMode):
    """Records each operator's tensor inputs and outputs while ``on`` (the
    record keeps them alive, so their ids stay unique)."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.ops: list = []
        self.carries: dict = {}       # id -> tensor leaving a period

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.on:
            ins = [a for a in pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            self.ops.append((func._overloadpacket.__name__, ins, outs))
        return out


def _needed_inputs(name: str, ins: list) -> list:
    """The inputs whose values the operator's derivative reads."""
    fl = [t for t in ins if t.is_floating_point()]
    if name in _LINEAR or not any(t.requires_grad for t in fl):
        return []
    if name in _BILINEAR:
        return [t for t in fl
                if any(u.requires_grad for u in fl if u is not t)]
    if name == "div" and len(ins) == 2:
        a, b = ins
        return [b] + ([a] if b.requires_grad else [])
    return fl


def _product(name: str, ins: list):
    """(flops, has batch dims) of a matrix product, else None."""
    if name not in _PRODUCTS:
        return None
    a, b = ins[0], ins[1]
    flops = _PRODUCTS[name](tuple(a.shape), tuple(b.shape))
    return float(flops), name == "bmm" and a.shape[0] > 1


@contextlib.contextmanager
def _periods_taped(cfg, tape: _Tape):
    """Record the blocks of every scanned period (the decoder's periods and
    the encoder's layers); the carry leaving each period is collected in
    ``tape.carries``."""
    block, encode = T._block_full, T._encode
    state = {"enc": False, "calls": 0}

    def taped_block(*args, **kwargs):
        tape.on = True
        try:
            out = block(*args, **kwargs)
        finally:
            tape.on = False
        state["calls"] += 1
        if state["enc"] or state["calls"] % len(cfg.period) == 0:
            x, _, aux = out
            for v in (x, *(aux or {}).values()):
                if isinstance(v, torch.Tensor):
                    tape.carries[id(v)] = v
        return out

    def taped_encode(*args, **kwargs):
        state["enc"] = True
        try:
            return encode(*args, **kwargs)
        finally:
            state["enc"] = False

    T._block_full, T._encode = taped_block, taped_encode
    try:
        yield
    finally:
        T._block_full, T._encode = block, encode


def remat_flops(cfg, forward: Callable[[], object]) -> float:
    """The products ``cfg.remat_policy`` recomputes in the backward pass of
    a train step whose forward pass is ``forward()`` (run here with the
    parameters requiring grad, under plain autograd)."""
    policy = cfg.remat_policy
    if policy == "none":
        return 0.0
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    tape = _Tape()
    with tape, _periods_taped(cfg, tape):
        forward()
    needed = set()
    for name, ins, _ in tape.ops:
        needed.update(id(t) for t in _needed_inputs(name, ins))
    total = 0.0
    for name, ins, outs in reversed(tape.ops):
        if not any(id(o) in needed for o in outs):
            continue
        if any(id(o) in tape.carries for o in outs):
            continue                  # the carry is saved, not recomputed
        prod = _product(name, ins)
        if prod is not None:
            flops, batched = prod
            if policy == "dots" and not batched:
                continue              # saved: a dot with no batch dims
            total += flops
        needed.update(id(t) for t in ins)
    return total


# ---------------------------------------------------------------- terms ---

def _local_bytes(t: torch.Tensor, sharding) -> int:
    return math.prod(sharding.shard_shape(tuple(t.shape))) * t.element_size()


def local_bytes(tree, shardings) -> int:
    """The bytes one device holds of a tensor tree under a matching tree of
    ``NamedSharding``s (each leaf's local shard)."""
    from repro_torch.tree import tree_leaves

    leaves, shs = tree_leaves(tree), tree_leaves(shardings)
    if len(leaves) != len(shs):
        raise ValueError(f"{len(leaves)} tensors but {len(shs)} shardings")
    return sum(_local_bytes(t, sh) for t, sh in zip(leaves, shs))


def collective_bytes(params, shardings, axes, *, passes: int,
                     reduce_scatter: bool) -> dict:
    """Collective output bytes a device that the placements imply (module
    docstring): ``passes`` all-gathers of each FSDP-sharded parameter and,
    for a train step, one reduce-scatter of its gradient.  ``count``
    counts a stacked leaf's collectives once a layer, as the reference's
    loop-aware count does a scanned body's.  ``axes`` is the parameters'
    logical-axes tree (``transformer.param_axes``)."""
    from repro_torch.sharding import axis_size
    from repro_torch.sharding.rules import _axes_leaves
    from repro_torch.tree import tree_leaves

    out = {k: 0.0 for k in COLLECTIVES}
    count = 0
    for t, sh, ax in zip(tree_leaves(params), tree_leaves(shardings),
                         _axes_leaves(axes)):
        fsdp = [e for e in sh.spec if isinstance(e, tuple)]
        if not fsdp:
            continue
        local = _local_bytes(t, sh)
        per = t.shape[0] if ax and ax[0] == "stack" else 1
        out["all-gather"] += passes * local * axis_size(sh.mesh, fsdp[0])
        count += passes * per
        if reduce_scatter:
            out["reduce-scatter"] += local
            count += per
    out["count"] = count
    return out


def roofline(flops: float, nbytes: float, coll: dict, n_chips: int,
             model_flops: float | None = None) -> dict:
    """Three roofline terms (seconds) on the H100 and the bottleneck, with
    the reference's record keys.  ``flops`` is the global program's (per
    device: over ``n_chips``), ``nbytes`` a device's argument and output
    bytes, ``coll`` ``collective_bytes``' dict."""
    per_dev = flops / n_chips
    cbytes = float(sum(coll.get(k, 0.0) for k in COLLECTIVES))
    terms = {
        "compute_s": per_dev / H100["peak_flops"],
        "memory_s": nbytes / H100["hbm_bw"],
        "collective_s": cbytes / H100["link_bw"],
    }
    bottleneck = max(terms, key=terms.get)
    out = {**terms, "bottleneck": bottleneck.replace("_s", ""),
           "hlo_flops_per_device": per_dev,
           "hlo_bytes_per_device": float(nbytes),
           # no compiler cost analysis exists for a PyTorch program
           "hlo_bytes_cost_analysis": None,
           "hlo_bytes_traffic_est": float(nbytes),
           "collective_bytes_per_device": cbytes,
           "collective_count": coll.get("count", 0),
           # the one loop with a trip count (the sLSTM's) is counted
           "unknown_trip_counts": 0,
           "n_chips": n_chips}
    if model_flops is not None:
        out["model_flops"] = model_flops
        out["useful_ratio"] = model_flops / flops if flops else 0.0
    return out
