"""Roofline terms of a step traced on the meta device (the port's counterpart
of ``repro.launch.hlo_analysis``).

The reference parses the compiled, SPMD-partitioned XLA HLO text: dot flops
with while bodies multiplied by their trip counts, an HBM-traffic estimate
and collective bytes by kind (``analyze_hlo``, ``top_hotspots``,
``_shape_bytes``).  PyTorch has no HLO and no partitioner, so that parser
has no counterpart here.  The three terms come from:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode`` over the step run
  on meta tensors (shapes and dtypes, no storage), which counts the matrix
  products (``mm``, ``bmm``).  The dry run traces rank 0's program: its
  shards of the parameters, moments and inputs on the production mesh,
  the model axis computed on shards (``sharding.tp``), so the count is a
  device's, replicated work included wherever a dim falls back to
  replication (qwen2-vl's 28 heads on 16 ranks), as the reference's
  partitioned HLO counts it.  Two corrections make the count the
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
    (``tests/test_torch_roofline.py``) at the smoke variant of every
    architecture under ``"full"`` and of deepseek-7b, phi3.5-moe and
    whisper-small under each policy;
  - the model zoo's loops (the sLSTM token loop, the mLSTM and Mamba chunk
    loops, the attention's KV chunk loop; ``graphs.scan``): each is counted
    as one body times its trip count, as the reference's analysis
    multiplies a while body.  Under ``graphs.counting`` a run of like
    blocks is traced once and its operators, forward and backward, and its
    recompute's products are counted once for every block it stands for;
    the first block, the last full block and a shorter last block are
    traced on their own.  The counts equal the whole loop traced block by
    block exactly (``tests/test_torch_dryrun_terms.py``).

* **bytes**: the argument bytes a device holds (each leaf's local shard
  under its placements) plus the step's output bytes.

* **temp bytes** (``LiveBytes``): the peak, over the traced step (rank
  0's), of the bytes of the storages its operators create, alive at once
  (the arguments are not counted); in a loop's run of like blocks, what
  one block leaves alive counts once for every block of the run.  It is
  an estimate of the eager,
  un-rematerialised program, neither bound on what a compiled,
  partitioned step holds, with two biases of opposite sign: it counts
  high where the reference rematerialises, since the port's step keeps
  every activation its backward pass reads (2.93 times the reference's
  ``temp_size_in_bytes`` under ``"full"`` at deepseek-7b's smoke variant,
  1.56 under ``"none"``, where XLA fuses elementwise chains into one
  buffer); and it counts low in a train step's counted loops, whose
  blocks' backward temporaries are seen once a run (0.86-0.95 of the
  whole trace's peak; ``tests/test_torch_dryrun_terms.py``).

* **collectives**: the FSDP terms that the placements imply
  (``collective_bytes``: one all-gather of each FSDP-sharded parameter in
  the forward pass, one in the backward pass and, under ``"full"`` remat,
  one in the recompute; one reduce-scatter of its gradient), plus what
  rank 0's trace runs on the model axis (``sharding.tp.Recorder``): the
  activation all-reduces of attention, the MLP, the experts, the
  vocabulary-parallel embedding, logits and loss, the serve steps'
  all-gather of the last logits, the gather over ``model`` of the leaves
  computed whole (Mamba, xLSTM), and under ``"full"`` remat the
  periods' forward all-reduces once more, as the recompute repeats them.
  The decode steps' context-parallel caches (batch 1: the sequence over
  the data axes) are traced as rank 0's slice of positions; the softmax
  combine over the data axes that they would need is not counted.

Constants are the H100 SXM5's (``H100``).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Callable

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, bmm_flop, mm_flop

from repro_torch import graphs
from repro_torch.models import transformer as T
from repro_torch.sharding import tp

__all__ = ["H100", "COLLECTIVES", "count_flops", "remat_flops", "LiveBytes",
           "held_bytes", "alias_bytes", "collective_bytes", "roofline"]

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


def count_flops(fn: Callable, *, loops: bool = True,
                live: "LiveBytes | None" = None) -> tuple[float, dict]:
    """(total flops, flops by operator) of ``fn()`` by ``FlopCounterMode``.
    ``loops``: each ``graphs.scan`` loop on meta counted as one body times
    its trip count (``graphs.counting``); ``False`` traces it block by
    block.  ``live``: a ``LiveBytes`` that ``fn()`` runs under too."""
    fc = FlopCounterMode(display=False)

    def scaled(fn, extra):
        """Run ``fn()`` and count its flops ``extra`` times more."""
        g = fc.flop_counts["Global"]
        before = dict(g)
        out = fn()
        for k in list(g):
            g[k] += extra * (g[k] - before.get(k, 0))
        return out

    def hook(run, times, alone):
        with live.repeated(times) if live else contextlib.nullcontext() \
                as once, tp.scaled(times if alone is None else 1):
            # no backward: the block in its place counts for all
            out = scaled(run, times - 1 if alone is None else 0)
            if once is not None:      # the carry: the next block takes it
                once.update(_storage(t)._cdata for t in out[1])
        if times > 1 and alone is not None:
            # the block in its place counts once, forward and (later)
            # backward; a copy by itself makes up the rest
            with live.paused() if live else contextlib.nullcontext(), \
                    tp.scaled(times - 1):
                scaled(alone, times - 2)
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(fc)
        if live is not None:
            stack.enter_context(live)
        if loops:
            stack.enter_context(graphs.counting(hook))
        fn()
    by_op = {str(k): float(v)
             for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return float(fc.get_total_flops()), by_op


# ------------------------------------------------------------- live bytes --

def _storage(t: torch.Tensor):
    """The storage of ``t``: a ``DTensor``'s local shard's, a functorch
    wrapper's (a tensor seen inside ``torch.func.grad``) underlying
    tensor's."""
    from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return t.untyped_storage()


class LiveBytes(TorchDispatchMode):
    """The bytes alive at once of the storages the operators under it
    create: a new storage adds its bytes, its freeing (a weak reference's
    finalizer) takes them off, and ``peak`` is the most at any time.  The
    storages of ``known`` (a tree of the step's arguments; a ``DTensor``
    by its local shard) are not counted, nor a view's or an in-place
    result's, whose storage is not new.  Works on meta (sizes without
    data) and on a card."""

    def __init__(self, known=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._bytes: dict = {}   # storage key -> [bytes counted, weak ref]
        self._known = {_storage(t)._cdata for t in pytree.tree_leaves(known)
                       if isinstance(t, torch.Tensor)}
        self._off = False
        self._new = None         # the keys of the storages made in a repeat

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._off:
            for t in ((out,) if isinstance(out, torch.Tensor)
                      else pytree.tree_leaves(out)):
                if isinstance(t, torch.Tensor):
                    self._add(_storage(t))
        return out

    def _add(self, st) -> None:
        key = st._cdata
        if key in self._bytes or key in self._known:
            return
        n = st.nbytes()
        ref = weakref.ref(st, lambda _, key=key: self._free(key))
        self._bytes[key] = [n, ref]
        self.live += n
        self.peak = max(self.peak, self.live)
        if self._new is not None:
            self._new.add(key)        # a key freed and reused comes once

    def _free(self, key) -> None:
        n, _ = self._bytes.pop(key, (0, None))
        self.live -= n

    @contextlib.contextmanager
    def paused(self):
        """Nothing created within is counted (``count_flops``' copy of a
        block by itself)."""
        was, self._off = self._off, True
        try:
            yield
        finally:
            self._off = was

    @contextlib.contextmanager
    def repeated(self, times: int):
        """A block that stands for ``times`` blocks (``graphs.counting``):
        what it leaves alive counts ``times`` times, and its own peak sits
        above what the other ``times - 1`` left alive; the storages whose
        keys the caller adds to the set it yields (the carry, which each
        block hands on to the next) count once."""
        once: set = set()
        if times == 1:
            yield once
            return
        peak, self.peak, self._new = self.peak, self.live, set()
        try:
            yield once
        finally:
            kept = [self._bytes[k] for k in self._new
                    if k in self._bytes and k not in once]
            extra = (times - 1) * sum(e[0] for e in kept)
            for e in kept:
                e[0] *= times
            self.live += extra
            self.peak = max(peak, self.peak + extra)
            self._new = None


# ---------------------------------------------------------- remat recompute --

# operators whose derivative needs none of their floating inputs' values
_LINEAR = frozenset("""
add sub rsub neg sub_ add_ view _unsafe_view reshape expand permute transpose
t unsqueeze squeeze slice select split split_with_sizes unbind cat stack
clone contiguous _to_copy copy_ detach alias sum mean constant_pad_nd flip
index gather embedding where masked_fill masked_fill_ zeros_like ones_like
empty_like new_zeros new_ones fill_ tril triu cumsum lift_fresh
scalar_tensor index_put index_put_ scatter scatter_add select_backward
slice_backward all_reduce wait_tensor
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
        self.times = 1                # the blocks a loop's block stands for
        self.ops: list = []
        self.carries: dict = {}       # id -> tensor leaving a period

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.on:
            ins = [a for a in pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            self.ops.append((func._overloadpacket.__name__, ins, outs,
                             self.times))
        return out

    def repeat(self, run, times, alone):
        """``graphs.counting``'s hook: the block's products (and
        collectives) count ``times`` times."""
        was, self.times = self.times, times
        try:
            with tp.scaled(times):
                return run()
        finally:
            self.times = was


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
def _periods_taped(cfg, tape: _Tape, rec: "tp.Recorder | None" = None):
    """Record the blocks of every scanned period (the decoder's periods and
    the encoder's layers); the carry leaving each period is collected in
    ``tape.carries``, and the blocks' collectives go to ``rec``."""
    block, encode = T._block_full, T._encode
    state = {"enc": False, "calls": 0}

    def taped_block(*args, **kwargs):
        tape.on = True
        try:
            with tp.recording(rec):
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


def remat_flops(cfg, forward: Callable[[], object], *,
                loops: bool = True,
                collectives: "tp.Recorder | None" = None) -> float:
    """The products ``cfg.remat_policy`` recomputes in the backward pass of
    a train step whose forward pass is ``forward()`` (run here with the
    parameters requiring grad, under plain autograd).  ``loops`` as
    ``count_flops``'.  ``collectives``: under ``"full"``, the periods'
    forward collectives, which the recompute repeats, are added to it."""
    policy = cfg.remat_policy
    if policy == "none":
        return 0.0
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    tape = _Tape()
    with contextlib.ExitStack() as stack:
        stack.enter_context(tape)
        stack.enter_context(_periods_taped(
            cfg, tape, collectives if policy == "full" else None))
        if loops:
            stack.enter_context(graphs.counting(tape.repeat))
        forward()
    needed = set()
    for name, ins, _, _ in tape.ops:
        needed.update(id(t) for t in _needed_inputs(name, ins))
    total = 0.0
    for name, ins, outs, times in reversed(tape.ops):
        if not any(id(o) in needed for o in outs):
            continue
        if any(id(o) in tape.carries for o in outs):
            continue                  # the carry is saved, not recomputed
        prod = _product(name, ins)
        if prod is not None:
            flops, batched = prod
            if policy == "dots" and not batched:
                continue              # saved: a dot with no batch dims
            total += flops * times
        needed.update(id(t) for t in ins)
    return total


# ---------------------------------------------------------------- terms ---

def _local_bytes(t: torch.Tensor, sharding) -> int:
    return math.prod(sharding.shard_shape(tuple(t.shape))) * t.element_size()


def held_bytes(tree, shardings=None) -> list:
    """(leaf, the bytes a device holds of it) for each tensor leaf of
    ``tree``: a ``DTensor``'s local shard, a plain leaf's shard under the
    matching leaf of ``shardings`` (unset or ``None``: the whole leaf,
    replicated)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(tree)
    shs = (tree_leaves(shardings) if shardings is not None
           else [None] * len(leaves))
    if len(leaves) != len(shs):
        raise ValueError(f"{len(leaves)} leaves but {len(shs)} shardings")
    out = []
    for t, sh in zip(leaves, shs):
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, DTensor):
            n = t.to_local().numel() * t.element_size()
        elif sh is None:
            n = t.numel() * t.element_size()
        else:
            n = _local_bytes(t, sh)
        out.append((t, n))
    return out


def alias_bytes(args: list, outputs) -> int:
    """The bytes a device holds of the arguments (``held_bytes`` pairs)
    whose storage the step's ``outputs`` return: what it wrote in place
    into its inputs (the reference's aliased donated buffers)."""
    from repro_torch.tree import tree_leaves

    out = {_storage(t)._cdata for t in tree_leaves(outputs)
           if isinstance(t, torch.Tensor)}
    seen: dict = {}
    for t, n in args:
        key = _storage(t)._cdata
        if key in out:
            seen.setdefault(key, n)
    return sum(seen.values())


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
    the reference's record keys.  ``flops`` is the devices' total (a
    device's over ``n_chips``; the dry run passes rank 0's times
    ``n_chips``, as the reference's ``useful_ratio`` reads its total),
    ``nbytes`` a device's argument and output bytes, ``coll`` a device's
    collective bytes by kind and their ``count``."""
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
           # every loop (graphs.scan) is counted by its trip count
           "unknown_trip_counts": 0,
           "n_chips": n_chips}
    if model_flops is not None:
        out["model_flops"] = model_flops
        out["useful_ratio"] = model_flops / flops if flops else 0.0
    return out
