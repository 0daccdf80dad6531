"""The ``model`` axis computed on shards, Megatron style: the port's
counterpart of the reference's GSPMD program, where ``logical_rules`` puts
``heads``, ``kv``, ``ff``, ``vocab`` and ``expert`` on ``model`` and the
partitioner inserts the activation collectives between the shards.

A layer whose weights come in as the rank's model shard (it sees fewer
heads, ff columns, vocabulary rows or experts than its config names)
computes on that shard and meets the other ranks of its model group
through these autograd functions:

* ``copy_to``: identity forward, all-reduce of the gradient backward (the
  input of a column-parallel product, each rank's gradient a partial
  sum);
* ``reduce_from``: all-reduce forward, identity backward (the output of a
  row-parallel product, each rank's a partial sum);
* ``exchange_halves``: an all-to-all forward, the inverse all-to-all
  backward (a column-parallel product with a ``[first | second]`` weight
  split by contiguous columns, as the Mamba and mLSTM in-projections are,
  turned into the rank's own pair of channel blocks);
* ``reduce_scatter``: the sum over the group, each rank keeping its slice
  of one dim, forward; an all-gather of the gradient backward (the
  mLSTM's partial q, k, v and gates summed and cut to the rank's heads);
* ``gather_from``: an all-gather along one dim forward, the rank's slice
  of the gradient backward (the sLSTM's hidden states of the rank's heads
  made whole, then used alike on every rank).

All are ``torch.autograd.Function``s with a ``setup_context``, which
``torch.func.grad`` (the train step's) takes.  The collectives inside are
``torch.distributed._functional_collectives``' (``all_reduce``,
``all_to_all_single``, ``reduce_scatter_single``, ``all_gather_single``,
then ``wait_tensor``), called under ``no_grad``, which run on NCCL and
gloo groups and, on meta tensors, on the dry run's fake group.

``model_axis(mesh)`` makes the ``model`` sub-group of ``mesh`` the current
one for its duration (the train, prefill and decode steps enter it when
given shards); no mesh, or a ``model`` dim of one rank, means no model
axis, and a layer given whole weights calls none of this.  A layer given
a shard with no model axis set raises.

``data_axis(mesh)`` likewise makes the group of ``mesh``'s data dims (its
``batch_axes``, ``("pod", "data")`` flattened into one group in mesh
order) the current data axis: the serve steps enter it where the data
axes do not take the batch, and attention merges a softmax over the
caches' sequence shards through ``data_all_reduce_max`` /
``data_all_reduce_sum`` (context-parallel decode, ``models.attention``).

Every collective passes ``Recorder``s that the dry run enters
(``recording``): kind, output bytes and calls, each scaled by the blocks a
counted loop's block stands for (``scaled``, entered by the counters'
``graphs.counting`` hooks).
"""
from __future__ import annotations

import contextlib
import math

import torch

from .rules import batch_axes

__all__ = ["model_axis", "size", "rank", "copy_to", "reduce_from",
           "exchange_halves", "reduce_scatter", "gather_from",
           "all_reduce_max", "all_gather", "data_axis", "data_size",
           "data_rank", "data_mesh", "data_all_reduce_max",
           "data_all_reduce_sum", "Recorder", "recording", "record",
           "scaled"]

# (group, size, rank) of the current model axis, or None
_AXIS = None
# (group, size, rank, mesh) of the current data axis, or None
_DATA = None


@contextlib.contextmanager
def model_axis(mesh):
    """Within, the ``model`` dim of ``mesh`` (a ``DeviceMesh``) is the
    current model axis; ``None``, a mesh without a ``model`` dim or one
    where it spans one rank: no model axis."""
    global _AXIS
    axis = None
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" in names and mesh.size(names.index("model")) > 1:
        axis = (mesh.get_group("model"), mesh.size(names.index("model")),
                mesh.get_local_rank("model"))
    was, _AXIS = _AXIS, axis
    try:
        yield
    finally:
        _AXIS = was


def size() -> int:
    """The ranks of the current model axis (1 without one)."""
    return _AXIS[1] if _AXIS else 1


def rank() -> int:
    """This rank's index on the current model axis (0 without one)."""
    return _AXIS[2] if _AXIS else 0


def _group():
    if _AXIS is None:
        raise RuntimeError("a layer was given a model shard of its weights "
                           "but no model axis is set (tp.model_axis)")
    return _AXIS[0]


@contextlib.contextmanager
def data_axis(mesh):
    """Within, the data dims of ``mesh`` (a ``DeviceMesh``; its
    ``batch_axes``, every dim but ``model``) are the current data axis,
    their ranks in mesh order (row-major, as a tuple entry of a spec
    splits a dim); ``None``, or data dims that span one rank: no data
    axis."""
    global _DATA
    axis = None
    if mesh is not None:
        dims = batch_axes(mesh)
        n = math.prod(mesh.size(mesh.mesh_dim_names.index(d)) for d in dims)
        if n > 1:
            axis = (*_data_group_of(mesh, dims), mesh)
    was, _DATA = _DATA, axis
    try:
        yield
    finally:
        _DATA = was


# id(mesh) -> (mesh, (group, size, rank)) of meshes with several data dims
_FLAT: dict = {}


def _data_group_of(mesh, dims: tuple) -> tuple:
    """(group, size, rank) of ``mesh``'s data dims ``dims``: one dim's own
    group, or the dims flattened in mesh order, made once a mesh (every
    rank makes every group, as a new group needs).  Not
    ``DeviceMesh._flatten``: a flattened dim registered on the mesh would
    change how DTensor gathers the mesh's FSDP-sharded leaves later on."""
    if len(dims) == 1:
        return (mesh.get_group(dims[0]), mesh.size(
            mesh.mesh_dim_names.index(dims[0])), mesh.get_local_rank(dims[0]))
    if id(mesh) not in _FLAT:
        import torch.distributed as dist

        names = mesh.mesh_dim_names
        at = [names.index(d) for d in dims]
        rest = [i for i in range(len(names)) if i not in at]
        n = math.prod(mesh.size(i) for i in at)
        groups = mesh.mesh.permute(at + rest).reshape(n, -1).t().tolist()
        group, _ = dist.new_subgroups_by_enumeration(groups)
        me = dist.get_rank()
        mine = next(g for g in groups if me in g)
        _FLAT[id(mesh)] = (mesh, (group, n, mine.index(me)))
    return _FLAT[id(mesh)][1]


def data_size() -> int:
    """The ranks of the current data axis (1 without one)."""
    return _DATA[1] if _DATA else 1


def data_rank() -> int:
    """This rank's index on the current data axis (0 without one)."""
    return _DATA[2] if _DATA else 0


def data_mesh():
    """The mesh whose data dims are the current data axis, or ``None``."""
    return _DATA[3] if _DATA else None


def _data_group():
    if _DATA is None:
        raise RuntimeError("a data-axis collective with no data axis set "
                           "(tp.data_axis)")
    return _DATA[0]


@torch.no_grad()
def _all_reduce(x: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """The collective over ``group`` (unset: the model axis's) outside
    autograd (its own autograd kernel is an old-style Function, which
    ``torch.func.grad`` refuses in a backward)."""
    import torch.distributed._functional_collectives as funcol

    out = funcol.wait_tensor(funcol.all_reduce(
        x.contiguous(), op, _group() if group is None else group))
    record("all-reduce", out)
    return out


def data_all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the data axis, outside autograd."""
    return _all_reduce(x, "max", _data_group())


def data_all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data axis, outside autograd."""
    return _all_reduce(x, "sum", _data_group())


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum")


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _all_reduce(x, "sum")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every rank of the model group) entering a
    computation on the rank's shard: identity forward, the gradient
    all-reduced over the group backward."""
    _group()
    return _CopyTo.apply(x)


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of each rank's partial ``x``:
    all-reduce forward, identity backward."""
    return _ReduceFrom.apply(x)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model group, outside
    autograd (the vocabulary-parallel loss's shift)."""
    return _all_reduce(x, "max")


@torch.no_grad()
def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    vocabulary shards' logits made whole), outside autograd."""
    import torch.distributed._functional_collectives as funcol

    # ``all_gather_single`` where this torch has it (``all_gather_tensor``,
    # its older name, warns there)
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    dim = dim % x.dim()
    parts = funcol.wait_tensor(gather(x.contiguous(), 0, _group()))
    out = torch.cat(parts.chunk(size(), dim=0), dim=dim)
    record("all-gather", out)
    return out


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(x, dim):
        return all_gather(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dim = inputs
        ctx.dim, ctx.n = dim % x.dim(), x.shape[dim]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, rank() * ctx.n, ctx.n), None


def gather_from(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (an all-gather), whose
    gradient is the rank's slice of the whole one: for a result every rank
    of the group then uses alike, so its gradient is the same on each."""
    return _GatherFrom.apply(x, dim)


@torch.no_grad()
def _reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    # ``reduce_scatter_single`` where this torch has it, as ``all_gather``
    scatter = getattr(funcol, "reduce_scatter_single",
                      funcol.reduce_scatter_tensor)
    out = funcol.wait_tensor(scatter(x.contiguous(), "sum", dim % x.dim(),
                                     _group()))
    record("reduce-scatter", out)
    return out


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(x, dim):
        return _reduce_scatter(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim), None


def reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over the model group of each rank's partial ``x``, of which
    the rank keeps its slice of ``dim`` (``dim`` divided into ``size()``
    equal parts in rank order): a reduce-scatter forward, the all-gather
    of the gradient backward."""
    return _ReduceScatter.apply(x, dim)


def _pair_splits(c: int) -> tuple[list, list, bool]:
    """``exchange_halves``' all-to-all on this rank, each block ``c``
    channels: (the elements it sends to each rank, those it receives from
    each, whether its second block goes to a lower rank than its first).
    Of the 2n blocks of the product (the first half's n, then the
    second's), rank r holds blocks 2r and 2r + 1 and wants blocks r and
    n + r; block b goes to rank b mod n."""
    n, r = size(), rank()
    to = [(2 * r) % n, (2 * r + 1) % n]
    send = [c * to.count(d) for d in range(n)]
    recv = [c * [r // 2, (n + r) // 2].count(q) for q in range(n)]
    return send, recv, to[1] < to[0]


@torch.no_grad()
def _pairs(y: torch.Tensor, inverse: bool) -> torch.Tensor:
    """``exchange_halves`` (``inverse``: its inverse) outside autograd."""
    import torch.distributed._functional_collectives as funcol

    c = y.shape[-1] // 2
    send, recv, wrap = _pair_splits(c)
    if inverse:
        send, recv = recv, send
    x = y.movedim(-1, 0)            # the all-to-all splits dim 0
    if wrap and not inverse:        # blocks in the order of their ranks
        x = torch.cat([x[c:], x[:c]])
    out = funcol.wait_tensor(funcol.all_to_all_single(
        x.contiguous(), recv, send, _group()))
    record("all-to-all", out)
    if wrap and inverse:
        out = torch.cat([out[c:], out[:c]])
    return out.movedim(0, -1)


class _ExchangeHalves(torch.autograd.Function):
    @staticmethod
    def forward(y):
        return _pairs(y, False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _pairs(g, True)


def exchange_halves(y: torch.Tensor) -> torch.Tensor:
    """The rank's pair of channel blocks from its column shard of a
    product whose last dim is two halves side by side, ``[a | b]`` (an
    in-projection ``x @ w`` with ``w`` split by contiguous columns over n
    ranks: ranks 0..n/2-1 hold ``a``'s channels, the rest ``b``'s).  ``y``
    (..., 2c) is the rank's shard of the product; the result (..., 2c) is
    ``[a_r | b_r]``, rank r's c channels [r c, (r + 1) c) of each half.
    An all-to-all (each rank sends its two blocks where they belong and
    receives its two) forward, the inverse all-to-all backward; a rank
    moves 2c columns of ``y``'s rows, less those it keeps."""
    return _ExchangeHalves.apply(y)


# -- the dry run's count ------------------------------------------------------

class Recorder:
    """Collective output bytes (by kind: ``launch.roofline.COLLECTIVES``'
    names) and calls of the collectives run while it is entered."""

    def __init__(self):
        self.bytes: dict = {}
        self.count = 0

    def add(self, kind: str, nbytes: float, times: int) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0.0) + nbytes * times
        self.count += times


_RECORDERS: list = []
_TIMES = [1]


@contextlib.contextmanager
def recording(rec: Recorder | None):
    """Within, every collective adds itself to ``rec`` (``None``: no
    recorder)."""
    if rec is None:
        yield
        return
    _RECORDERS.append(rec)
    try:
        yield
    finally:
        _RECORDERS.remove(rec)


@contextlib.contextmanager
def scaled(times: int):
    """Within, a collective counts ``times`` times (a counted loop's block
    standing for ``times`` blocks)."""
    _TIMES.append(_TIMES[-1] * times)
    try:
        yield
    finally:
        _TIMES.pop()


def record(kind: str, out: torch.Tensor) -> None:
    """A collective of ``kind`` whose output on this rank is ``out``."""
    if _RECORDERS and _TIMES[-1]:
        n = out.numel() * out.element_size()
        for rec in _RECORDERS:
            rec.add(kind, n, _TIMES[-1])
