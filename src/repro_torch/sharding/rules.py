"""Logical-axis -> mesh placement rules, MaxText-style and divisibility-aware
(port of ``repro.sharding.rules``).

Every parameter and activation dim carries a logical name
(``models.common.pdef``).  ``make_specs`` maps the names to mesh axes and
falls back to replication when the dim is not divisible by the mesh axis's
size (e.g. qwen2's 28 heads on a 16-way model axis), or when an earlier dim
of the same tensor already took the mesh axis (expert weights take `model`
for the expert dim, so their ff dim stays unsharded).

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry a
tensor dim: ``None`` (replicated), a mesh axis name (``"model"``) or a
tuple of names (``("pod", "data")``, FSDP), so it compares with the
reference's entry by entry.  ``make_shardings`` turns each spec into a
:class:`NamedSharding`: a ``torch.distributed.device_mesh.DeviceMesh`` and
one DTensor placement a mesh dim, ``Shard(d)`` where an entry puts tensor
dim ``d`` on that mesh dim and ``Replicate()`` elsewhere.  A mesh here is
anything with ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh`` has
both), so the specs also come from a mesh shape alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["logical_rules", "make_specs", "make_shardings", "batch_axes",
           "axis_size", "batch_on_data", "seq_on_data", "spec_for_shape",
           "NamedSharding", "placements_for"]


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _size(mesh, name: str) -> int:
    return int(mesh.shape[_names(mesh).index(name)])


def logical_rules(mesh) -> dict:
    """Logical axis -> mesh axis (or tuple of axes for FSDP)."""
    fsdp = ("pod", "data") if "pod" in _names(mesh) else ("data",)
    return {
        "vocab": "model",
        "ff": "model",
        "heads": "model",
        "kv": "model",
        "expert": "model",
        "d_inner": "model",
        "embed": fsdp,           # FSDP: weight-shard the d_model dim
    }


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in _names(mesh) else ("data",)


def axis_size(mesh, entry) -> int:
    """The number of devices a spec entry (a name or a tuple) spans."""
    if isinstance(entry, tuple):
        return math.prod(_size(mesh, a) for a in entry)
    return _size(mesh, entry)


def batch_on_data(B: int, mesh) -> bool:
    """Whether the data axes (``batch_axes``) take a global batch of
    ``B``, each rank its rows: they divide it."""
    n = axis_size(mesh, batch_axes(mesh))
    return B % n == 0 and B >= n


def seq_on_data(B: int, C: int, mesh) -> bool:
    """Whether an attention cache of ``C`` slots at a global batch of ``B``
    holds its sequence on the data axes (context-parallel decode): the
    reference's rule (``repro.launch.specs._cache_specs``), where the data
    axes do not take the batch and divide ``C``; otherwise the cache stays
    whole on every data rank.  The rule reads no field of the config.
    The placement (``launch.specs``) and the compute
    (``models.attention.seq_shard`` under ``tp.data_axis``) both ask it,
    so what is placed and what is computed agree."""
    return (not batch_on_data(B, mesh)
            and C % axis_size(mesh, batch_axes(mesh)) == 0)


def spec_for_shape(mesh, shape, axes, rules=None,
                   fsdp_min_elems: int = 0) -> tuple:
    """The spec of one tensor given the logical axis of each dim.

    ``fsdp_min_elems``: parameters smaller than this stay replicated
    instead of FSDP-sharded (gathering a small tensor costs more in
    collectives than it saves in memory)."""
    rules = rules or logical_rules(mesh)
    n_elems = int(math.prod(shape)) if shape else 1
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        entry = rules.get(name) if name else None
        if entry is None:
            entries.append(None)
            continue
        if (isinstance(entry, tuple) and fsdp_min_elems
                and n_elems < fsdp_min_elems):
            entries.append(None)
            continue
        flat = set(entry) if isinstance(entry, tuple) else {entry}
        if flat & used or dim % axis_size(mesh, entry):
            entries.append(None)
            continue
        used |= flat
        entries.append(entry)
    return tuple(entries)


def make_specs(mesh, shapes_tree: Any, axes_tree: Any,
               fsdp_min_elems: int = 0) -> Any:
    """Tree of specs for a (shape tree, logical-axes tree) pair.

    ``shapes_tree``'s leaves are tensors (meta tensors do) or anything with
    a ``shape``; ``axes_tree`` is the matching ``models.common.tree_axes``
    output (tuples of names at the leaves).  Leaves pair in the port's
    tree order, which is the reference's."""
    return tree_unflatten(shapes_tree, _flat_specs(
        mesh, shapes_tree, axes_tree, fsdp_min_elems))


def _flat_specs(mesh, shapes_tree, axes_tree, fsdp_min_elems) -> list:
    flat_s = tree_leaves(shapes_tree)
    flat_a = _axes_leaves(axes_tree)
    if len(flat_s) != len(flat_a):
        raise ValueError(f"{len(flat_s)} tensors but {len(flat_a)} axis "
                         f"tuples")
    return [spec_for_shape(mesh, tuple(s.shape), a,
                           fsdp_min_elems=fsdp_min_elems)
            for s, a in zip(flat_s, flat_a)]


def _axes_leaves(tree) -> list:
    """The axis tuples of an axes tree, in the port's tree order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]
    return [tuple(tree)]


def placements_for(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d``'s entry names, ``Replicate()`` on the rest.
    A tuple entry shards its dim over its mesh dims in mesh order, as the
    reference's tuple entry does."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(name)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec placed on a mesh: the reference's ``NamedSharding`` (a leaf
    of the port's trees, not a node)."""
    mesh: Any                 # torch.distributed.device_mesh.DeviceMesh
    spec: tuple               # per-dim entries, as the reference's
    placements: tuple         # one DTensor placement a mesh dim

    def shard_shape(self, shape) -> tuple:
        """The local shape of a tensor of global ``shape`` on one device
        (specs only shard dims their axes divide)."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            if entry is not None:
                out[d] //= axis_size(self.mesh, entry)
        return tuple(out)


def make_shardings(mesh, shapes_tree: Any, axes_tree: Any,
                   fsdp_min_elems: int = 0) -> Any:
    """Tree of :class:`NamedSharding` for a (shape tree, axes tree) pair."""
    return tree_unflatten(shapes_tree, [
        NamedSharding(mesh, s, placements_for(mesh, s))
        for s in _flat_specs(mesh, shapes_tree, axes_tree, fsdp_min_elems)])
