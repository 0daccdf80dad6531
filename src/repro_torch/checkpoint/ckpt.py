"""Minimal-dependency checkpointing: flattened tensor tree -> npz + json
manifest (port of ``repro.checkpoint.ckpt``, same layout).

Path layout:  <dir>/step_<n>.npz  (+ .manifest.json with the step, the leaf
count and the tree's structure).  Leaves are ``leaf_<i>`` in the
reference's flatten order (dict keys sorted, tuples and NamedTuples in
order).  numpy has no bfloat16, so a bfloat16 leaf is stored as float32,
which holds it exactly; ``restore`` casts every leaf back to the
template's dtype and device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["save", "restore", "latest_step"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _structure(tree) -> str:
    """The tree's shape as text: '*' for a leaf."""
    return str(tree_map(lambda _: "*", tree))


def save(path_dir: str, step: int, tree) -> str:
    os.makedirs(path_dir, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    path = os.path.join(path_dir, f"step_{step}.npz")
    np.savez(path, **arrays)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": _structure(tree)}
    with open(path + ".manifest.json", "w") as f:
        json.dump(manifest, f)
    return path


def restore(path_dir: str, step: int, like):
    """Restore into the structure of ``like`` (dtype / device template)."""
    path = os.path.join(path_dir, f"step_{step}.npz")
    with np.load(path) as data:
        leaves = tree_leaves(like)
        if len(leaves) != len(data.files):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"template {len(leaves)}")
        new = [torch.from_numpy(data[f"leaf_{i}"]).to(
                   device=l.device, dtype=l.dtype)
               for i, l in enumerate(leaves)]
    return tree_unflatten(like, new)


def latest_step(path_dir: str) -> int | None:
    if not os.path.isdir(path_dir):
        return None
    steps = [int(f[5:-4]) for f in os.listdir(path_dir)
             if f.startswith("step_") and f.endswith(".npz")]
    return max(steps) if steps else None
