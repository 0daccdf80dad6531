"""Parameter trees of the port: nested dicts (and tuples, lists,
NamedTuples) whose leaves are tensors or arrays, walked in the reference's
``jax.tree_util`` order — dict keys sorted at every level, sequences in
order — so a flattened gradient, a checkpoint's leaves and a converted
parameter tree line up with the reference's one leaf at a time."""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "tree_paths"]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_paths(tree, path: tuple = ()):
    """(path, leaf) pairs in flatten order; a path is the keys / indices
    from the root."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_paths(x, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves in flatten order."""
    return [x for _, x in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        if hasattr(tree, "_fields"):               # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out
