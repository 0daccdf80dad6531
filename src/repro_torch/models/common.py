"""Shared model utilities: parameter-definition trees, norms, activations
(port of ``repro.models.common``).

Parameters are declared once as ``pdef(shape, axes)`` descriptor trees; the
same tree yields (a) initialized tensors and (b) logical-axis trees (the
reference maps them to mesh ``PartitionSpec``s; the port keeps them for
the layout).  Logical axis vocabulary:

    vocab, embed, heads, kv, head_dim, ff, expert, d_inner, d_state, dt_rank,
    conv, stack (the period-repeat axis), None (replicated)
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

__all__ = ["pdef", "tree_init", "tree_axes", "stack_defs", "rmsnorm",
           "layernorm", "act_fn", "gelu", "softcap", "Dtype", "cast"]

_PARAM = "__pdef__"


def pdef(shape, axes, init: str = "normal", scale: float | None = None,
         fan_in: int | None = None):
    """Declare a parameter: shape, logical axes (len == ndim), init kind.

    ``fan_in`` overrides the default (= prod(shape[:-1])) used for the
    1/sqrt(fan_in) normal init — needed for layouts like (embed, heads, hd)
    where the contraction dim is only ``embed``.
    """
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return {_PARAM: True, "shape": tuple(int(s) for s in shape),
            "axes": tuple(axes), "init": init, "scale": scale,
            "fan_in": fan_in}


def _is_def(x) -> bool:
    return isinstance(x, dict) and x.get(_PARAM) is True


def _materialize(d, gen: torch.Generator, dtype):
    """One parameter, drawn on the host."""
    shape, init, scale = d["shape"], d["init"], d["scale"]
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if init == "ones":
        return torch.ones(shape, dtype=dtype)
    if init == "normal":
        fan = d["fan_in"] or int(math.prod(shape[:-1])) or 1
        s = scale if scale is not None else 1.0 / math.sqrt(max(fan, 1))
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        return (s * x).to(dtype)
    if init == "mamba_dt_bias":
        # softplus^-1 of dt in [1e-3, 0.1], standard mamba init
        u = torch.empty(shape, dtype=torch.float32).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen)
        dt = torch.exp(u)
        return (dt + torch.log1p(-torch.exp(-dt))).to(dtype)
    if init == "mamba_A_log":
        # A = -(1..d_state) broadcast: log of it
        n = shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32).expand(shape)
        return torch.log(a).to(dtype)
    raise ValueError(f"unknown init {init}")


def tree_init(defs: Any, key, dtype=torch.float32, *, device=None):
    """Materialize a descriptor tree into a parameter tree on ``device``.

    ``key`` is an int seed or a CPU ``torch.Generator``.  The leaves are
    drawn on the host, one after another in sorted-key order (the
    reference's leaf order), with the reference's distributions, and then
    moved to ``device``: a seed gives the same parameters on the card and
    on the CPU.  The bits differ from ``jax.random``'s, so tests that
    compare the two packages carry the reference's parameters across
    (``models.convert``)."""
    device = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator().manual_seed(int(key))
    leaves = []

    def walk(d, path):
        if _is_def(d):
            leaves.append((path, d))
        elif isinstance(d, dict):
            for k in sorted(d):
                if k == _PARAM:
                    continue
                walk(d[k], path + (k,))
        else:
            raise TypeError(f"bad def node at {path}: {type(d)}")

    walk(defs, ())
    out: dict = {}
    for path, d in leaves:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _materialize(d, gen, dtype).to(device)
    return out


def tree_axes(defs: Any):
    """Extract the logical-axes tree (same structure, tuples at leaves)."""
    if _is_def(defs):
        return defs["axes"]
    return {k: tree_axes(v) for k, v in defs.items() if k != _PARAM}


def stack_defs(defs: Any, n: int):
    """Prepend a 'stack' axis of size n to every param in the tree."""
    if _is_def(defs):
        return pdef((n,) + defs["shape"], ("stack",) + defs["axes"],
                    init=defs["init"], scale=defs["scale"],
                    fan_in=defs["fan_in"])
    return {k: stack_defs(v, n) for k, v in defs.items() if k != _PARAM}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": gelu}[name]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


class Dtype:
    @staticmethod
    def of(name: str):
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[name]


def cast(tree, dtype):
    """Cast the floating leaves of a tree of tensors to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree
