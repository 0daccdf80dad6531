"""Carry a parameter or cache tree across between the reference and the
port.

The reference's parameters are nested dicts of arrays with the same keys
and stacked ``(n_periods, ...)`` shapes as the port's (``param_defs`` is
the same descriptor tree), so a tree converts one array at a time.  The
tests make parameters with the reference's ``init_params``, convert them
with ``np.asarray`` leaf by leaf and hand them to :func:`params_from_numpy`;
optimizer state goes through :func:`state_from_numpy`.  Serve caches have
the same layout in both packages (a tuple over period positions of cache
NamedTuples, or ``(self, cross)`` pairs, stacked over n_periods):
:func:`caches_from_numpy` rebuilds each NamedTuple as the port's class of
the same name, :func:`caches_to_numpy` gives host arrays in the port's
classes, which the reference's ``decode_step`` takes as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import AdamWState
from repro_torch.tree import tree_map

from .attention import AttnCache
from .mamba import MambaCache
from .xlstm import MLSTMCache, SLSTMCache

__all__ = ["params_from_numpy", "params_to_numpy", "state_from_numpy",
           "caches_from_numpy", "caches_to_numpy"]

_CACHES = {c.__name__: c for c in (AttnCache, MambaCache, MLSTMCache,
                                   SLSTMCache)}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (the reference's arrays carry
        # ml_dtypes'); move the 16 bits as they are
        t = torch.from_numpy(np.array(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device=None):
    """A tree of arrays (numpy, or anything ``np.asarray`` takes) -> the same
    tree of tensors on ``device`` (unset: the CUDA card), dtypes kept."""
    device = resolve_device(device)
    return tree_map(lambda x: _tensor(x, device), tree)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: a tree of host arrays.
    bfloat16 leaves come out as float32, which holds them exactly."""
    return tree_map(_host, tree)


def _port_caches(tree, leaf):
    """Rebuild a cache tree with the port's NamedTuple classes."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _CACHES.get(type(tree).__name__)
        if cls is None or tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"not a serve cache: {type(tree).__name__}")
        return cls(*(_port_caches(x, leaf) for x in tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_port_caches(x, leaf) for x in tree)
    return leaf(tree)


def caches_from_numpy(tree, device=None):
    """A cache tree of arrays (the reference's ``prefill`` / ``init_caches``
    output, or :func:`caches_to_numpy`'s) -> the port's cache tree of
    tensors on ``device`` (unset: the CUDA card), dtypes kept."""
    device = resolve_device(device)
    return _port_caches(tree, lambda x: _tensor(x, device))


def caches_to_numpy(tree):
    """The port's cache tree -> the same tree of host arrays (bfloat16 as
    float32)."""
    return _port_caches(tree, _host)


def state_from_numpy(state, device=None) -> AdamWState:
    """An optimizer state with the reference's fields (``m``, ``v``,
    ``count``) -> the port's :class:`AdamWState` on ``device``."""
    device = resolve_device(device)
    return AdamWState(params_from_numpy(state.m, device),
                      params_from_numpy(state.v, device),
                      torch.tensor(int(np.asarray(state.count)),
                                   dtype=torch.int32, device=device))
