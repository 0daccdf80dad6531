"""The coded train step as one device program: the port's counterpart of
the reference's ``jax.jit(build_coded_train_step(...))``
(``repro.train.coded.CodedTrainer``), which XLA compiles once with the
backward pass through every ``lax.scan`` of the model zoo inside it.

A ``Stepper`` is bound at construction to one step function (``(params,
opt, tokens, labels, coeff, decode) -> (params, opt, metrics)``, as
``build_coded_train_step`` returns), one parameter layout, one AdamW state
layout (``m``, ``v``, ``count``) and one set of input shapes: tokens and
labels (m, g, S), ``coeff`` (m, g), ``decode`` (m,).  It owns static
buffers for all of these and for the metrics ``loss``, ``lr`` and
``grad_norm``.  ``load(params, opt)`` copies a caller's trees in; a step
copies the host batch and the decode weights into the input buffers, runs
the step function over the static buffers and copies the returned
parameters, moments, count and metrics back into them.  The step count
lives on the device (``opt.count``) and the learning rate is computed from
it, so nothing a step reads is a host value baked into a graph.

On a card the first step runs eagerly (the warm-up: cuBLAS's handles and
workspaces, the autograd thread's included, are set up outside any
capture), and the next step is captured once into a CUDA graph
(``graphs._capture``, which first returns the general pool's cached
blocks to the card: the warm-up leaves as much cached as the step's
temporaries, which the graph's own pool must hold again; the obs span
``train:capture``) with the forward and the backward pass of every
worker in it: a ``graphs.scan`` reached under ``torch.func`` runs its
blocks eagerly, so the graph records the model zoo's loops (the sLSTM
token loop, the mLSTM and Mamba chunk loops, the attention's KV chunk
loop) inline, in both directions.  That step and every later one is a
single replay.  Off a card, under ``graphs.capturing(False)``, under a
functorch transform or a ``TorchDispatchMode`` and inside another capture
the same body runs eagerly over the same buffers (``graphs._capturable``),
so the CPU runs the code that the card captures.  On a card nothing falls
back silently: a capture that fails raises, naming ``where``.
``graphs.clear()`` drops the graph and its memory pool, and the next step
captures anew.

The step function itself stays the eager path and the A/B reference:
captured steps equal it bit for bit.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["Stepper"]

METRICS = ("loss", "lr", "grad_norm")


def _static(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _layout(tree) -> list:
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(tree)]


class Stepper:
    """One coded train step for one (step function, parameter and state
    layout, batch shape) as one CUDA graph replay a step (module
    docstring).  ``batch`` is a first (tokens, labels, coeff, decode), as
    numpy arrays or tensors: the input buffers take its shapes and
    dtypes."""

    def __init__(self, step: Callable, params, opt, batch, where: str):
        self.fn, self.where = step, where
        self.params = tree_map(_static, params)
        self.opt = tree_map(_static, opt)
        self.device = tree_leaves(self.params)[0].device
        self.inputs = tuple(
            torch.empty(a.shape, dtype=a.dtype, device=self.device)
            for a in map(self._tensor, batch))
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        self.metrics = {k: torch.zeros_like(loss) for k in METRICS}
        self._tensors = (tree_leaves((self.params, self.opt))
                         + list(self.inputs) + list(self.metrics.values()))
        self._warm = False
        self._graph = None
        self.captures = 0            # captures made (one until a clear())
        self.capture_s = 0.0         # their host seconds
        graphs.hold(self)

    @staticmethod
    def _tensor(a) -> torch.Tensor:
        return (a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(a)))

    @property
    def pool_bytes(self) -> int:
        """The captured step's memory pool (0 before the capture)."""
        return self._graph.pool_bytes if self._graph is not None else 0

    def release(self) -> None:
        """Drop the captured step and its pool (``graphs.clear()``)."""
        self._graph = None

    def load(self, params, opt) -> None:
        """Copy a caller's parameters and optimizer state into the static
        buffers; the graph never reads or writes the caller's tensors."""
        if _layout((params, opt)) != _layout((self.params, self.opt)):
            raise ValueError(
                f"{self.where}: the parameters and optimizer state are not "
                f"laid out as the stepper's: {_layout((params, opt))}")
        with torch.no_grad():
            for d, s in zip(tree_leaves((self.params, self.opt)),
                            tree_leaves((params, opt))):
                d.copy_(s)

    def state(self):
        """(params, opt): clones of the static buffers, which later steps
        leave as they are."""
        return tree_map(lambda t: t.clone(), (self.params, self.opt))

    def _body(self) -> None:
        """One step over the stepper's buffers (what is captured)."""
        params, opt, metrics = self.fn(self.params, self.opt, *self.inputs)
        with torch.no_grad():
            for d, s in zip(tree_leaves((self.params, self.opt)),
                            tree_leaves((params, opt))):
                d.copy_(s)
            for k, buf in self.metrics.items():
                buf.copy_(metrics[k])

    def step(self, tokens, labels, coeff, decode) -> dict:
        """One step on this batch -> the metrics buffers ({loss, lr,
        grad_norm}, 0-d float32), which the next step overwrites."""
        with torch.no_grad():
            for buf, a in zip(self.inputs, (tokens, labels, coeff, decode)):
                a = self._tensor(a)
                if a.shape != buf.shape or a.dtype != buf.dtype:
                    raise ValueError(
                        f"{self.where}: an input of shape {tuple(a.shape)} "
                        f"and dtype {a.dtype} where the stepper holds "
                        f"{tuple(buf.shape)} {buf.dtype}")
                buf.copy_(a)
        capture = graphs._capturable(self._tensors)
        if not (capture and self._warm):
            # eagerly; on a card the first step is the warm-up, and an
            # eager step under capturing(False) leaves the stepper warm
            with graphs.capturing(False):
                self._body()
            self._warm = self._warm or capture
            return self.metrics
        if self._graph is None:
            t0 = time.perf_counter()
            self._graph = graphs._capture(self._body, self.where,
                                          self.device, span="train:capture")
            self.capture_s += time.perf_counter() - t0
            self.captures += 1
        self._graph.replay()
        return self.metrics
