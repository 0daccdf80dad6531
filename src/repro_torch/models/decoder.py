"""The decode step as one device program: the port's counterpart of the
reference's ``decode = jax.jit(model.decode)`` (``examples/serve.py``),
one compiled program for every position because the position is a traced
scalar.

A ``Decoder`` is bound at construction to one parameter tree, one config,
a batch B and a cache length.  It owns static caches (laid out as
``init_caches(cfg, B, cache_len)``), the position as a 0-d int32 tensor
on the card, a token buffer (B, 1) int32 and a logits buffer (B, 1, V)
float32.  ``load(caches, index)`` copies a prefill's caches in: one copy
a request, never a capture.  A step is ``decode_step`` over those buffers
with the position read from the device, then the greedy token (``argmax``,
cast to int32 as the reference's ``astype(jnp.int32)``) written into the
token buffer and the position advanced on the device; a teacher-forced
step copies the given token in first.

On a card the first step runs eagerly (the warm-up: cuBLAS's handle and
workspace are set up outside any capture), and the next one captures the
step once into a CUDA graph (``graphs._capture``, the obs span
``decode:capture``, under ``torch.no_grad()``); that step and every later
one is a single replay.  The attention's KV chunk loop over a long cache
(``graphs.scan``) is recorded inline: a scan inside a capture runs its
blocks eagerly.  The graph reads the parameters in place and never copies
them; the decoder keeps a reference to every leaf, so none can be freed
under it, and a tree of its own, so a later change to the caller's dict
changes nothing.  Off a card, with parameters that require grad, under a
functorch transform, under a ``TorchDispatchMode``, inside another
capture or under ``graphs.capturing(False)`` the same step runs eagerly
(``graphs._capturable``); on a card nothing falls back silently: a
capture that fails raises, naming the architecture, the batch and the
cache length.  ``graphs.clear()`` drops the graph and its memory pool, and
the next step captures anew.

``decode_step`` itself stays the eager path and the A/B reference:
captured steps equal it bit for bit.
"""
from __future__ import annotations

import time

import torch

from repro_torch import graphs
from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_leaves, tree_map

from .transformer import decode_step, init_caches

__all__ = ["Decoder"]


class Decoder:
    """Greedy decoding for one (parameters, cfg, B, cache length) as one
    CUDA graph replay a token (module docstring)."""

    def __init__(self, params, cfg: ArchConfig, B: int, cache_len: int):
        self.params = tree_map(lambda t: t, params)
        self.cfg, self.B, self.cache_len = cfg, B, cache_len
        self.device = self.params["embed"].device
        self.where = (f"decode {cfg.name}, batch {B}, cache length "
                      f"{cache_len}")
        dev = self.device
        self.caches = init_caches(cfg, B, cache_len, device=dev)
        self.index = torch.zeros((), dtype=torch.int32, device=dev)
        self.token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self.logits = torch.zeros((B, 1, cfg.vocab), dtype=torch.float32,
                                  device=dev)
        self._tensors = (tree_leaves(self.params) + tree_leaves(self.caches)
                         + [self.index, self.token, self.logits])
        self._warm = False
        self._graph = None
        self.captures = 0            # captures made (one until a clear())
        self.capture_s = 0.0         # their host seconds
        graphs.hold(self)

    @property
    def pool_bytes(self) -> int:
        """The captured step's memory pool (0 before the capture)."""
        return self._graph.pool_bytes if self._graph is not None else 0

    def release(self) -> None:
        """Drop the captured step and its pool (``graphs.clear()``)."""
        self._graph = None

    def load(self, caches, index) -> None:
        """Copy a prefill's caches (``prefill(..., cache_len=)``'s, or any
        tree laid out as ``init_caches(cfg, B, cache_len)``) into the
        decoder's and set the position to ``index`` (an int or a 0-d
        integer tensor), the next token's."""
        src, dst = tree_leaves(caches), tree_leaves(self.caches)
        if len(src) != len(dst) or any(
                s.shape != d.shape or s.dtype != d.dtype
                for s, d in zip(src, dst)):
            raise ValueError(
                f"{self.where}: the caches are not laid out as init_caches("
                f"cfg, {self.B}, {self.cache_len}): "
                f"{[(tuple(s.shape), s.dtype) for s in src]}")
        with torch.no_grad():
            for d, s in zip(dst, src):
                d.copy_(s)
            if isinstance(index, torch.Tensor):
                self.index.copy_(index)
            else:
                self.index.fill_(int(index))

    def _step(self) -> None:
        """One decode step over the decoder's buffers (what is captured)."""
        logits, _ = decode_step(self.params, self.cfg, self.token,
                                self.caches, self.index)
        self.logits.copy_(logits)
        self.token.copy_(torch.argmax(logits[:, -1], dim=-1)[:, None])
        self.index.add_(1)

    def _advance(self) -> None:
        with torch.no_grad():
            capture = graphs._capturable(self._tensors)
            if not (capture and self._warm):
                # eagerly, the KV loop inline as a capture records it; on a
                # card the first step is the warm-up
                with graphs.capturing(False):
                    self._step()
                self._warm = self._warm or capture
                return
            if self._graph is None:
                t0 = time.perf_counter()
                self._graph = graphs._capture(self._step, self.where,
                                              self.device,
                                              span="decode:capture")
                self.capture_s += time.perf_counter() - t0
                self.captures += 1
            self._graph.replay()

    def step(self, token=None) -> torch.Tensor:
        """One step: teacher-forced on ``token`` (B, 1) when given, else on
        the last greedy token.  Returns the logits buffer (B, 1, V), which
        the next step overwrites."""
        if token is not None:
            self.token.copy_(token)
        self._advance()
        return self.logits

    def generate(self, n: int, token=None) -> torch.Tensor:
        """``n`` greedy steps from ``token`` (B, 1) when given, else from
        the token buffer -> the (B, n) int32 tokens, each appended on the
        device; one synchronize at the end.  ``logits`` holds the last
        step's."""
        out = torch.empty((self.B, n), dtype=torch.int32, device=self.device)
        if token is not None:
            self.token.copy_(token)
        for i in range(n):
            self._advance()
            out[:, i:i + 1].copy_(self.token)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out
