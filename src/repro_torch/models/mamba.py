"""Mamba-1 selective SSM block (Jamba's recurrent layer; port of
``repro.models.mamba``).

A CHUNKED PARALLEL SCAN, as in the reference: the sequence is split into
chunks of ``cfg.mamba_chunk``; a loop carries the (B, d_inner, d_state)
state across chunks (``repro_torch.graphs.scan``, a chunk a block: on a
card captured once a chunk shape into a CUDA graph and replayed, the
counterpart of the reference's ``lax.scan``), and within a chunk a
log-step (Hillis-Steele) scan composes the recurrence

    h_t = a_t * h_{t-1} + b_t,   a_t = exp(dt_t A),  b_t = dt_t B_t x_t

as (a2*a1, a2*b1 + b2) in log2(Q) steps (7 at Q = 128), where the
reference's ``lax.associative_scan`` combines the same pairs in a tree of
another shape: the products agree to float32 rounding, not bit for bit.

On a ``model`` axis (``sharding.tp``) whose rank holds a shard of
``d_inner`` (``A_log`` narrower than ``mamba_expand * d_model``), the
layer runs on the rank's di/n channels, as the reference's placement
splits them: ``in_proj``'s contiguous column shard times ``copy_to(x)``
exchanged into the rank's (x, z) channel pair (``tp.exchange_halves``),
the convolution, ``dt_w``, ``dt_b``, ``A_log``, ``D`` and the chunk loop on
those channels, ``x_proj`` row-parallel (its partial product all-reduced
once over the whole sequence, before the loop: dt_raw, B and C then
replicated and passed through ``copy_to``) and ``out_proj`` row-parallel
through ``reduce_from``; the cache holds the rank's channels.  Where the
axis does not divide d_inner the placement leaves the layer's leaves
whole and the layer runs whole.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.device import resolve_device
from repro_torch.sharding import tp

from .common import pdef

__all__ = ["mamba_defs", "mamba_apply", "mamba_decode", "MambaCache",
           "init_mamba_cache"]


def _dims(cfg):
    di = cfg.mamba_expand * cfg.d_model
    dtr = cfg.mamba_dt_rank or max(cfg.d_model // 16, 1)
    return di, cfg.mamba_d_state, dtr, cfg.mamba_conv


def mamba_defs(cfg):
    d = cfg.d_model
    di, ds, dtr, k = _dims(cfg)
    return {
        "in_proj": pdef((d, 2 * di), ("embed", "d_inner")),
        "conv_w": pdef((k, di), (None, "d_inner"), scale=1.0 / math.sqrt(k)),
        "conv_b": pdef((di,), ("d_inner",), init="zeros"),
        "x_proj": pdef((di, dtr + 2 * ds), ("d_inner", None)),
        "dt_w": pdef((dtr, di), (None, "d_inner")),
        "dt_b": pdef((di,), ("d_inner",), init="mamba_dt_bias"),
        "A_log": pdef((di, ds), ("d_inner", "d_state"), init="mamba_A_log"),
        "D": pdef((di,), ("d_inner",), init="ones"),
        "out_proj": pdef((di, d), ("d_inner", "embed")),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, k-1, d_inner) last inputs for the causal conv
    ssm: torch.Tensor   # (B, d_inner, d_state) recurrent state, float32


def init_mamba_cache(cfg, B: int, dtype, *, device=None) -> MambaCache:
    """Zero Mamba cache on ``device`` (unset: the CUDA card)."""
    device = resolve_device(device)
    di, ds, _, k = _dims(cfg)
    return MambaCache(
        torch.zeros((B, k - 1, di), dtype=dtype, device=device),
        torch.zeros((B, di, ds), dtype=torch.float32, device=device))


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, di); w: (k, di) -> (B, S, di)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, j:j + x.shape[1], :] * w[j] for j in range(k))
    return out + b


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(p, x_conv):
    """Common selective-SSM input computation. x_conv: (..., di)."""
    return _ssm_gates(p, x_conv, *_x_split(p, torch.matmul(x_conv,
                                                           p["x_proj"])))


def _x_split(p, xdb):
    """``x_proj``'s product (..., dtr + 2 ds) -> dt_raw, B, C."""
    ds, dtr = p["A_log"].shape[1], p["dt_w"].shape[0]
    return torch.split(xdb, [dtr, ds, ds], dim=-1)


def _ssm_gates(p, x_conv, dt_raw, Bm, Cm):
    """The recurrence's a, b and C from ``x_proj``'s parts."""
    dt = _softplus(torch.matmul(dt_raw, p["dt_w"]).float()
                   + p["dt_b"].float())                    # (..., di)
    A = -torch.exp(p["A_log"].float())                     # (di, ds)
    a = torch.exp(dt[..., None] * A)                       # (..., di, ds)
    b = (dt[..., None] * Bm.float()[..., None, :]
         * x_conv.float()[..., None])                      # (..., di, ds)
    return a, b, Cm.float()


def _chunk_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1 from h = 0:
    (prod a, h) at every t, in log2(Q) steps of (a2*a1, a2*b1 + b2)."""
    Q, s = a.shape[1], 1
    while s < Q:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


# the weights a chunk reads, copied into a captured chunk's static buffers
_SCAN_WEIGHTS = ("x_proj", "dt_w", "dt_b", "A_log")


def _chunk(consts, xs, carry):
    """One chunk of the selective scan: ``consts`` the ``_SCAN_WEIGHTS``,
    ``xs`` the chunk's convolved input (B, Q, di), ``carry`` the state h
    (B, di, ds) float32 -> ((the chunk's y (B, Q, di) float32,), (h at the
    chunk's end,))."""
    (x_conv,), (h,) = xs, carry
    return _chunk_out(*_ssm_inputs(dict(zip(_SCAN_WEIGHTS, consts)),
                                   x_conv), h)


# the weights a chunk on the rank's channels reads (``x_proj``'s product
# comes in with the chunk)
_TP_WEIGHTS = ("dt_w", "dt_b", "A_log")


def _chunk_tp(consts, xs, carry):
    """``_chunk`` on a model shard of the channels: ``xs`` the chunk's
    convolved input (B, Q, di/n) and its dt_raw, B and C (``x_proj``'s
    all-reduced product, split)."""
    x_conv, *parts = xs
    return _chunk_out(*_ssm_gates(dict(zip(_TP_WEIGHTS, consts)), x_conv,
                                  *parts), carry[0])


def _chunk_out(a, b, Cm, h):
    """A chunk's outputs and last state from its a, b, C and the state h
    before it."""
    Ac, Bc = _chunk_scan(a, b)                             # (B,Q,di,ds)
    hs = Ac * h[:, None] + Bc                              # (B,Q,di,ds)
    return (torch.einsum("bqds,bqs->bqd", hs, Cm),), (hs[:, -1],)


def _sharded(p, cfg) -> bool:
    """The layer's channels are the rank's model shard."""
    return p["A_log"].shape[0] < _dims(cfg)[0]


def _in_proj(p, x, cfg):
    """(x_in, z), each (..., channels): the rank's channel pair on a model
    shard, else the whole halves."""
    if _sharded(p, cfg):
        xz = tp.exchange_halves(torch.matmul(tp.copy_to(x), p["in_proj"]))
    else:
        xz = torch.matmul(x, p["in_proj"])
    return torch.chunk(xz, 2, dim=-1)


def _x_parts(p, x_conv):
    """dt_raw, B and C from the rank's channels: ``x_proj`` row-parallel,
    the sum used alike on every rank's channels."""
    xdb = tp.copy_to(tp.reduce_from(torch.matmul(x_conv, p["x_proj"])))
    return _x_split(p, xdb)


def _out(p, y, sharded: bool):
    """``out_proj`` of the gated output, row-parallel on a model shard."""
    out = torch.matmul(y, p["out_proj"])
    return tp.reduce_from(out) if sharded else out


def mamba_apply(p, x, cfg, return_cache: bool = False):
    """Full-sequence forward. x: (B, S, d) -> (B, S, d) [, MambaCache]."""
    B, S, d = x.shape
    _, ds, _, k = _dims(cfg)
    sharded = _sharded(p, cfg)
    x_in, z = _in_proj(p, x, cfg)
    di = x_in.shape[-1]
    x_conv = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))

    Q = min(cfg.mamba_chunk, S)
    Sp = ((S + Q - 1) // Q) * Q          # pad tail (causal: outputs unaffected)
    if Sp != S:
        # Padded steps would decay the carried state (dt(0) != 0), so the
        # final state is only returned for divisible lengths.
        if return_cache:
            raise ValueError(f"prefill length {S} must be a multiple of the "
                             f"mamba chunk {Q} to build a cache")
        x_conv = F.pad(x_conv, (0, 0, 0, Sp - S))

    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    if sharded:
        ys, (h,) = graphs.scan(
            "mamba", _chunk_tp, tuple(p[k] for k in _TP_WEIGHTS),
            (x_conv, *_x_parts(p, x_conv)), (h,), length=Sp, c=Q, static=())
    else:
        ys, (h,) = graphs.scan(
            "mamba", _chunk, tuple(p[k] for k in _SCAN_WEIGHTS), (x_conv,),
            (h,), length=Sp, c=Q, static=())
    y = torch.cat([y for (y,) in ys], dim=1)[:, :S]
    x_conv = x_conv[:, :S]
    y = y + p["D"].float() * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = _out(p, y, sharded)
    if return_cache:
        conv_state = x_in[:, S - (k - 1):, :] if S >= k - 1 else F.pad(
            x_in, (0, 0, k - 1 - S, 0))
        return out, MambaCache(conv_state, h)
    return out


def mamba_decode(p, x, cache: MambaCache, cfg):
    """Single-token step. x: (B, 1, d) -> ((B, 1, d), new cache); on a
    model shard of the channels the cache is the rank's."""
    sharded = _sharded(p, cfg)
    x_in, z = _in_proj(p, x, cfg)                          # (B,1,di)
    window = torch.cat([cache.conv, x_in], dim=1)          # (B,k,di)
    x_conv = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"])
                    + p["conv_b"])[:, None]
    if sharded:
        a, b, Cm = _ssm_gates(p, x_conv[:, 0], *_x_parts(p, x_conv[:, 0]))
    else:
        a, b, Cm = _ssm_inputs(p, x_conv[:, 0])            # (B,di,ds)
    h = a * cache.ssm + b
    y = torch.einsum("bds,bs->bd", h, Cm)[:, None]         # (B,1,di)
    y = y + p["D"].float() * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return _out(p, y, sharded), MambaCache(window[:, 1:], h)
