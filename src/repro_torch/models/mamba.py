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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.device import resolve_device

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
    di, ds = p["A_log"].shape
    dtr = p["dt_w"].shape[0]
    xdb = torch.matmul(x_conv, p["x_proj"])
    dt_raw, Bm, Cm = torch.split(xdb, [dtr, ds, ds], dim=-1)
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
    a, b, Cm = _ssm_inputs(dict(zip(_SCAN_WEIGHTS, consts)), x_conv)
    Ac, Bc = _chunk_scan(a, b)                             # (B,Q,di,ds)
    hs = Ac * h[:, None] + Bc                              # (B,Q,di,ds)
    return (torch.einsum("bqds,bqs->bqd", hs, Cm),), (hs[:, -1],)


def mamba_apply(p, x, cfg, return_cache: bool = False):
    """Full-sequence forward. x: (B, S, d) -> (B, S, d) [, MambaCache]."""
    B, S, d = x.shape
    di, ds, _, k = _dims(cfg)
    xz = torch.matmul(x, p["in_proj"])
    x_in, z = torch.chunk(xz, 2, dim=-1)
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
    ys, (h,) = graphs.scan(
        "mamba", _chunk, tuple(p[k] for k in _SCAN_WEIGHTS), (x_conv,), (h,),
        length=Sp, c=Q, static=())
    y = torch.cat([y for (y,) in ys], dim=1)[:, :S]
    x_conv = x_conv[:, :S]
    y = y + p["D"].float() * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = torch.matmul(y, p["out_proj"])
    if return_cache:
        conv_state = x_in[:, S - (k - 1):, :] if S >= k - 1 else F.pad(
            x_in, (0, 0, k - 1 - S, 0))
        return out, MambaCache(conv_state, h)
    return out


def mamba_decode(p, x, cache: MambaCache, cfg):
    """Single-token step. x: (B, 1, d) -> ((B, 1, d), new cache)."""
    xz = torch.matmul(x, p["in_proj"])
    x_in, z = torch.chunk(xz, 2, dim=-1)                   # (B,1,di)
    window = torch.cat([cache.conv, x_in], dim=1)          # (B,k,di)
    x_conv = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"])
                    + p["conv_b"])[:, None]
    a, b, Cm = _ssm_inputs(p, x_conv[:, 0])                # (B,di,ds)
    h = a * cache.ssm + b
    y = torch.einsum("bds,bs->bd", h, Cm)[:, None]         # (B,1,di)
    y = y + p["D"].float() * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    out = torch.matmul(y, p["out_proj"])
    return out, MambaCache(window[:, 1:], h)
