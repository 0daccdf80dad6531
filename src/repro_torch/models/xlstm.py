"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable) and
sLSTM (scalar memory with recurrent gate connections, inherently
sequential); port of ``repro.models.xlstm``.

mLSTM uses the stabilized CHUNKWISE form: a loop carries the per-head
matrix state (C: dk x dv, n: dk, log-scale m) across chunks; within a chunk
the output is computed in quadratic attention form with exponential-gating
decay weights.  The upper triangle is masked with -inf and m starts at
-1e30, as in the reference: exp(-inf) = 0 is what zeroes it.  sLSTM has
genuine recurrent weights R h_{t-1} in every gate, so it runs one step a
token, a step of small operations each.  Both loops run as blocks over
static buffers (``repro_torch.graphs.scan``: a chunk a block for the
mLSTM, ``_SLSTM_BLOCK`` tokens for the sLSTM), which a card captures once
a block shape into a CUDA graph and replays, the counterpart of the
reference's ``lax.scan``.

Stabilization follows the xLSTM appendix: every exponential is taken relative
to a running max m; the hidden read is h = num / max(|den|, exp(-m*)).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.device import resolve_device

from .common import pdef, rmsnorm

__all__ = ["mlstm_defs", "mlstm_apply", "mlstm_decode", "MLSTMCache",
           "init_mlstm_cache", "slstm_defs", "slstm_apply", "slstm_decode",
           "SLSTMCache", "init_slstm_cache"]


# ---------------------------------------------------------------- mLSTM ----

def _mdims(cfg):
    dp = int(cfg.xlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dk = dp // H
    return dp, H, dk


def mlstm_defs(cfg):
    d = cfg.d_model
    dp, H, dk = _mdims(cfg)
    return {
        "up": pdef((d, 2 * dp), ("embed", "d_inner")),
        "wq": pdef((dp, H, dk), ("d_inner", "heads", "head_dim"), fan_in=dp),
        "wk": pdef((dp, H, dk), ("d_inner", "heads", "head_dim"), fan_in=dp),
        "wv": pdef((dp, H, dk), ("d_inner", "heads", "head_dim"), fan_in=dp),
        "wi": pdef((dp, H), ("d_inner", None), scale=0.02),
        "wf": pdef((dp, H), ("d_inner", None), scale=0.02),
        "bi": pdef((H,), (None,), init="zeros"),
        "bf": pdef((H,), (None,), init="ones"),  # bias toward remembering
        "gn": pdef((dp,), ("d_inner",), init="zeros"),
        "down": pdef((dp, d), ("d_inner", "embed")),
    }


class MLSTMCache(NamedTuple):
    C: torch.Tensor  # (B, H, dk, dk) matrix memory (dv == dk here)
    n: torch.Tensor  # (B, H, dk) normalizer state
    m: torch.Tensor  # (B, H) running log-scale


def init_mlstm_cache(cfg, B: int, dtype, *, device=None) -> MLSTMCache:
    """Zero mLSTM cache on ``device`` (unset: the CUDA card)."""
    _, H, dk = _mdims(cfg)
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return MLSTMCache(torch.zeros((B, H, dk, dk), **f32),
                      torch.zeros((B, H, dk), **f32),
                      torch.full((B, H), -1e30, **f32))


def _mlstm_qkvg(p, x):
    """x: (B, S, d) -> q,k,v (B,S,H,dk) f32, li/lf (B,S,H) f32, z (B,S,dp)."""
    xz = torch.matmul(x, p["up"])
    xm, z = torch.chunk(xz, 2, dim=-1)
    q = torch.einsum("bse,ehk->bshk", xm, p["wq"]).float()
    k = torch.einsum("bse,ehk->bshk", xm, p["wk"]).float()
    k = k / math.sqrt(k.shape[-1])
    v = torch.einsum("bse,ehk->bshk", xm, p["wv"]).float()
    li = (torch.matmul(xm, p["wi"]) + p["bi"]).float()     # log input gate
    lf = F.logsigmoid((torch.matmul(xm, p["wf"]) + p["bf"]).float())
    return q, k, v, li, lf, z, xm


def _mlstm_chunk(consts, xs, carry):
    """One chunk of the chunkwise recurrence: ``consts`` (the causal mask
    ``tri``, (Q, Q) bool), ``xs`` the chunk's q, k, v (B, Q, H, dk) and log
    gates li, lf (B, Q, H), ``carry`` (C, n, m) -> ((the chunk's hidden
    states (B, Q, H, dk),), (C, n, m) at the chunk's end)."""
    (tri,) = consts
    qc, kc, vc, lic, lfc = xs
    C, n, m = carry
    Fc = torch.cumsum(lfc, dim=1)                        # (B,Q,H) log decay
    # intra-chunk log weights: w[t,s] = F_t - F_s + li_s  (s <= t)
    wl = (Fc[:, :, None] - Fc[:, None, :]
          + lic[:, None, :, :])                          # (B,Qt,Qs,H)
    wl = torch.where(tri[None, :, :, None], wl, -math.inf)
    # inter: log weight of carried state at t: F_t + m
    inter_l = Fc + m[:, None]                            # (B,Q,H)
    mstar = torch.maximum(wl.amax(dim=2), inter_l)       # (B,Q,H)
    wts = torch.exp(wl - mstar[:, :, None])              # (B,Qt,Qs,H)
    scores = torch.einsum("bthk,bshk->btsh", qc, kc) * wts
    num = torch.einsum("btsh,bshv->bthv", scores, vc)
    den = scores.sum(dim=2)          # q.n intra part: sum_s w_ts (q.k_s)
    w_int = torch.exp(inter_l - mstar)                   # (B,Q,H)
    num = num + w_int[..., None] * torch.einsum("bthk,bhkv->bthv", qc, C)
    den = den + w_int * torch.einsum("bthk,bhk->bth", qc, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-mstar))[..., None]
    # state update to end of chunk
    total = Fc[:, -1]                                    # (B,H)
    upd_l = total[:, None] - Fc + lic                    # (B,Q,H) weight of s
    m_new = torch.maximum(total + m, upd_l.amax(dim=1))
    wu = torch.exp(upd_l - m_new[:, None])               # (B,Q,H)
    carryw = torch.exp(total + m - m_new)                # (B,H)
    C = carryw[..., None, None] * C + torch.einsum(
        "bshk,bsh,bshv->bhkv", kc, wu, vc)
    n = carryw[..., None] * n + torch.einsum("bshk,bsh->bhk", kc, wu)
    return (h,), (C, n, m_new)


def mlstm_apply(p, x, cfg, return_cache: bool = False):
    """Full-sequence chunkwise mLSTM. x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    dp, H, dk = _mdims(cfg)
    q, k, v, li, lf, z, _ = _mlstm_qkvg(p, x)

    Q = min(cfg.mamba_chunk, S)
    Sp = ((S + Q - 1) // Q) * Q          # pad tail (causal: outputs unaffected)
    if Sp != S:
        if return_cache:
            raise ValueError(f"prefill length {S} must be a multiple of the "
                             f"chunk {Q} to build a cache")
        pad = Sp - S
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li, lf = (F.pad(t, (0, 0, 0, pad)) for t in (li, lf))
        z = F.pad(z, (0, 0, 0, pad))

    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    hs, (C, n, m) = graphs.scan(
        "mlstm", _mlstm_chunk, (tri,), (q, k, v, li, lf),
        tuple(init_mlstm_cache(cfg, B, x.dtype, device=x.device)),
        length=Sp, c=Q, static=())
    h = torch.cat([h for (h,) in hs], dim=1).reshape(B, Sp, dp)[:, :S]
    h = rmsnorm(h, p["gn"])                              # per-channel norm
    h = h * F.silu(z[:, :S])
    out = torch.matmul(h.to(x.dtype), p["down"])
    if return_cache:
        return out, MLSTMCache(C, n, m)
    return out


def mlstm_decode(p, x, cache: MLSTMCache, cfg):
    """Single-step mLSTM. x: (B, 1, d)."""
    B = x.shape[0]
    dp, H, dk = _mdims(cfg)
    q, k, v, li, lf, z, _ = _mlstm_qkvg(p, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                  # (B,H,dk)
    li, lf = li[:, 0], lf[:, 0]                          # (B,H)
    m_new = torch.maximum(lf + cache.m, li)
    fw = torch.exp(lf + cache.m - m_new)
    iw = torch.exp(li - m_new)
    C = fw[..., None, None] * cache.C + iw[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fw[..., None] * cache.n + iw[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.einsum("bhk,bhk->bh", q, n)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    h = h.reshape(B, 1, dp)
    h = rmsnorm(h, p["gn"]) * F.silu(z)
    out = torch.matmul(h.to(x.dtype), p["down"])
    return out, MLSTMCache(C, n, m_new)


# ---------------------------------------------------------------- sLSTM ----

def _sdims(cfg):
    H = cfg.n_heads
    dh = cfg.d_model // H
    fs = ((4 * cfg.d_model // 3 + 63) // 64) * 64  # post-up-projection 4/3
    return H, dh, fs


def slstm_defs(cfg):
    d = cfg.d_model
    H, dh, fs = _sdims(cfg)
    gates = {}
    for g in "zifo":
        gates[f"w{g}"] = pdef((d, H, dh), ("embed", "heads", "head_dim"),
                              fan_in=d)
        gates[f"r{g}"] = pdef((H, dh, dh), ("heads", "head_dim", None),
                              fan_in=dh, scale=0.5 / math.sqrt(dh))
        gates[f"b{g}"] = pdef((H, dh), ("heads", "head_dim"),
                              init="ones" if g == "f" else "zeros")
    return {
        **gates,
        "gn": pdef((d,), ("embed",), init="zeros"),
        "up": pdef((d, fs), ("embed", "ff")),
        "gate": pdef((d, fs), ("embed", "ff")),
        "down": pdef((fs, d), ("ff", "embed")),
    }


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, dh)
    n: torch.Tensor  # (B, H, dh)
    m: torch.Tensor  # (B, H, dh) stabilizer
    h: torch.Tensor  # (B, H, dh) previous hidden (for recurrent gates)


def init_slstm_cache(cfg, B: int, dtype, *, device=None) -> SLSTMCache:
    """Zero sLSTM cache on ``device`` (unset: the CUDA card)."""
    H, dh, _ = _sdims(cfg)
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return SLSTMCache(torch.zeros((B, H, dh), **f32),
                      torch.zeros((B, H, dh), **f32),
                      torch.full((B, H, dh), -1e30, **f32),
                      torch.zeros((B, H, dh), **f32))


def _recurrent(p):
    """The four gates' recurrent weights side by side, (H, dh, 4 dh) in
    float32 (the hidden state's dtype, as the reference's promotion):
    one product a step, each output the same dot product as the gate's
    own."""
    return torch.cat([p[f"r{g}"] for g in "zifo"], dim=-1).float()


def _slstm_cell(p, R, xz, xi, xf, xo, state: SLSTMCache) -> SLSTMCache:
    """One recurrence step; x*: (B, H, dh) precomputed input projections,
    R: ``_recurrent(p)``."""
    rz, ri, rf, ro = torch.chunk(
        torch.einsum("bhd,hde->bhe", state.h, R), 4, dim=-1)
    z = torch.tanh(xz + rz + p["bz"])
    li = xi + ri + p["bi"]
    lf = F.logsigmoid(xf + rf + p["bf"])
    o = torch.sigmoid(xo + ro + p["bo"])
    m_new = torch.maximum(lf + state.m, li)
    fw = torch.exp(lf + state.m - m_new)
    iw = torch.exp(li - m_new)
    c = fw * state.c + iw * z
    n = torch.maximum(fw * state.n + iw, torch.exp(-m_new))
    h_new = o * c / n
    return SLSTMCache(c, n, m_new, h_new)


def _slstm_inputs(p, x):
    """x: (B, S, d) -> per-gate projections, each (B, S, H, dh) f32."""
    proj = lambda g: torch.einsum("bsd,dhe->bshe", x, p[f"w{g}"]).float()
    return proj("z"), proj("i"), proj("f"), proj("o")


def _slstm_post(p, h, x, cfg):
    """GroupNorm + gated post-up-projection; h: (B, S, d)-shaped hidden."""
    h = rmsnorm(h.float(), p["gn"]).to(x.dtype)
    u = F.silu(torch.matmul(h, p["gate"])) * torch.matmul(h, p["up"])
    return torch.matmul(u, p["down"])


# tokens a block of the sLSTM loop holds (one CUDA graph replay on a card):
# in xlstm-350m's captured prefill of 2 x 1024 tokens on an H100
# (chip_smoke.py's serve phase) 64 ran fastest of 16 / 32 / 64 / 128, by
# 0.2-2 % (the replays are device-bound), with half 128's graph
_SLSTM_BLOCK = 64


def _slstm_block(consts, xs, state):
    """c steps of the recurrence: ``consts`` (``_recurrent(p)``, then the
    biases bz, bi, bf, bo), ``xs`` the block's four gate inputs, each (B,
    c, H, dh), ``state`` an ``SLSTMCache``'s leaves -> ((the c hidden
    states (B, c, H, dh),), the state after them)."""
    R, *biases = consts
    p = dict(zip(("bz", "bi", "bf", "bo"), biases))
    xz, xi, xf, xo = xs
    state = SLSTMCache(*state)
    hs = []
    for t in range(xz.shape[1]):
        state = _slstm_cell(p, R, xz[:, t], xi[:, t], xf[:, t], xo[:, t],
                            state)
        hs.append(state.h)
    return (torch.stack(hs, dim=1),), tuple(state)


def _slstm_loop(p, R, xz, xi, xf, xo, state: SLSTMCache):
    """The recurrence over every position of the (B, S, H, dh) gate
    inputs -> (the hidden states (B, S, H, dh), the last state), as blocks
    of ``_SLSTM_BLOCK`` tokens (``graphs.scan``: one replay a block on a
    card).  ``launch.roofline`` counts the loop as one token's step times
    the trip count (``graphs.counting``), as the reference's HLO analysis
    does its scan."""
    hs, state = graphs.scan(
        "slstm", _slstm_block, (R, p["bz"], p["bi"], p["bf"], p["bo"]),
        (xz, xi, xf, xo), tuple(state), length=xz.shape[1],
        c=_SLSTM_BLOCK, static=(), per_position=True)
    return torch.cat([h for (h,) in hs], dim=1), SLSTMCache(*state)


def slstm_apply(p, x, cfg, return_cache: bool = False):
    """Full-sequence sLSTM: the token loop as blocks of ``_SLSTM_BLOCK``
    steps (``_slstm_loop``). x: (B, S, d)."""
    B, S, d = x.shape
    xz, xi, xf, xo = _slstm_inputs(p, x)
    R = _recurrent(p)
    state = init_slstm_cache(cfg, B, x.dtype, device=x.device)
    hs, state = _slstm_loop(p, R, xz, xi, xf, xo, state)
    h = hs.reshape(B, S, d)
    out = _slstm_post(p, h, x, cfg)
    if return_cache:
        return out, state
    return out


def slstm_decode(p, x, cache: SLSTMCache, cfg):
    B = x.shape[0]
    xz, xi, xf, xo = _slstm_inputs(p, x)
    state = _slstm_cell(p, _recurrent(p), xz[:, 0], xi[:, 0], xf[:, 0],
                        xo[:, 0], cache)
    h = state.h.reshape(B, 1, -1)
    return _slstm_post(p, h, x, cfg), state
