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

On a ``model`` axis (``sharding.tp``) the layers follow the reference's
placement, ``d_inner`` and ``heads`` on ``model``:

* the mLSTM, where its ``dp`` channels are split (``gn`` narrower than
  ``dp``): ``up`` is split like Mamba's ``in_proj`` and exchanged into the
  rank's (x, z) channel pair (``tp.exchange_halves``); ``wq/wk/wv`` and
  ``wi/wf`` are split on ``dp`` (``d_inner`` takes ``model`` before
  ``heads``), so the rank's q, k, v and gates are partial sums over its
  channels, reduce-scattered to its H/n heads (``tp.reduce_scatter``)
  where n divides H, else all-reduced whole (the recurrence then runs
  whole on every rank and its output enters the rank's channels through
  ``tp.copy_to``); the rank's heads, flattened, are its ``dp`` channels,
  so its ``gn`` and ``down`` rows; the norm's sum of squares is the
  group's, and ``down`` is row-parallel;
* the sLSTM, where its heads are split (``wz`` holding fewer than H): the
  gates' input projections column-parallel over heads, the recurrent
  weights and biases the rank's, so the token loop runs on H/n heads with
  no collective inside it; the hidden states are all-gathered whole
  (``tp.gather_from``) for the replicated ``gn`` and the post-projection,
  whose ``up`` / ``gate`` are column-parallel and ``down`` row-parallel
  over ``ff`` where ``ff`` is split.

The caches hold the rank's heads.  Given whole leaves every function is
the one-device program.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.device import resolve_device
from repro_torch.sharding import tp

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
    return _mlstm_zeros(B, H, dk, resolve_device(device))


def _mlstm_zeros(B: int, H: int, dk: int, device) -> MLSTMCache:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(torch.zeros((B, H, dk, dk), **f32),
                      torch.zeros((B, H, dk), **f32),
                      torch.full((B, H), -1e30, **f32))


def _mlstm_sharded(p, cfg) -> bool:
    """The layer's ``dp`` channels are the rank's model shard."""
    return p["gn"].shape[0] < _mdims(cfg)[0]


def _mlstm_qkvg(p, x, cfg):
    """x: (B, S, d) -> q,k,v (B,S,H,dk) f32, li/lf (B,S,H) f32, z (B,S,dp);
    on a model shard of the channels z the rank's (B,S,dp/n) and the
    heads the rank's where n divides H (``_mlstm_qkvg_tp``)."""
    if _mlstm_sharded(p, cfg):
        return _mlstm_qkvg_tp(p, x, cfg)
    xz = torch.matmul(x, p["up"])
    xm, z = torch.chunk(xz, 2, dim=-1)
    q = torch.einsum("bse,ehk->bshk", xm, p["wq"]).float()
    k = torch.einsum("bse,ehk->bshk", xm, p["wk"]).float()
    k = k / math.sqrt(k.shape[-1])
    v = torch.einsum("bse,ehk->bshk", xm, p["wv"]).float()
    li = (torch.matmul(xm, p["wi"]) + p["bi"]).float()     # log input gate
    lf = F.logsigmoid((torch.matmul(xm, p["wf"]) + p["bf"]).float())
    return q, k, v, li, lf, z


def _mlstm_qkvg_tp(p, x, cfg):
    """``_mlstm_qkvg`` on the rank's channels: each projection's partial
    sum over them (float32) reduce-scattered to the rank's heads, or
    all-reduced whole where the axis does not divide the heads."""
    _, H, _ = _mdims(cfg)
    xm, z = torch.chunk(tp.exchange_halves(
        torch.matmul(tp.copy_to(x), p["up"])), 2, dim=-1)
    if H % tp.size() == 0:
        whole = lambda t: tp.reduce_scatter(t, 2)  # noqa: E731
        heads = slice(tp.rank() * H // tp.size(),
                      (tp.rank() + 1) * H // tp.size())
        # the biases used on the rank's heads: their gradient summed
        bias = lambda b: tp.copy_to(b)[heads]  # noqa: E731
    else:
        whole, bias = tp.reduce_from, (lambda b: b)
    proj = lambda w: whole(  # noqa: E731
        torch.einsum("bse,ehk->bshk", xm, w).float())
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    k = k / math.sqrt(k.shape[-1])
    li = whole(torch.matmul(xm, p["wi"]).float()) + bias(p["bi"]).float()
    lf = F.logsigmoid(whole(torch.matmul(xm, p["wf"]).float())
                      + bias(p["bf"]).float())
    return q, k, v, li, lf, z


def _mlstm_out(p, h, z, x, cfg):
    """The gated output of the recurrence's hidden states h (B, S, H', dk)
    float32: norm, gate, ``down``.  On a model shard of the channels, h
    the rank's heads (its channels) or every head (cut to the rank's
    channels here, through ``tp.copy_to``), the norm over the group's
    channels and ``down`` row-parallel."""
    B, S = h.shape[:2]
    h = h.reshape(B, S, -1)
    if not _mlstm_sharded(p, cfg):
        h = rmsnorm(h, p["gn"]) * F.silu(z)                  # per-channel
        return torch.matmul(h.to(x.dtype), p["down"])
    dp, c = _mdims(cfg)[0], p["gn"].shape[0]
    if h.shape[-1] > c:          # every head: the rank's channels of them
        h = tp.copy_to(h)[..., tp.rank() * c:(tp.rank() + 1) * c]
    h = _rmsnorm_tp(h, p["gn"], dp) * F.silu(z)
    return tp.reduce_from(torch.matmul(h.to(x.dtype), p["down"]))


def _rmsnorm_tp(x, scale, width: int, eps: float = 1e-6):
    """``common.rmsnorm`` over a ``width``-channel dim of which ``x`` holds
    the rank's channels: the group's sum of squares, used alike on every
    rank (its gradient summed)."""
    dt = x.dtype
    x = x.float()
    ss = tp.copy_to(tp.reduce_from((x * x).sum(dim=-1, keepdim=True)))
    x = x * torch.rsqrt(ss / width + eps)
    return (x * (1.0 + scale.float())).to(dt)


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
    q, k, v, li, lf, z = _mlstm_qkvg(p, x, cfg)

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
        tuple(_mlstm_zeros(B, *q.shape[2:], x.device)),
        length=Sp, c=Q, static=())
    h = torch.cat([h for (h,) in hs], dim=1)[:, :S]
    out = _mlstm_out(p, h, z[:, :S], x, cfg)
    if return_cache:
        return out, MLSTMCache(C, n, m)
    return out


def mlstm_decode(p, x, cache: MLSTMCache, cfg):
    """Single-step mLSTM. x: (B, 1, d); on a model shard the cache holds
    the rank's heads (every head where the axis does not divide them)."""
    q, k, v, li, lf, z = _mlstm_qkvg(p, x, cfg)
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
    return _mlstm_out(p, h[:, None], z, x, cfg), MLSTMCache(C, n, m_new)


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
    return _slstm_zeros(B, H, dh, resolve_device(device))


def _slstm_zeros(B: int, H: int, dh: int, device) -> SLSTMCache:
    f32 = dict(dtype=torch.float32, device=device)
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


def _slstm_sharded(p, cfg) -> bool:
    """The layer's heads are the rank's model shard."""
    return p["wz"].shape[1] < cfg.n_heads


def _slstm_inputs(p, x, cfg):
    """x: (B, S, d) -> per-gate projections, each (B, S, H, dh) f32 (the
    rank's heads on a model shard of them: column-parallel)."""
    if _slstm_sharded(p, cfg):
        x = tp.copy_to(x)
    proj = lambda g: torch.einsum("bsd,dhe->bshe", x, p[f"w{g}"]).float()
    return proj("z"), proj("i"), proj("f"), proj("o")


def _slstm_hidden(p, h, cfg):
    """The hidden states (B, S, H', dh) -> (B, S, d): the rank's heads
    all-gathered whole on a model shard of them."""
    if _slstm_sharded(p, cfg):
        h = tp.gather_from(h, 2)
    return h.reshape(*h.shape[:2], -1)


def _slstm_post(p, h, x, cfg):
    """GroupNorm + gated post-up-projection; h: (B, S, d)-shaped hidden
    (whole; ``up`` / ``gate`` column-parallel and ``down`` row-parallel on
    a model shard of ``ff``)."""
    h = rmsnorm(h.float(), p["gn"]).to(x.dtype)
    sharded = p["up"].shape[1] < _sdims(cfg)[2]
    if sharded:
        h = tp.copy_to(h)
    u = F.silu(torch.matmul(h, p["gate"])) * torch.matmul(h, p["up"])
    out = torch.matmul(u, p["down"])
    return tp.reduce_from(out) if sharded else out


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
    steps (``_slstm_loop``; on the rank's heads on a model shard of them,
    with no collective inside). x: (B, S, d)."""
    xz, xi, xf, xo = _slstm_inputs(p, x, cfg)
    state = _slstm_zeros(*xz.shape[:1], *xz.shape[2:], x.device)
    hs, state = _slstm_loop(p, _recurrent(p), xz, xi, xf, xo, state)
    out = _slstm_post(p, _slstm_hidden(p, hs, cfg), x, cfg)
    if return_cache:
        return out, state
    return out


def slstm_decode(p, x, cache: SLSTMCache, cfg):
    """Single-step sLSTM. x: (B, 1, d); on a model shard of the heads the
    cache holds the rank's."""
    xz, xi, xf, xo = _slstm_inputs(p, x, cfg)
    state = _slstm_cell(p, _recurrent(p), xz[:, 0], xi[:, 0], xf[:, 0],
                        xo[:, 0], cache)
    h = _slstm_hidden(p, state.h[:, None], cfg)
    return _slstm_post(p, h, x, cfg), state
