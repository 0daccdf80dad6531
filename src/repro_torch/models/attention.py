"""GQA attention with chunked online-softmax, sliding windows, soft-capping,
ring-buffer KV caches and cross-attention (port of
``repro.models.attention``).

Plain PyTorch, as the reference's is plain XLA outside any Pallas kernel;
no fused library attention, which would keep neither the soft-cap nor the
float32 score order.  KV is processed in chunks of ``cfg.attn_chunk`` with
a running (max, denom, acc) carry — the flash-attention recurrence —
whenever the KV length is a multiple of the chunk above one chunk (decode
over a long cache included); shorter or ragged lengths take the direct
softmax.  The chunk loop is the reference's ``lax.scan``: a chunk a block
of ``repro_torch.graphs.scan`` (on a card one CUDA graph a chunk shape
and mask, replayed; inside the decoder's captured step, recorded inline).
Scores and the softmax run in float32 whatever the activations' dtype
(the reference's ``preferred_element_type``).

Decode takes its position as a Python int or as a 0-d integer tensor on
the model's device (the reference's traced scalar): every value that
depends on it (the rotary angles, the ring slot, the slots' positions) is
computed on the device from it, and the new key and value are written at
the slot by ``index_copy_``, so nothing is read back to the host and a
captured step reads its position from a device buffer.

On a ``model`` axis (``sharding.tp``) a layer whose ``wq`` holds fewer
heads than ``cfg.n_heads`` runs on the rank's query heads (``local_kv``)
and returns its partial output projection, which the caller sums over the
model group; the mask, the KV chunk loop and ``decode_attend`` run
unchanged on the local heads.

On a data axis (``tp.data_axis``, which the serve steps enter where the
data axes do not take the batch) a cache whose sequence
``sharding.seq_on_data`` puts on the data axes is held as the rank's
slots (``seq_shard``): context-parallel decode.  ``decode_attend`` then
writes the new key only on the rank that owns its slot and attends over
the rank's slots, and ``merged_attention`` merges the ranks' partial
softmaxes (``partial_attention``) over the data group.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch import graphs
from repro_torch.device import resolve_device
from repro_torch.sharding import seq_on_data, tp

from .common import pdef, softcap

__all__ = ["attn_defs", "qkv_proj", "out_proj", "kv_heads", "local_kv",
           "local_cache", "attention", "partial_attention",
           "merged_attention", "seq_shard", "own_slots", "init_kv_cache",
           "ring_slot_positions", "decode_attend", "AttnCache"]

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def attn_defs(cfg, cross: bool = False):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    pre = "c" if cross else ""
    return {
        pre + "wq": pdef((d, H, hd), ("embed", "heads", "head_dim"), fan_in=d),
        pre + "wk": pdef((d, K, hd), ("embed", "kv", "head_dim"), fan_in=d),
        pre + "wv": pdef((d, K, hd), ("embed", "kv", "head_dim"), fan_in=d),
        pre + "wo": pdef((H, hd, d), ("heads", "head_dim", "embed"),
                         fan_in=H * hd),
    }


def qkv_proj(p, x, pre: str = ""):
    """x: (B, S, d) -> q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p[pre + "wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p[pre + "wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p[pre + "wv"])
    return q, k, v


def out_proj(p, o, pre: str = ""):
    return torch.einsum("bshk,hkd->bsd", o, p[pre + "wo"])


def kv_heads(p, cfg, pre: str = ""):
    """The kv heads ``(k0, k1)`` that the rank's query heads read where
    ``p``'s query heads are the rank's model shard and its kv heads whole
    (a ``cfg.n_kv`` that the model axis does not divide, so the kv weights
    fall back to replication); else ``None``."""
    hl, K = p[pre + "wq"].shape[1], p[pre + "wk"].shape[1]
    if hl == cfg.n_heads or K < cfg.n_kv:
        return None
    G = cfg.n_heads // cfg.n_kv
    h0 = tp.rank() * hl
    k0, k1 = h0 // G, (h0 + hl - 1) // G + 1
    if k1 - k0 > 1 and hl % G:
        raise ValueError(f"{hl} query heads a rank straddle groups of {G} "
                         f"kv heads ({cfg.n_heads} heads, {cfg.n_kv} kv)")
    return k0, k1


def local_kv(p, cfg, pre: str = ""):
    """(``p``, ``kv_heads(p, cfg, pre)``), ``p``'s kv projections cut to
    those heads where there are some, after ``tp.copy_to``: each rank's
    gradient of the whole kv weights covers its heads only."""
    kv = kv_heads(p, cfg, pre)
    if kv is None:
        return p, None
    cut = lambda w: tp.copy_to(w)[:, kv[0]:kv[1]]  # noqa: E731
    return {**p, pre + "wk": cut(p[pre + "wk"]),
            pre + "wv": cut(p[pre + "wv"])}, kv


def local_cache(cache, kv, cfg):
    """``cache`` cut to the kv heads ``kv`` (``kv_heads``) where it holds
    every kv head (a cache placed replicated on ``model``); a view, so the
    rank writes and reads its heads in place."""
    if kv is None or cache.k.shape[2] != cfg.n_kv:
        return cache
    return AttnCache(cache.k[:, :, kv[0]:kv[1]], cache.v[:, :, kv[0]:kv[1]])


def _mask(qpos, kpos, kvalid, causal: bool, window: Optional[int]):
    """(Sq, Skv) boolean mask from integer positions."""
    m = kvalid[None, :].expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _scores(q, k, scale, cap):
    """q: (B,K,G,Sq,hd), k: (B,C,K,hd) -> (B,K,G,Sq,C) float32."""
    s = torch.einsum("bkgsh,bckh->bkgsc", q.float(), k.float()) * scale
    return softcap(s, cap)


def attention(q, k, v, *, causal: bool, window: Optional[int],
              cap: Optional[float], qpos, kpos, kvalid,
              chunk: int = 1024, banded: bool = False) -> torch.Tensor:
    """Online-softmax GQA attention.

    q: (B, Sq, H, hd);  k, v: (B, Skv, K, hd);  qpos: (Sq,) int;
    kpos, kvalid: (Skv,).  Returns (B, Sq, H, hd) in q.dtype.
    """
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qh = q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)  # (B,K,G,Sq,hd)

    if Skv <= chunk or Skv % chunk:
        s = _scores(qh, k, scale, cap)
        m = _mask(qpos, kpos, kvalid, causal, window)
        s = torch.where(m[None, None, None], s, _NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgsc,bckh->bkgsh", p, v.float())
        return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)

    if (banded and window is not None and causal and Sq == Skv
            and Skv >= 4 * window and window % chunk == 0):
        return _banded_attention(qh, k, v, window=window, cap=cap,
                                 scale=scale, chunk=chunk, qpos=qpos,
                                 out_dtype=q.dtype)

    _, l_run, acc = _chunk_loop(qh, k, v, causal=causal, window=window,
                                cap=cap, scale=scale, qpos=qpos, kpos=kpos,
                                kvalid=kvalid, chunk=chunk)
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _empty_carry(qh):
    """The online softmax's state before any key: (max, denominator,
    accumulator) of grouped queries ``qh`` (B, K, G, Sq, hd)."""
    B, K, G, Sq, hd = qh.shape
    return (torch.full((B, K, G, Sq), _NEG, dtype=torch.float32,
                       device=qh.device),
            torch.zeros((B, K, G, Sq), dtype=torch.float32, device=qh.device),
            torch.zeros((B, K, G, Sq, hd), dtype=torch.float32,
                        device=qh.device))


def _chunk_loop(qh, k, v, *, causal, window, cap, scale, qpos, kpos, kvalid,
                chunk):
    """The KV chunk loop (``graphs.scan``, a chunk a block) over grouped
    queries ``qh`` -> the online softmax's (max, denominator,
    accumulator)."""
    # the queries in float32 once (the scores' cast), contiguous as a
    # graph's static buffer holds them; key positions and validity with a
    # leading axis, as scan slices dim 1
    _, carry = graphs.scan(
        "attention", functools.partial(_kv_chunk, causal=causal,
                                       window=window, cap=cap, scale=scale),
        (qh.float().contiguous(), qpos), (k, v, kpos[None], kvalid[None]),
        _empty_carry(qh), length=k.shape[1], c=chunk,
        static=(causal, window, cap, scale))
    return carry


def partial_attention(q, k, v, *, causal: bool, window: Optional[int],
                      cap: Optional[float], qpos, kpos, kvalid,
                      chunk: int = 1024):
    """The online softmax's unnormalised state over these keys: (max
    (B, K, G, Sq), denominator (B, K, G, Sq), accumulator (B, K, G, Sq,
    hd)), float32, the kv head groups' queries ``G = H // K`` apart.
    ``attention`` is the accumulator over the denominator.  The routes
    are ``attention``'s but the banded one: the KV chunk loop where the
    key length is a multiple of ``chunk`` above one chunk, else one chunk
    of the whole length (``_kv_chunk`` from the empty state), where
    masked entries are zeroed explicitly: keys that are all masked give
    (the floor, 0, 0), not uniform weights over them."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qh = q.reshape(B, Sq, K, H // K, hd).permute(0, 2, 3, 1, 4)
    kw = dict(causal=causal, window=window, cap=cap, scale=hd ** -0.5)
    if Skv <= chunk or Skv % chunk:
        _, carry = _kv_chunk((qh.float(), qpos),
                             (k, v, kpos[None], kvalid[None]),
                             _empty_carry(qh), **kw)
        return carry
    return _chunk_loop(qh, k, v, qpos=qpos, kpos=kpos, kvalid=kvalid,
                       chunk=chunk, **kw)


def merged_attention(q, k, v, **kw) -> torch.Tensor:
    """``attention`` over keys whose sequence the current data axis splits
    (``tp.data_axis``; ``k``, ``v``, ``kpos`` and ``kvalid`` the rank's
    shard of them): each rank's ``partial_attention``, merged over the
    data group.  The max by an all-reduce max; each rank's denominator and
    accumulator rescaled to it and summed by one all-reduce; one division.
    (B, Sq, H, hd) in q.dtype, the same on every rank of the group.  It
    equals the one-rank ``attention`` over the whole keys to float32
    rounding, not bit for bit: the terms sum in another order, and a
    shard's length may take the direct route where the whole length took
    the chunk loop."""
    B, Sq, H, hd = q.shape
    m, den, acc = partial_attention(q, k, v, **kw)
    r = torch.exp(m - tp.data_all_reduce_max(m))
    both = tp.data_all_reduce_sum(torch.cat([(den * r)[..., None],
                                             acc * r[..., None]], dim=-1))
    o = both[..., 1:] / torch.clamp(both[..., :1], min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def _kv_chunk(consts, xs, carry, *, causal, window, cap, scale):
    """One KV chunk of the online softmax: ``consts`` the grouped queries
    (B, K, G, Sq, hd) float32 and their positions (Sq,), ``xs`` the chunk's
    keys and values (B, C, K, hd) and its key positions and validity (1, C),
    ``carry`` the running (max, denominator, accumulator) -> ((), carry)."""
    qh, qpos = consts
    kb, vb, kp, kv_ok = xs
    m_run, l_run, acc = carry
    s = _scores(qh, kb, scale, cap)                        # (B,K,G,Sq,C)
    msk = _mask(qpos, kp[0], kv_ok[0], causal, window)
    s = torch.where(msk[None, None, None], s, _NEG)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    r = torch.exp(m_run - m_new)
    # Explicitly zero masked entries: when a whole chunk is masked,
    # s - m_new == 0 would otherwise give weight exp(0) = 1.
    p = torch.exp(s - m_new[..., None]) * msk[None, None, None]
    l_run = l_run * r + p.sum(dim=-1)
    acc = acc * r[..., None] + torch.einsum("bkgsc,bckh->bkgsh", p,
                                            vb.float())
    return (), (m_new, l_run, acc)


def _banded_attention(qh, k, v, *, window, cap, scale, chunk, qpos,
                      out_dtype):
    """Sliding-window self-attention without the O(S^2) masked waste.

    q blocks of size ``chunk`` only visit the ``window/chunk + 1`` KV blocks
    that can fall inside the window — compute drops from S*S to
    S*(window+chunk).

    qh: (B, K, G, S, hd) grouped queries; k, v: (B, S, K, hd).
    """
    B, K, G, S, hd = qh.shape
    dev = qh.device
    nq = S // chunk
    nb = window // chunk + 1                     # KV blocks per q block
    qb = qh.reshape(B, K, G, nq, chunk, hd)
    kb = k.reshape(B, nq, chunk, K, hd)
    vb = v.reshape(B, nq, chunk, K, hd)
    # for q block i, kv blocks i-nb+1 .. i (clamped; out-of-range masked)
    offs = (torch.arange(nq, device=dev)[:, None]
            - torch.arange(nb - 1, -1, -1, device=dev)[None, :])
    valid_blk = offs >= 0
    gather = offs.clamp(0, nq - 1)                       # (nq, nb)
    kg = kb[:, gather]                                   # (B, nq, nb, C, K, hd)
    vg = vb[:, gather]
    s = torch.einsum("bkgiqh,binckh->bkgiqnc", qb.float(),
                     kg.float()) * scale
    s = softcap(s, cap)                                  # (B,K,G,nq,Cq,nb,Ckv)
    qp = qpos.reshape(nq, chunk)[:, :, None, None]       # (nq, Cq, 1, 1)
    kp = (gather[:, :, None] * chunk
          + torch.arange(chunk, device=dev)[None, None, :])  # (nq, nb, Ckv)
    kp = kp[:, None, :, :]                               # (nq, 1, nb, Ckv)
    msk = ((kp <= qp) & (kp > qp - window)
           & valid_blk[:, None, :, None])                # (nq, Cq, nb, Ckv)
    s = torch.where(msk[None, None, None], s, _NEG)
    sh = s.shape
    p = torch.softmax(s.reshape(sh[:-2] + (nb * chunk,)),
                      dim=-1).reshape(sh)
    o = torch.einsum("bkgiqnc,binckh->bkgiqh", p, vg.float())
    o = o.reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4)
    return o.reshape(B, S, K * G, hd).to(out_dtype)


class AttnCache(NamedTuple):
    """KV cache for one attention layer (ring buffer when windowed)."""
    k: torch.Tensor   # (B, C, K, hd)
    v: torch.Tensor   # (B, C, K, hd)


def init_kv_cache(B: int, cache_len: int, K: int, hd: int, dtype, *,
                  device=None) -> AttnCache:
    """Zero KV cache on ``device`` (unset: the CUDA card)."""
    device = resolve_device(device)
    return AttnCache(
        torch.zeros((B, cache_len, K, hd), dtype=dtype, device=device),
        torch.zeros((B, cache_len, K, hd), dtype=dtype, device=device))


def ring_slot_positions(cache_len: int, index, *, device=None, lo: int = 0,
                        hi: Optional[int] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions and validity of ring-buffer slots given current length.

    Slot s holds the largest position p < index with p = s (mod cache_len);
    valid iff p >= 0.  For a non-ring (full) cache this reduces to
    pos = s, valid = s < index.  ``index`` is a Python int, and the tensors
    lie on ``device`` (unset: the CUDA card), or an integer tensor of one
    element, and they lie on its device.  ``lo``, ``hi``: slots [lo, hi)
    only (a rank's sequence shard; unset: every slot).
    """
    dev = index.device if isinstance(index, torch.Tensor) else \
        resolve_device(device)
    s = torch.arange(lo, cache_len if hi is None else hi, dtype=torch.int32,
                     device=dev)
    # floor modulo (``%`` on a tensor): idx - 1 - s is negative for most
    # slots, where fmod would keep the sign
    p = index - 1 - torch.remainder(index - 1 - s, cache_len)
    return p, p >= 0


def position(index, device) -> torch.Tensor:
    """The decode position as a (1,) int32 tensor: a Python int's on
    ``device``, or a view of a one-element integer tensor (nothing is read
    back to the host)."""
    if isinstance(index, torch.Tensor):
        return index.reshape(1).to(torch.int32)
    index = int(index)
    return torch.arange(index, index + 1, dtype=torch.int32, device=device)


def seq_shard(B: int, C: int, held: Optional[int] = None):
    """(ranks n, rank r) of the current data axis where a cache of ``C``
    slots (its global length) at a batch of ``B`` holds its sequence there
    (``sharding.seq_on_data``): rank r holds slots [r C / n, (r + 1) C /
    n).  ``None``: the cache is whole.  ``held``: the slots the rank
    holds, which must be its share."""
    mesh = tp.data_mesh()
    out = None
    if mesh is not None and seq_on_data(B, C, mesh):
        out = tp.data_size(), tp.data_rank()
    want = C // out[0] if out else C
    if held is not None and held != want:
        raise ValueError(f"a cache of {C} slots at batch {B} held as {held}"
                         f" slots on this rank, not its {want}")
    return out


def own_slots(cache: AttnCache) -> AttnCache:
    """``cache`` (whole, its sequence dim 1) cut to the rank's slots where
    ``seq_shard`` splits it, in storage of its own; else as it is."""
    B, C = cache.k.shape[:2]
    shard = seq_shard(B, C)
    if shard is None:
        return cache
    n, r = shard
    return AttnCache(*(t[:, r * C // n:(r + 1) * C // n].contiguous()
                       for t in cache))


def decode_attend(p, x, cache: AttnCache, index, *, cfg, window, cap,
                  rope_fn, pre: str = "", cache_len: Optional[int] = None
                  ) -> tuple[torch.Tensor, AttnCache]:
    """Single-token decode: write (k, v) at slot index % C, attend over cache.

    x: (B, 1, d); index: the current position, a Python int or a
    one-element integer tensor on x's device (``position``).
    rope_fn(q_or_k, pos) applies rotary for this arch (identity for
    non-rope archs).  The new key and value are written INTO ``cache`` (no
    cache is copied per token); the returned ``AttnCache`` holds the same
    tensors.  On a model shard of the heads (``local_kv``) the output is
    the rank's partial projection and the cache holds the rank's kv heads,
    or every kv head where they fall back to replication (the rank writes
    and reads its own).

    ``cache_len``: the cache's global length C, whose slots the rank
    holds whole or, where ``seq_shard`` splits them over the data axis,
    its share (checked); unset: ``cache``'s own length, whole.  On a
    shard, slot ``index % C`` is written only by the rank that owns it (a
    masked ``index_copy_`` of the clamped local slot: no position is read
    back to the host, so the step stays capturable), the keys' positions
    are the rank's window of ``ring_slot_positions(C, index + 1)``, and the
    softmax is merged over the data group (``merged_attention``).
    """
    p, kv = local_kv(p, cfg, pre)
    q, k_new, v_new = qkv_proj(p, x, pre)
    pos = position(index, x.device)
    q = rope_fn(q, pos)
    k_new = rope_fn(k_new, pos)
    ck, cv = local_cache(cache, kv, cfg)
    shard = None if cache_len is None else seq_shard(x.shape[0], cache_len,
                                                     held=ck.shape[1])
    kw = dict(causal=True, window=window, cap=cap, qpos=pos,
              chunk=cfg.attn_chunk)
    if shard is None:
        C = ck.shape[1]
        slot = torch.remainder(pos, C).long()
        ck.index_copy_(1, slot, k_new.to(ck.dtype))
        cv.index_copy_(1, slot, v_new.to(cv.dtype))
        kpos, kvalid = ring_slot_positions(C, pos + 1)
        o = attention(q, ck, cv, kpos=kpos, kvalid=kvalid, **kw)
        return out_proj(p, o, pre), cache
    n, r = shard
    Cl = cache_len // n
    lo = r * Cl
    slot = torch.remainder(pos, cache_len).long()
    own = (slot >= lo) & (slot < lo + Cl)
    at = torch.clamp(slot - lo, 0, Cl - 1)
    for c, new in ((ck, k_new), (cv, v_new)):
        c.index_copy_(1, at, torch.where(own, new.to(c.dtype),
                                         c.index_select(1, at)))
    kpos, kvalid = ring_slot_positions(cache_len, pos + 1, lo=lo,
                                       hi=lo + Cl)
    o = merged_attention(q, ck, cv, kpos=kpos, kvalid=kvalid, **kw)
    return out_proj(p, o, pre), cache
