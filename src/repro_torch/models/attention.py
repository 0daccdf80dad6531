"""GQA attention with chunked online-softmax, sliding windows and
soft-capping (port of ``repro.models.attention``'s full-sequence path).

Plain PyTorch, as the reference's is plain XLA outside any Pallas kernel.
KV is processed in chunks of ``cfg.attn_chunk`` with a running (max, denom,
acc) carry — the flash-attention recurrence — whenever the KV length is a
multiple of the chunk above one chunk; shorter or ragged lengths take the
direct softmax.  Scores and the softmax run in float32 whatever the
activations' dtype (the reference's ``preferred_element_type``).  The
banded sliding-window path, the KV caches and ``decode_attend`` belong to
the serve path, which the port does not have yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import pdef, softcap

__all__ = ["attn_defs", "qkv_proj", "out_proj", "attention"]

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
              chunk: int = 1024) -> torch.Tensor:
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

    m_run = torch.full((B, K, G, Sq), _NEG, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, Skv, chunk):
        kb, vb = k[:, lo:lo + chunk], v[:, lo:lo + chunk]
        s = _scores(qh, kb, scale, cap)                    # (B,K,G,Sq,C)
        msk = _mask(qpos, kpos[lo:lo + chunk], kvalid[lo:lo + chunk],
                    causal, window)
        s = torch.where(msk[None, None, None], s, _NEG)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        r = torch.exp(m_run - m_new)
        # Explicitly zero masked entries: when a whole chunk is masked,
        # s - m_new == 0 would otherwise give weight exp(0) = 1.
        p = torch.exp(s - m_new[..., None]) * msk[None, None, None]
        l_run = l_run * r + p.sum(dim=-1)
        acc = acc * r[..., None] + torch.einsum("bkgsc,bckh->bkgsh", p,
                                                vb.float())
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
