"""Model driver: the full-sequence decoder of the model zoo (port of
``repro.models.transformer``'s train path).

  * parameters: descriptor trees (models.common) — one period of blocks,
    stacked over ``n_periods`` in the reference's layout, so a parameter
    tree converts one array at a time (``models.convert``); ``forward``
    walks the periods with a Python loop where the reference scans;
  * logits are tied to the token embedding and computed in float32.

What runs: ``attn`` blocks with a dense MLP — rmsnorm or layernorm, silu
or gelu, GQA, sliding windows, attention and final soft-capping,
``post_block_norm`` and the gemma embedding scale.  ``remat_policy`` only
trades memory for recomputation in the reference and changes no value: the
port ignores it and keeps every activation.  MoE, mamba, mLSTM/sLSTM
blocks, the encoder and patch inputs, and ``prefill`` / ``decode_step`` /
``init_caches`` wait for the rest of the model zoo (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, BlockSpec

from . import attention as attn
from .common import (Dtype, layernorm, pdef, rmsnorm, softcap, stack_defs,
                     tree_axes, tree_init)
from .mlp import mlp_apply, mlp_defs
from .rope import apply_rope, rope_angles

__all__ = ["param_defs", "init_params", "param_axes", "forward", "lm_loss",
           "count_params"]

_LATER = "ROADMAP Queue 1 item 5"


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({_LATER}); the "
                               f"port runs attention blocks with a dense MLP")


# ------------------------------------------------------------ param defs ---

def _norm_defs(cfg, name):
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {name: pdef((d,), ("embed",), init="zeros")}
    return {name: pdef((d,), ("embed",), init="zeros"),
            name + "_b": pdef((d,), ("embed",), init="zeros")}


def _apply_norm(cfg, p, name, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p[name])
    return layernorm(x, p[name], p[name + "_b"])


def _check_block(spec: BlockSpec) -> None:
    if spec.kind != "attn":
        raise _unported(f"the {spec.kind} block")
    if spec.moe:
        raise _unported("the MoE MLP")
    if spec.cross_attn:
        raise _unported("cross-attention (encoder-decoder)")


def _block_defs(cfg, spec: BlockSpec):
    _check_block(spec)
    d = {}
    d.update(_norm_defs(cfg, "norm1"))
    d.update(attn.attn_defs(cfg))
    if spec.mlp:
        d.update(_norm_defs(cfg, "norm2"))
        d.update(mlp_defs(cfg))
    if cfg.post_block_norm:
        d.update(_norm_defs(cfg, "postn1"))
        if spec.mlp:
            d.update(_norm_defs(cfg, "postn2"))
    return d


def param_defs(cfg: ArchConfig):
    if cfg.n_enc_layers:
        raise _unported("the encoder")
    if cfg.n_patches:
        raise _unported("the patch-embedding projector")
    defs: dict = {
        "embed": pdef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                      scale=1.0),
        "blocks": {str(i): stack_defs(_block_defs(cfg, s), cfg.n_periods)
                   for i, s in enumerate(cfg.period)},
    }
    defs.update(_norm_defs(cfg, "final_norm"))
    return defs


def init_params(cfg: ArchConfig, key, *, device=None):
    """Random parameters in ``cfg.param_dtype`` on ``device`` (unset: the
    CUDA card), the same for a seed on every device.  ``key`` is an int
    seed or a CPU ``torch.Generator`` (``common.tree_init``)."""
    return tree_init(param_defs(cfg), key, Dtype.of(cfg.param_dtype),
                     device=device)


def param_axes(cfg: ArchConfig):
    return tree_axes(param_defs(cfg))


# ----------------------------------------------------------- block apply ---

def _attn_full(bp, spec, x, cfg, rope, causal):
    """Full-sequence self-attention sublayer -> delta."""
    S = x.shape[1]
    q, k, v = attn.qkv_proj(bp, x)
    if rope is not None:
        cos, sin = rope
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    valid = torch.ones((S,), dtype=torch.bool, device=x.device)
    o = attn.attention(q, k, v, causal=causal, window=spec.window,
                       cap=cfg.attn_softcap, qpos=pos, kpos=pos, kvalid=valid,
                       chunk=cfg.attn_chunk)
    return attn.out_proj(bp, o)


def _block_full(bp, spec: BlockSpec, x, cfg, rope, *, causal=True):
    """One block, full-sequence -> x."""
    h = _apply_norm(cfg, bp, "norm1", x)
    delta = _attn_full(bp, spec, h, cfg, rope, causal)
    if cfg.post_block_norm:
        delta = _apply_norm(cfg, bp, "postn1", delta)
    x = x + delta
    if spec.mlp:
        h2 = _apply_norm(cfg, bp, "norm2", x)
        delta2 = mlp_apply(bp, h2, cfg)
        if cfg.post_block_norm:
            delta2 = _apply_norm(cfg, bp, "postn2", delta2)
        x = x + delta2
    return x


# ---------------------------------------------------------- embed/logits ---

def _embed_inputs(params, cfg: ArchConfig, tokens):
    dt = Dtype.of(cfg.dtype)
    # F.embedding's backward sums each row's gradient in a fixed order on
    # the card (sorted indices), where indexing's accumulates with atomics
    x = F.embedding(tokens.long(), params["embed"]).to(dt)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.learned_pos:
        raise _unported("additive sinusoidal positions (whisper)")
    return x


def _logits(params, cfg: ArchConfig, x):
    x = _apply_norm(cfg, params, "final_norm", x)
    # float32 products and sums, as the reference's preferred_element_type
    logits = torch.matmul(x.float(), params["embed"].float().t())
    return softcap(logits, cfg.final_softcap)


# ------------------------------------------------------------ main path ----

def forward(params, cfg: ArchConfig, tokens, *, patch_embeds=None,
            mrope_positions=None, enc_embeds=None):
    """Full-sequence forward -> (logits (B, S, V) float32, aux dict).

    ``aux`` carries the reference's router terms (zero without MoE) so the
    coded train step adds them as the reference does."""
    if patch_embeds is not None or enc_embeds is not None:
        raise _unported("patch and encoder inputs")
    if cfg.mrope_sections is not None and mrope_positions is not None:
        raise _unported("M-RoPE positions")
    x = _embed_inputs(params, cfg, tokens)
    S = x.shape[1]
    rope = None
    if not cfg.learned_pos:
        cos, sin = rope_angles(torch.arange(S, dtype=torch.int32,
                                            device=x.device),
                               cfg.hd, cfg.rope_theta)
        rope = (cos[None], sin[None])
    # unbind once: its backward stacks the periods' gradients in one copy
    periods = [{name: tree.unbind(0) for name, tree in bp.items()}
               for bp in (params["blocks"][str(i)]
                          for i in range(len(cfg.period)))]
    for spec in cfg.period:
        _check_block(spec)
    for t in range(cfg.n_periods):
        for i, spec in enumerate(cfg.period):
            bp = {name: leaves[t] for name, leaves in periods[i].items()}
            x = _block_full(bp, spec, x, cfg, rope)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, cfg, x), {"load_balance": zero, "router_z": zero}


# ---------------------------------------------------------- param counts ---

def count_params(cfg: ArchConfig, active_only: bool = False) -> float:
    """Total (or MoE-active) parameter count from the descriptor tree.

    active_only scales expert weights by top_k / n_experts — the N used in
    MODEL_FLOPS = 6 N D for MoE.
    """
    total = 0.0

    def walk(d):
        nonlocal total
        for k, v in d.items():
            if k == "__pdef__":
                continue
            if isinstance(v, dict) and v.get("__pdef__") is True:
                n = float(math.prod(v["shape"]))
                if active_only and k.startswith("moe_w") and cfg.n_experts:
                    n *= cfg.top_k / cfg.n_experts
                total += n
            else:
                walk(v)

    walk(param_defs(cfg))
    return total


# ------------------------------------------------------------------ loss ---

def lm_loss(logits, labels, weights=None):
    """Weighted next-token cross entropy. logits: (B,S,V) f32; labels (B,S)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if weights is None:
        weights = torch.ones_like(ll)
    return -(ll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
