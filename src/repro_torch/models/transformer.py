"""Model driver: builds any architecture of the zoo from its ArchConfig
(port of ``repro.models.transformer``).

Decoder-only, MoE, hybrid (attn+mamba), xLSTM, encoder-decoder (whisper) and
VLM (qwen2-vl, patch inputs with M-RoPE) share the same machinery:

  * parameters: descriptor trees (models.common) — one period of blocks,
    stacked over ``n_periods`` in the reference's layout, so a parameter
    tree converts one array at a time (``models.convert``); the paths walk
    the periods with a Python loop where the reference scans;
  * three execution paths: ``forward`` (full-seq, train), ``prefill``
    (full-seq + cache build), ``decode_step`` (one token + cache);
  * logits are tied to the token embedding and computed in float32.

Caches are per-period-position NamedTuples stacked over n_periods, the
reference's scan layout, so a cache tree also converts one array at a time.
``decode_step`` writes into the caches it is given and returns them (no
cache is copied per token); ``init_caches`` materializes every period's
own zeros.  ``remat_policy`` only trades memory for recomputation in the
reference and changes no value; the port ignores it.  The reference's
``seq_parallel_*`` constraints put the query sequence on ``model``; the
port ignores them too and computes that attention whole on each rank.

On a data axis (``tp.data_axis``: the serve steps told a global batch
that the data axes do not take, as long_500k's of 1) the attention caches
that ``sharding.seq_on_data`` splits are held as each rank's slots
(context-parallel decode): ``prefill`` computes the whole sequence on
every rank, as the reference's replicated batch-1 program does, and keeps
the rank's slots of each such cache; ``decode_step`` (given
``cache_len``) writes a new key on the rank that owns its slot and merges
attention over the data group (``attention.decode_attend``).

On a ``model`` axis (``sharding.tp``) the leaves ``model_shards`` names
come in as the rank's model shard: attention runs on the rank's heads,
the MLP on its ff columns, the MoE layer on its experts, the Mamba layer
on its d_inner channels, the mLSTM and the sLSTM on its heads and the
tied embedding on its vocabulary rows, each meeting the other ranks
through ``sharding.tp``'s collectives.  ``forward`` then returns the rank's
vocabulary shard of the logits and ``lm_loss(..., vocab=)`` is the
vocabulary-parallel cross entropy; ``prefill`` and ``decode_step`` gather
the last position's logits whole.  Given whole leaves, every function is
the one-device program.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, BlockSpec

from repro_torch.device import resolve_device
from repro_torch.sharding import tp
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from . import attention as attn
from . import mamba as mb
from . import xlstm as xl
from .common import (Dtype, _is_def, layernorm, pdef, rmsnorm, softcap,
                     stack_defs, tree_axes, tree_init)
from .mlp import mlp_apply, mlp_defs
from .moe import moe_apply, moe_defs
from .rope import (apply_rope, mrope_angles, rope_angles,
                   sinusoidal_positions)

__all__ = ["param_defs", "init_params", "param_axes", "model_shards",
           "forward", "prefill", "decode_step", "init_caches", "lm_loss",
           "count_params", "Model"]


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


def _block_defs(cfg, spec: BlockSpec):
    d = {}
    d.update(_norm_defs(cfg, "norm1"))
    if spec.kind == "attn":
        d.update(attn.attn_defs(cfg))
        if spec.cross_attn:
            d.update(_norm_defs(cfg, "normc"))
            d.update(attn.attn_defs(cfg, cross=True))
    elif spec.kind == "mamba":
        d.update(mb.mamba_defs(cfg))
    elif spec.kind == "mlstm":
        d.update(xl.mlstm_defs(cfg))
    elif spec.kind == "slstm":
        d.update(xl.slstm_defs(cfg))
    else:
        raise ValueError(spec.kind)
    if spec.mlp:
        d.update(_norm_defs(cfg, "norm2"))
        d.update(moe_defs(cfg) if spec.moe else mlp_defs(cfg))
    if cfg.post_block_norm:
        d.update(_norm_defs(cfg, "postn1"))
        if spec.mlp:
            d.update(_norm_defs(cfg, "postn2"))
    return d


def param_defs(cfg: ArchConfig):
    defs: dict = {
        "embed": pdef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                      scale=1.0),
        "blocks": {str(i): stack_defs(_block_defs(cfg, s), cfg.n_periods)
                   for i, s in enumerate(cfg.period)},
    }
    defs.update(_norm_defs(cfg, "final_norm"))
    if cfg.n_enc_layers:
        enc_spec = BlockSpec("attn")
        defs["encoder"] = {
            "blocks": stack_defs(_block_defs(cfg, enc_spec), cfg.n_enc_layers),
        }
        defs["encoder"].update(_norm_defs(cfg, "enc_norm"))
    if cfg.n_patches:
        defs["projector"] = pdef((cfg.d_vision, cfg.d_model),
                                 (None, "embed"))
    return defs


def init_params(cfg: ArchConfig, key, *, device=None):
    """Random parameters in ``cfg.param_dtype`` on ``device`` (unset: the
    CUDA card), the same for a seed on every device.  ``key`` is an int
    seed or a CPU ``torch.Generator`` (``common.tree_init``)."""
    return tree_init(param_defs(cfg), key, Dtype.of(cfg.param_dtype),
                     device=device)


def param_axes(cfg: ArchConfig):
    return tree_axes(param_defs(cfg))


# the leaves a layer computes on the rank's model shard, by block kind: the
# attention blocks' projections (self and cross), the Mamba layer's d_inner
# leaves, the mLSTM's (not its replicated gate biases bi / bf), the sLSTM's
# gates by heads and its post-projection by ff (not its norm ``gn``, which
# the placement keeps whole); with any kind, the dense MLP's and the
# experts' weights; and the tied embedding
_ATTN_SHARDS = frozenset(pre + w for pre in ("", "c")
                         for w in ("wq", "wk", "wv", "wo"))
_MLP_SHARDS = frozenset(("ffn_wi", "ffn_wg", "ffn_wo", "moe_wi", "moe_wg",
                         "moe_wo"))
_KIND_SHARDS = {
    "attn": _ATTN_SHARDS,
    "mamba": frozenset(("in_proj", "conv_w", "conv_b", "x_proj", "dt_w",
                        "dt_b", "A_log", "D", "out_proj")),
    "mlstm": frozenset(("up", "wq", "wk", "wv", "wi", "wf", "gn", "down")),
    "slstm": frozenset([w + g for w in "wrb" for g in "zifo"]
                       + ["up", "gate", "down"]),
}


def model_shards(cfg: ArchConfig):
    """A tree of bools like the parameters': True for a leaf that its layer
    computes on the rank's model shard (``sharding.tp``), False for one it
    computes whole on every rank of a model group (the norms, the router,
    the projector, the mLSTM's gate biases, the sLSTM's norm).

    The rule where the axis does not divide a dim: the placement
    (``sharding.make_shardings``) then leaves that leaf whole on
    ``model``, a True leaf comes in whole, and its layer computes that
    part whole: attention whose heads do not divide (each rank cutting
    the kv heads of its query heads where only the kv heads do not), the
    Mamba layer where d_inner does not divide, the mLSTM's recurrence where its heads do not
    divide (its q, k, v and gates all-reduced whole, its norm and
    ``down`` still on the rank's channels), the sLSTM's recurrence where
    its heads do not (its post-projection still on ``ff``)."""
    kinds = {("blocks", str(i)): s.kind for i, s in enumerate(cfg.period)}
    kinds[("encoder", "blocks")] = "attn"

    def walk(d, path):
        if _is_def(d):
            kind, k = kinds.get(path[:-1]), path[-1]
            return path == ("embed",) or kind is not None and (
                k in _MLP_SHARDS or k in _KIND_SHARDS[kind])
        return {k: walk(v, path + (k,)) for k, v in d.items()}

    return walk(param_defs(cfg), ())


# ------------------------------------------------------------- rope ctx ----

def _rope_ctx(cfg: ArchConfig, positions, mrope_positions):
    """cos/sin for the given positions (S,), or None (no rotary)."""
    if cfg.mrope_sections is not None and mrope_positions is not None:
        return mrope_angles(mrope_positions, cfg.hd, cfg.mrope_sections,
                            cfg.rope_theta)                # (B, S, half)
    if cfg.learned_pos:  # whisper-style: additive sinusoidal, no rotary
        return None
    cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)  # (S, half)
    return cos[None], sin[None]


def _make_rope_fn(ctx):
    if ctx is None:
        return lambda t, pos=None: t
    cos, sin = ctx
    return lambda t, pos=None: apply_rope(t, cos, sin)


# ----------------------------------------------------------- block apply ---

def _attn_full(bp, spec, x, cfg, rope_ctx, causal, want_cache, enc_out,
               cache_len=None):
    """Full-sequence attention sublayer. Returns (delta, cache|None).

    On a model shard of the heads the queries, keys and values are the
    rank's (column-parallel: every input of a projection through
    ``tp.copy_to``), and the self and cross output projections' partial
    sum is all-reduced once (row-parallel).  On a data axis the whole
    sequence is computed and each cache kept as the rank's slots where
    ``attention.seq_shard`` splits it (``attention.own_slots``)."""
    S = x.shape[1]
    dev = x.device
    sharded = bp["wq"].shape[1] < cfg.n_heads
    into = tp.copy_to if sharded else (lambda t: t)
    bp, _ = attn.local_kv(bp, cfg)
    q, k, v = attn.qkv_proj(bp, into(x))
    rope_fn = _make_rope_fn(rope_ctx)
    q, k = rope_fn(q), rope_fn(k)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    valid = torch.ones((S,), dtype=torch.bool, device=dev)
    o = attn.attention(q, k, v, causal=causal, window=spec.window,
                       cap=cfg.attn_softcap, qpos=pos, kpos=pos, kvalid=valid,
                       chunk=cfg.attn_chunk, banded=cfg.banded_window)
    delta = attn.out_proj(bp, o)
    cache = None
    if want_cache:
        W = spec.window
        if W is not None and S > W:
            if S % W:
                raise ValueError(f"ring-buffer prefill needs S % window == 0 "
                                 f"(S {S}, window {W})")
            k, v = k[:, S - W:].contiguous(), v[:, S - W:].contiguous()
        else:
            # Pre-allocate decode headroom (ring size capped at the window).
            target = cache_len if cache_len is not None else S
            if W is not None:
                target = min(target, W)
            if target > S:
                pad = (0, 0, 0, 0, 0, target - S)
                k, v = F.pad(k, pad), F.pad(v, pad)
        cache = attn.own_slots(attn.AttnCache(k, v))
    if spec.cross_attn:
        xc = _apply_norm(cfg, bp, "normc", x)
        bp, _ = attn.local_kv(bp, cfg, "c")
        # only the query comes from the decoder stream (the reference's
        # compiled program drops the keys and values its qkv_proj makes
        # here; computing them would be work it does not do)
        qc = torch.einsum("bsd,dhk->bshk", into(xc), bp["cwq"])
        Fr = enc_out.shape[1]
        enc = into(enc_out)
        ck = torch.einsum("bfd,dhk->bfhk", enc, _promoted(bp["cwk"], enc))
        cv = torch.einsum("bfd,dhk->bfhk", enc, _promoted(bp["cwv"], enc))
        oc = attn.attention(
            qc, ck, cv, causal=False, window=None, cap=None, qpos=pos,
            kpos=torch.arange(Fr, dtype=torch.int32, device=dev),
            kvalid=torch.ones((Fr,), dtype=torch.bool, device=dev),
            chunk=cfg.attn_chunk)
        delta = delta + attn.out_proj(bp, oc, pre="c")
        if want_cache:
            cache = (cache, attn.own_slots(attn.AttnCache(ck, cv)))
    if sharded:
        delta = tp.reduce_from(delta)
    return delta, cache


def _mlp_sublayer(bp, spec, x, cfg, aux):
    """The block's (dense or MoE) MLP residual branch. Returns (x, aux)."""
    if spec.mlp:
        h2 = _apply_norm(cfg, bp, "norm2", x)
        if spec.moe:
            delta2, losses = moe_apply(bp, h2, cfg)
            if aux is not None:
                aux = {k: aux.get(k, 0.0) + v for k, v in losses.items()}
        else:
            delta2 = mlp_apply(bp, h2, cfg)
        if cfg.post_block_norm:
            delta2 = _apply_norm(cfg, bp, "postn2", delta2)
        x = x + delta2
    return x, aux


def _block_full(bp, spec: BlockSpec, x, cfg, rope_ctx, aux, *, causal=True,
                want_cache=False, enc_out=None, cache_len=None):
    """One block, full-sequence. Returns (x, cache, aux)."""
    h = _apply_norm(cfg, bp, "norm1", x)
    cache = None
    if spec.kind == "attn":
        delta, cache = _attn_full(bp, spec, h, cfg, rope_ctx, causal,
                                  want_cache, enc_out, cache_len=cache_len)
    else:
        apply = {"mamba": mb.mamba_apply, "mlstm": xl.mlstm_apply,
                 "slstm": xl.slstm_apply}[spec.kind]
        out = apply(bp, h, cfg, return_cache=want_cache)
        delta, cache = out if want_cache else (out, None)
    if cfg.post_block_norm:
        delta = _apply_norm(cfg, bp, "postn1", delta)
    x = x + delta
    x, aux = _mlp_sublayer(bp, spec, x, cfg, aux)
    return x, cache, aux


def _block_decode(bp, spec: BlockSpec, x, cfg, cache, index, rope_decode,
                  cache_len=None):
    """One block, single-token decode. Returns (x, new_cache).
    ``cache_len``: ``decode_step``'s."""
    h = _apply_norm(cfg, bp, "norm1", x)
    if spec.kind == "attn":
        if spec.cross_attn:
            self_cache, cross_cache = cache
        else:
            self_cache = cache
        C = cache_len
        if C is not None and spec.window:
            C = min(C, spec.window)
        delta, new_self = attn.decode_attend(
            bp, h, self_cache, index, cfg=cfg, window=spec.window,
            cap=cfg.attn_softcap, rope_fn=rope_decode, cache_len=C)
        if spec.cross_attn:
            xc = _apply_norm(cfg, bp, "normc", x)
            qc = torch.einsum("bsd,dhk->bshk", xc, bp["cwq"])
            ck, cv = attn.local_cache(cross_cache,
                                      attn.kv_heads(bp, cfg, "c"), cfg)
            Fr, lo, att = ck.shape[1], 0, attn.attention
            # the frames' global count, as ``init_caches`` makes them
            shard = None if cache_len is None else attn.seq_shard(
                x.shape[0], max(cfg.n_enc_frames, 1), held=Fr)
            if shard is not None:
                lo, att = shard[1] * Fr, attn.merged_attention
            oc = att(
                qc, ck, cv, causal=False, window=None,
                cap=None, qpos=torch.zeros((1,), dtype=torch.int32,
                                           device=x.device),
                kpos=torch.arange(lo, lo + Fr, dtype=torch.int32,
                                  device=x.device),
                kvalid=torch.ones((Fr,), dtype=torch.bool, device=x.device),
                chunk=cfg.attn_chunk)
            delta = delta + attn.out_proj(bp, oc, pre="c")
            new_cache = (new_self, cross_cache)
        else:
            new_cache = new_self
        if bp["wq"].shape[1] < cfg.n_heads:
            delta = tp.reduce_from(delta)
    else:
        step = {"mamba": mb.mamba_decode, "mlstm": xl.mlstm_decode,
                "slstm": xl.slstm_decode}[spec.kind]
        delta, new_cache = step(bp, h, cache, cfg)
    if cfg.post_block_norm:
        delta = _apply_norm(cfg, bp, "postn1", delta)
    x = x + delta
    x, _ = _mlp_sublayer(bp, spec, x, cfg, None)
    return x, new_cache


def _unstack(tree, n: int):
    """A tree of (n, ...) stacked leaves -> n trees of views, one a period
    (one ``unbind`` a leaf: its backward stacks the periods' gradients in
    one copy)."""
    unbound = [x.unbind(0) for x in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[t] for u in unbound]) for t in range(n)]


def _per_period(stacked, n: int):
    """Trees stacked over the n periods, one a period position -> per
    period, the list of that period's trees (views), in period order."""
    parts = [_unstack(tree, n) for tree in stacked]
    return [[part[t] for part in parts] for t in range(n)]


def _periods(params, cfg: ArchConfig):
    """Per period, the period's block parameters in period order."""
    return _per_period([params["blocks"][str(i)]
                        for i in range(len(cfg.period))], cfg.n_periods)


def _stack(trees):
    """Per-period cache trees -> one tree of (n_periods, ...) leaves."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


# -------------------------------------------------------------- encoder ----

def _promoted(w, x):
    """``w`` in the dtype JAX promotes (w, x) to: frame embeddings wider
    than the parameters (float32 frames into a bfloat16 model) run the
    encoder and the cross-attention keys in float32, as the reference's
    mixed-dtype products do."""
    return w.to(torch.promote_types(w.dtype, x.dtype))


def _encode(params, cfg: ArchConfig, enc_embeds):
    """Whisper-style encoder over stub frame embeddings (B, F, d)."""
    ep = params["encoder"]
    Fr = enc_embeds.shape[1]
    x = enc_embeds + sinusoidal_positions(
        torch.arange(Fr, device=enc_embeds.device),
        cfg.d_model)[None].to(enc_embeds.dtype)
    spec = BlockSpec("attn")
    for bp in _unstack(ep["blocks"], cfg.n_enc_layers):
        bp = {k: _promoted(w, x) for k, w in bp.items()}
        x, _, _ = _block_full(bp, spec, x, cfg, None, None,
                              causal=cfg.causal_encoder)
    return _apply_norm(cfg, ep, "enc_norm", x)


# ---------------------------------------------------------- embed/logits ---

def _embed_inputs(params, cfg: ArchConfig, tokens, patch_embeds,
                  positions=None):
    dt = Dtype.of(cfg.dtype)
    # F.embedding's backward sums each row's gradient in a fixed order on
    # the card (sorted indices), where indexing's accumulates with atomics
    table = params["embed"]
    if table.shape[0] < cfg.vocab:
        # the rank's vocabulary rows: tokens outside them look up zeros,
        # and the sum over the model group has one nonzero term a token
        t = tokens.long() - tp.rank() * table.shape[0]
        own = ((t >= 0) & (t < table.shape[0]))[..., None]
        x = torch.where(own, F.embedding(torch.where(own[..., 0], t, 0),
                                         table), 0).to(dt)
        x = tp.reduce_from(x)
    else:
        x = F.embedding(tokens.long(), table).to(dt)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.n_patches and patch_embeds is not None:
        proj = torch.matmul(patch_embeds.to(dt), params["projector"].to(dt))
        # patches occupy the first n_patches positions of the stream
        x = torch.cat([proj, x[:, cfg.n_patches:]], dim=1)
    if cfg.learned_pos:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        x = x + sinusoidal_positions(positions, cfg.d_model)[None].to(dt)
    return x


def _logits(params, cfg: ArchConfig, x):
    """Logits float32, the rank's vocabulary shard on a model shard of the
    tied embedding."""
    x = _apply_norm(cfg, params, "final_norm", x)
    w = params["embed"]
    if w.shape[0] < cfg.vocab:
        x = tp.copy_to(x)
    # float32 products and sums, as the reference's preferred_element_type
    logits = torch.matmul(x.float(), w.float().t())
    return softcap(logits, cfg.final_softcap)


def _whole(cfg: ArchConfig, logits):
    """``logits`` over the whole vocabulary: a shard's all-gathered."""
    if logits.shape[-1] < cfg.vocab:
        return tp.all_gather(logits, -1)
    return logits


def _prelude(params, cfg, tokens, patch_embeds, mrope_positions,
             enc_embeds):
    """Embedded inputs, rotary tables and encoder output of a full pass."""
    x = _embed_inputs(params, cfg, tokens, patch_embeds)
    S = x.shape[1]
    rope_ctx = _rope_ctx(cfg, torch.arange(S, dtype=torch.int32,
                                           device=x.device), mrope_positions)
    enc_out = _encode(params, cfg, enc_embeds) if cfg.n_enc_layers else None
    return x, rope_ctx, enc_out


# ------------------------------------------------------------ main paths ---

def forward(params, cfg: ArchConfig, tokens, *, patch_embeds=None,
            mrope_positions=None, enc_embeds=None):
    """Full-sequence forward -> (logits (B, S, V) float32, aux dict); on a
    model shard of the embedding the rank's vocabulary shard (B, S, V/n).

    ``aux`` carries the router terms (zero without MoE), summed over the
    MoE layers, so a train step adds them as the reference does."""
    x, rope_ctx, enc_out = _prelude(params, cfg, tokens, patch_embeds,
                                    mrope_positions, enc_embeds)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"load_balance": zero, "router_z": zero}
    for bps in _periods(params, cfg):
        for bp, spec in zip(bps, cfg.period):
            x, _, aux = _block_full(bp, spec, x, cfg, rope_ctx, aux,
                                    enc_out=enc_out)
    return _logits(params, cfg, x), aux


def prefill(params, cfg: ArchConfig, tokens, *, patch_embeds=None,
            mrope_positions=None, enc_embeds=None, cache_len=None):
    """Full-sequence forward building caches -> (last-pos logits, caches).

    ``cache_len`` > S pre-allocates decode headroom in non-windowed caches.
    """
    x, rope_ctx, enc_out = _prelude(params, cfg, tokens, patch_embeds,
                                    mrope_positions, enc_embeds)
    per_period = []
    for bps in _periods(params, cfg):
        caches = []
        for bp, spec in zip(bps, cfg.period):
            x, cache, _ = _block_full(bp, spec, x, cfg, rope_ctx, None,
                                      want_cache=True, enc_out=enc_out,
                                      cache_len=cache_len)
            caches.append(cache)
        per_period.append(tuple(caches))
    logits = _whole(cfg, _logits(params, cfg, x[:, -1:]))
    return logits, _stack(per_period)


def _write_back(dst, src) -> None:
    """Copy a block's new cache into its period's slot of the stacked
    caches (an attention cache was written in place already)."""
    for d, x in zip(tree_leaves(dst), tree_leaves(src)):
        if d.data_ptr() != x.data_ptr():
            d.copy_(x)


def decode_step(params, cfg: ArchConfig, token, caches, index, *,
                mrope_positions=None, cache_len=None):
    """One decode step. token: (B, 1) int; index: the current position, a
    Python int or a 0-d integer tensor on the model's device (the
    reference's traced scalar: every value that depends on it is computed
    on the device, nothing is read back, and a CUDA graph of the step reads
    it from its buffer; ``models.decoder``).  ``mrope_positions`` is
    accepted for the reference's signature: at decode every M-RoPE stream
    takes ``index``, as there.

    Writes the step's keys, values and states INTO ``caches`` (a tree as
    ``prefill`` or ``init_caches`` returns) and returns (logits (B, 1, V),
    the same caches).

    ``cache_len``: the caches' global length, as ``init_caches`` or
    ``prefill`` took it (a windowed cache's is min(cache_len, window), a
    cross-attention cache's the config's frames), required on a data axis
    (``tp.data_axis``), where each cache that ``attention.seq_shard``
    splits is the rank's slots of it; unset off one: the caches are whole.
    """
    if cache_len is None and tp.data_mesh() is not None and any(
            s.kind == "attn" for s in cfg.period):
        raise ValueError("decode on a data axis needs the caches' global "
                         "length (cache_len): their sequence may be split")
    dev = token.device
    pos = attn.position(index, dev)                        # (1,) int32
    x = _embed_inputs(params, cfg, token, None, positions=pos)

    if cfg.mrope_sections is not None:
        pos3 = pos.reshape(1, 1, 1).expand(3, token.shape[0], 1)
        rope_decode = _make_rope_fn(mrope_angles(
            pos3, cfg.hd, cfg.mrope_sections, cfg.rope_theta))
    elif cfg.learned_pos:
        rope_decode = lambda t, pos=None: t
    else:
        def rope_decode(t, pos):
            cos, sin = rope_angles(pos, cfg.hd, cfg.rope_theta)
            return apply_rope(t, cos[None], sin[None])

    for bps, cps in zip(_periods(params, cfg),
                        _per_period(caches, cfg.n_periods)):
        for bp, spec, cache in zip(bps, cfg.period, cps):
            x, new = _block_decode(bp, spec, x, cfg, cache, pos,
                                   rope_decode, cache_len)
            _write_back(cache, new)
    return _whole(cfg, _logits(params, cfg, x)), caches


def init_caches(cfg: ArchConfig, B: int, cache_len: int, *, device=None):
    """Zero caches matching prefill's structure (stacked over n_periods),
    on ``device`` (unset: the CUDA card); every period has its own
    tensors, as ``decode_step`` writes into them."""
    device = resolve_device(device)
    dt = Dtype.of(cfg.dtype)
    per_pos = []
    for spec in cfg.period:
        if spec.kind == "attn":
            C = min(cache_len, spec.window) if spec.window else cache_len
            c = attn.init_kv_cache(B, C, cfg.n_kv, cfg.hd, dt, device=device)
            if spec.cross_attn:
                c = (c, attn.init_kv_cache(B, max(cfg.n_enc_frames, 1),
                                           cfg.n_kv, cfg.hd, dt,
                                           device=device))
        elif spec.kind == "mamba":
            c = mb.init_mamba_cache(cfg, B, dt, device=device)
        elif spec.kind == "mlstm":
            c = xl.init_mlstm_cache(cfg, B, dt, device=device)
        elif spec.kind == "slstm":
            c = xl.init_slstm_cache(cfg, B, dt, device=device)
        per_pos.append(c)
    return _stack([tuple(per_pos)] * cfg.n_periods)


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

def lm_loss(logits, labels, weights=None, *, vocab=None):
    """Weighted next-token cross entropy. logits: (B,S,V) f32; labels (B,S).

    ``vocab``: the whole vocabulary; logits narrower than it are the rank's
    vocabulary shard (``forward`` on a model axis), and the loss is the
    vocabulary-parallel cross entropy: the max, the sum of exponentials and
    the target's logit each reduced over the model group, in float32."""
    if vocab is not None and logits.shape[-1] < vocab:
        ll = _vocab_parallel_ll(logits, labels)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if weights is None:
        weights = torch.ones_like(ll)
    return -(ll * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def _vocab_parallel_ll(logits, labels):
    """log p(label) from the rank's vocabulary shard of the logits."""
    V = logits.shape[-1]
    m = tp.all_reduce_max(logits.amax(dim=-1))            # no gradient
    z = logits - m[..., None]
    denom = tp.reduce_from(torch.exp(z).sum(dim=-1))
    t = labels.long() - tp.rank() * V
    own = (t >= 0) & (t < V)
    tgt = torch.gather(z, -1, torch.where(own, t, 0)[..., None])[..., 0]
    tgt = tp.reduce_from(torch.where(own, tgt, 0.0))
    return tgt - torch.log(denom)


@dataclasses.dataclass(frozen=True)
class Model:
    """Convenience bundle of the functional API for one architecture."""
    cfg: ArchConfig

    def init(self, key, *, device=None):
        return init_params(self.cfg, key, device=device)

    def axes(self):
        return param_axes(self.cfg)

    forward = staticmethod(forward)

    def __call__(self, params, tokens, **kw):
        return forward(params, self.cfg, tokens, **kw)

    def prefill(self, params, tokens, **kw):
        return prefill(params, self.cfg, tokens, **kw)

    def decode(self, params, token, caches, index, **kw):
        return decode_step(params, self.cfg, token, caches, index, **kw)
