"""The port's meta-device flop count (``repro_torch.launch.roofline`` through
``launch.dryrun.trace_step``) against the JAX package's loop-aware HLO
analysis (``repro.launch.hlo_analysis.analyze_hlo`` of its compiled train
step on the CPU), and the roofline terms' own rules.

Tolerances:
  * rel 1e-2: the train step's flops at the smoke variants of deepseek-7b,
    phi3.5-moe and whisper-small (batch 4, 64 tokens) under each
    ``remat_policy``: the reference counts XLA's dots after fusion and its
    remat pass, the port counts PyTorch's ``mm`` / ``bmm`` and derives the
    recompute from the forward pass's dataflow (within 0.2 % when
    measured);
  * rel 1e-2: the recompute under ``"full"`` at the smoke variant of
    every architecture the test above leaves out (jamba: Mamba;
    xlstm-350m: mLSTM and the sLSTM loop; whisper-small: the encoder's
    layers; dbrx: MoE; gemma2: local and global layers with soft-caps;
    qwen2-vl: patch inputs; stablelm; starcoder2), against the
    reference's ``full`` less its ``none``; and the whole step (at
    whisper-small the reference also counts the gradient's global norm,
    vector dots that ``FlopCounterMode`` does not count: 0.2 % of the
    step);
  * exact: the sLSTM loop counted as one block times its trip count
    against the whole loop traced (5 full blocks and a shorter one), and
    the three terms from their inputs.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JCONF
import repro.models.transformer as JT
import repro.launch.specs as JSP
import repro.optim as JO
import repro.train.steps as JST
from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.configs import ARCHS
from repro_torch.launch.dryrun import trace_step
import repro_torch.models.xlstm as xl
from repro_torch.launch.roofline import H100, roofline
from repro_torch.launch.specs import _extras_struct, param_structs
from repro_torch.optim import adamw_init

B, S = 4, 64


def _batch(b, s, cfg=None):
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
           "labels": torch.empty((b, s), dtype=torch.int32, device="meta"),
           "weights": torch.empty((b,), device="meta")}
    return {**out, **(_extras_struct(cfg, b, s) if cfg else {})}


@functools.lru_cache(maxsize=None)
def _ref_flops(arch, policy):
    """The reference's compiled train step's flops (``analyze_hlo``), once
    an (arch, policy): the two tests below share whisper-small's."""
    cfg = JCONF.ARCHS[arch].smoke_variant().with_overrides(
        remat_policy=policy)
    params = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.key(0)))
    opt = jax.eval_shape(JO.adamw_init, params)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    batch = {"tokens": tok, "labels": tok,
             "weights": jax.ShapeDtypeStruct((B,), jnp.float32),
             **JSP._extras_struct(cfg, B, S)}
    step = JST.build_train_step(cfg, JO.cosine_schedule(3e-4, 100, 10000))
    compiled = jax.jit(step).lower(params, opt, batch).compile()
    return analyze_hlo(compiled.as_text())["flops"]


def _port_flops(cfg, b=B, s=S):
    params = param_structs(cfg)
    counts, _ = trace_step(cfg, "train", params, _batch(b, s, cfg), s,
                           opt=adamw_init(params))
    return counts


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-small"])
def test_train_flops_match_reference_hlo(arch, policy):
    ref = _ref_flops(arch, policy)
    counts = _port_flops(ARCHS[arch].smoke_variant().with_overrides(
        remat_policy=policy))
    assert abs(counts["total"] - ref) <= 1e-2 * ref, (counts, ref)
    if policy == "none":
        assert counts["remat"] == 0.0
    else:
        assert counts["remat"] > 0.0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m",
                                  "whisper-small", "dbrx-132b",
                                  "gemma2-27b", "qwen2-vl-7b",
                                  "stablelm-12b", "starcoder2-3b"])
def test_full_remat_matches_reference_hlo(arch):
    full, none = _ref_flops(arch, "full"), _ref_flops(arch, "none")
    counts = _port_flops(ARCHS[arch].smoke_variant().with_overrides(
        remat_policy="full"))
    assert abs(counts["remat"] - (full - none)) <= 1e-2 * (full - none), (
        counts, full, none)
    assert abs(counts["total"] - full) <= 1e-2 * full, (counts, full)


def test_remat_orders_full_dots_none():
    cfg = ARCHS["deepseek-7b"].smoke_variant()
    tot = {p: _port_flops(cfg.with_overrides(remat_policy=p))["total"]
           for p in ("none", "dots", "full")}
    assert tot["none"] < tot["dots"] < tot["full"]


@pytest.mark.parametrize("policy", ["full", "none"])
def test_slstm_trip_count_equals_whole_loop(monkeypatch, policy):
    """The loop counted as one token's step times its trip count
    (``graphs.counting`` runs a ``per_position`` loop a token a block)
    counts what the whole loop traced in blocks of ``_SLSTM_BLOCK``
    tokens counts, backward and recompute included: 3 full blocks and a
    shorter last one (blocks of 4 tokens here, where the card's 64 would
    take a 200-token trace; the counts do not depend on the length)."""
    monkeypatch.setattr(xl, "_SLSTM_BLOCK", 4)
    cfg = ARCHS["xlstm-350m"].smoke_variant().with_overrides(
        remat_policy=policy)
    s = 3 * xl._SLSTM_BLOCK + 3
    params = param_structs(cfg)
    run = lambda loops: trace_step(  # noqa: E731
        cfg, "train", params, _batch(2, s), s, opt=adamw_init(params),
        loops=loops)[0]
    counted, whole = run(True), run(False)
    assert counted == whole
    assert counted["total"] > 0


def test_roofline_terms_from_their_inputs():
    coll = {"all-gather": 3e9, "reduce-scatter": 1e9, "all-reduce": 0.0,
            "all-to-all": 0.0, "collective-permute": 0.0, "count": 7}
    rl = roofline(256 * 989e12, 3.35e12, coll, 256,
                  model_flops=128 * 989e12)
    assert rl["compute_s"] == 1.0 and rl["memory_s"] == 1.0
    assert rl["collective_s"] == 4e9 / H100["link_bw"]
    assert rl["bottleneck"] == "compute"     # ties go to the first term
    assert rl["useful_ratio"] == 0.5 and rl["collective_count"] == 7
    assert rl["hlo_bytes_cost_analysis"] is None
