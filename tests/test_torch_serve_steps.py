"""The port's serve path on its own terms, on the CPU, at
``smoke_variant()``: prefill + decode against the port's own forward for
every architecture, ``init_caches``, the ``Model`` bundle, the prefill
and decode steps of ``repro_torch.train.steps`` and the serve CLI
(``repro_torch.serve``); and the coded step over the newly ported blocks
against the reference's (``repro_torch.train.coded`` at phi3.5-moe's and
jamba's smoke variants: workers batched by ``torch.func.vmap`` through
the MoE dispatch and the Mamba scan), under ``test_torch_train_steps``'s
tolerances.  Inputs and helpers are ``test_torch_serve``'s.

The port's own prefill + decode against its own forward hold to 1e-3 of
the largest |logit|, the reference's tolerance for the same check
(``tests/test_decode_consistency.py``), at capacity factor 4.0 so no MoE
assignment is dropped (dropping differs between batched and incremental
execution by design).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core.gradient_coding as JG
import repro.data.pipeline as JD
import repro.models.transformer as JT
import repro.optim as JO
import repro.train.coded as JCT
import repro_torch.configs as PC
import repro_torch.core.gradient_coding as PG
import repro_torch.data.pipeline as PD
import repro_torch.models.transformer as PT
import repro_torch.optim as PO
import repro_torch.train.coded as PCT
import repro_torch.train.steps as PS
from repro_torch.models import params_from_numpy, state_from_numpy
from repro_torch.serve import main as serve_main
from repro_torch.serve import serve_inputs
from repro_torch.tree import tree_leaves
from test_torch_serve import (ARCHS, B, S, _close, _inputs, _same_structure,
                              _setup)
from test_torch_train_steps import _grads_close, _updated_params_close

CONSISTENCY = 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """Port of ``tests/test_decode_consistency.py``: the port's prefill
    and one decode step reproduce its own forward pass."""
    jcfg, pcfg, jp, pp, toks, kw = _setup(arch, capacity_factor=4.0)
    _, pkw = _inputs(kw, S + 1)
    full, _ = PT.forward(pp, pcfg, torch.from_numpy(toks[:, :S + 1]), **pkw)
    _, pkp = _inputs(kw, S)
    lg_pref, caches = PT.prefill(pp, pcfg, torch.from_numpy(toks[:, :S]),
                                 cache_len=S + 8, **pkp)
    lg_dec, _ = PT.decode_step(pp, pcfg, torch.from_numpy(toks[:, S:S + 1]),
                               caches, S)
    scale = float(full.abs().max())
    assert float((lg_pref[:, 0] - full[:, S - 1]).abs().max()) < \
        CONSISTENCY * scale
    assert float((lg_dec[:, 0] - full[:, S]).abs().max()) < \
        CONSISTENCY * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference(arch):
    """Zero caches with prefill's structure, every leaf equal to the
    reference's; each period owns its tensors (``decode_step`` writes
    into them)."""
    jcfg, pcfg = _setup(arch)[:2]
    jc = JT.init_caches(jcfg, B, S + 8)
    pc = PT.init_caches(pcfg, B, S + 8, device="cpu")
    _same_structure(pc, jc)
    for a, b in zip(tree_leaves(pc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.is_contiguous() and a.stride(0) > 0
    # a decode step from zero caches runs and writes only period 0's
    # slot 0 of a KV cache
    tok = torch.zeros((B, 1), dtype=torch.int64)
    PT.decode_step(PT.init_params(pcfg, 0, device="cpu"), pcfg, tok, pc, 0)
    for c, spec in zip(pc, pcfg.period):
        kv = c[0] if spec.cross_attn else c
        if spec.kind == "attn":
            assert kv.k[:, :, 1:].abs().sum() == 0 and kv.k.any()


def test_model_bundle_and_init_caches_without_device_raise(monkeypatch):
    jcfg, pcfg, jp, pp, toks, _ = _setup("deepseek-7b")
    model = PT.Model(pcfg)
    assert model.axes() == JT.Model(jcfg).axes()
    t = torch.from_numpy(toks[:, :S])
    torch.testing.assert_close(model(pp, t)[0], PT.forward(pp, pcfg, t)[0])
    lg, caches = model.prefill(pp, t, cache_len=S + 2)
    lg2, _ = model.decode(pp, t[:, -1:], caches, S)
    assert lg2.shape == (B, 1, pcfg.vocab)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_caches(pcfg, B, S)


# ---------------------------------------------------------------------------
# the prefill and decode steps
# ---------------------------------------------------------------------------

def test_prefill_and_decode_steps_equal_the_model_paths():
    jcfg, pcfg, jp, pp, toks, kw = _setup("whisper-small")
    _, pkw = _inputs(kw, S)
    t = torch.from_numpy(toks[:, :S])
    batch = {"tokens": t, **pkw}
    assert PS.batch_extras(pcfg, batch).keys() == {"enc_embeds"}
    lg, caches = PS.build_prefill_step(pcfg, cache_len=S + 2)(pp, batch)
    ref, ref_caches = PT.prefill(pp, pcfg, t, cache_len=S + 2, **pkw)
    assert torch.equal(lg, ref)
    for a, b in zip(tree_leaves(caches), tree_leaves(ref_caches)):
        assert torch.equal(a, b)
    tok = torch.from_numpy(toks[:, S:S + 1])
    lg1, _ = PS.build_decode_step(pcfg)(pp, tok, caches, S)
    lg2, _ = PT.decode_step(pp, pcfg, tok, ref_caches, S)
    assert torch.equal(lg1, lg2)


@pytest.mark.parametrize("arch,state_dtype", [
    pytest.param("phi3.5-moe-42b-a6.6b", None, id="phi3.5-moe-42b-a6.6b"),
    pytest.param("jamba-1.5-large-398b", None, id="jamba-1.5-large-398b"),
    pytest.param("jamba-1.5-large-398b", "float32",
                 id="jamba-1.5-large-398b-float32-state")])
def test_coded_step_over_new_blocks_matches_reference(arch, state_dtype):
    """The coded step (workers batched by ``torch.func.vmap``, now through
    the MoE dispatch's sort and scatters and the Mamba scan) against the
    reference's ``build_coded_train_step``: loss, the gradient and the
    updated parameters, as in ``test_torch_train_steps``.  The optimizer
    state is the config's (jamba's is bfloat16) or float32.  A bfloat16
    first moment keeps the gradient only to bfloat16 rounding of two clip
    scales that differ by the reference's float32 norm (1.3e-3), so there
    the moments are held to the bfloat16 tolerance, rel 1e-2, and the
    gradient to rel 1e-5 in the float32 case."""
    jcfg = JC.get_config(arch).smoke_variant().with_overrides(vocab=64)
    pcfg = PC.get_config(arch).smoke_variant().with_overrides(vocab=64)
    m = 8
    j, p = JG.make_code("frc", m, 2), PG.make_code("frc", m, 2)
    kw = dict(rows_per_group=1, num_groups=j.num_groups)
    jstep = jax.jit(JCT.build_coded_train_step(
        jcfg, JO.cosine_schedule(1e-3, 2, 10), **kw))
    pstep = PCT.build_coded_train_step(pcfg, PO.cosine_schedule(1e-3, 2, 10),
                                       **kw)
    jp = JT.init_params(jcfg, jax.random.key(0))
    sdt = state_dtype or jcfg.optstate_dtype
    jo = JO.adamw_init(jp, dtype=jnp.dtype(sdt))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    po = state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    jt, jl, jc = JD.GroupBatcher(JD.TokenStream(64, seed=0), j, 1, 16,
                                 seed=0).next_batch()
    pt, pl, pc = PD.GroupBatcher(PD.TokenStream(64, seed=0), p, 1, 16,
                                 seed=0).next_batch()
    d = p.decode_weights(np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float64))
    jp2, jo2, jm = jstep(jp, jo, jnp.asarray(jt), jnp.asarray(jl),
                         jnp.asarray(jc), jnp.asarray(d))
    pp2, po2, pm = pstep(pp, po, torch.from_numpy(pt), torch.from_numpy(pl),
                         torch.from_numpy(pc), torch.from_numpy(d))
    _close(pm["loss"], jm["loss"])
    if sdt == "float32":
        _grads_close(po2.m, pm["grad_norm"], jo2.m, jm["grad_norm"])
    else:
        for a, b in zip(tree_leaves(po2.m), jax.tree_util.tree_leaves(jo2.m)):
            assert a.dtype == torch.bfloat16
            _close(a, b, rtol=1e-2)
    _updated_params_close(pp2, jp2, jo2.m)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2-vl-7b",
                                  "whisper-small", "xlstm-350m"])
def test_serve_main_on_cpu(arch, capsys):
    """``python -m repro_torch.serve`` with ``--device cpu``: the greedy
    continuation it prints equals the argmax of the port's own forward
    over the prompt and the tokens it chose."""
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--tokens", "5"]
    assert serve_main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: 2x16 in ")
    assert out[1].startswith("decoded 4 steps x batch 2 in ")
    ids = [int(v) for v in out[2].split("[")[1].rstrip("]").split()]
    assert len(ids) == 5
    cfg = PC.get_config(arch).smoke_variant()
    params = PT.init_params(cfg, 0, device="cpu")
    prompts, kw = serve_inputs(cfg, 2, 16, np.random.default_rng(0), "cpu")
    seq = torch.cat([prompts.long(), torch.tensor([ids, ids])], dim=1)
    if "mrope_positions" in kw:
        kw["mrope_positions"] = torch.arange(20)[None, None].expand(3, 2, 20)
    logits, _ = PT.forward(params, cfg, seq[:, :-1], **kw)
    assert logits[0, 15:].argmax(-1).tolist() == ids


def test_serve_main_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", "deepseek-7b"])
