"""``chip_smoke._mirror``, the witness model of the n-rank check
(``chip_smoke.py --phase ranks``): the model with every dim the model axis
splits reversed (heads, kv heads, ff, vocabulary, experts, the Mamba
channels within each half of ``in_proj``, the mLSTM's input channels and
its heads as whole blocks, the sLSTM's heads as whole blocks wherever
the hidden state's space appears).  It must be a symmetry of the model:
on the mirrored tokens (``vocab - 1 - t``) the mirrored parameters give
the same loss, and the gradient of the mirrored parameters is the
mirrored gradient; and it must be its own inverse.  A wrong mirror would
otherwise show only as a broken witness rule on four cards.

Every leaf is given a seeded perturbation first, so no leaf is constant
(the norms' zeros and the biases' ones would hide a wrong mirror of
them)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import grad

import repro_torch.configs as PC
import repro_torch.models.transformer as PT
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
CASES = {"jamba": ("jamba-1.5-large-398b", {}),
         "xlstm": ("xlstm-350m", {}),
         "xlstm-one-head": ("xlstm-350m", {"n_heads": 1, "n_kv": 1}),
         "deepseek-7b": ("deepseek-7b", {}),
         "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {})}


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(case):
    arch, over = CASES[case]
    cfg = PC.get_config(arch).smoke_variant().with_overrides(**over)
    gen = torch.Generator().manual_seed(3)
    params = tree_map(lambda t: t + 0.05 * torch.randn(
        t.shape, generator=gen, dtype=t.dtype),
        PT.init_params(cfg, 0, device="cpu"))
    rng = np.random.default_rng(7)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                          dtype=torch.int32)
    return cfg, params, tok, torch.roll(tok, -1, 1)


def _loss(cfg):
    def loss(p, tok, lab):
        logits, _ = PT.forward(p, cfg, tok)
        return PT.lm_loss(logits, lab)
    return loss


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_is_its_own_inverse(chip_smoke, case):
    cfg, params, _, _ = _setup(case)
    axes = PT.param_axes(cfg)
    once = chip_smoke._mirror(params, axes, cfg)
    twice = chip_smoke._mirror(once, axes, cfg)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                     tree_leaves(once)))
    for a, b in zip(tree_leaves(params), tree_leaves(twice)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mirror_is_a_symmetry_of_the_model(chip_smoke, case):
    """The mirrored parameters on the mirrored tokens: the one-rank loss
    to rel 1e-5, and the gradient mirrored back within rel 1e-5 of the
    gradient's largest entry (a leaf's own would not do: at one head the
    mLSTM's input-gate bias has a gradient of about 1e-4 of the others',
    a sum of terms that nearly cancel, which float32 resolves to about
    1e-1 of itself in any order)."""
    cfg, params, tok, lab = _setup(case)
    axes = PT.param_axes(cfg)
    mirrored = chip_smoke._mirror(params, axes, cfg)
    loss = _loss(cfg)
    want = loss(params, tok, lab)
    got = loss(mirrored, cfg.vocab - 1 - tok, cfg.vocab - 1 - lab)
    assert abs(float(got) - float(want)) <= RTOL * abs(float(want))
    g = grad(loss)(params, tok, lab)
    gm = chip_smoke._mirror(grad(loss)(mirrored, cfg.vocab - 1 - tok,
                                       cfg.vocab - 1 - lab), axes, cfg)
    top = max(float(b.abs().max()) for b in tree_leaves(g))
    for a, b in zip(tree_leaves(gm), tree_leaves(g)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= RTOL * top
