"""One train step of every architecture of the zoo
(``repro_torch.train.steps.build_train_step``) against the JAX package's,
on the CPU; the coded step over the newly ported blocks is in
``test_torch_serve_steps.py``, under the same tolerances.  Parameters and
inputs are ``test_torch_serve``'s (the reference's ``init_params``, a
numpy seed).

Tolerances: the loss rel 1e-5; the gradient norm rel 1e-5 against the
reference gradient's norm summed in float64 (recovered from its first
moment: the reference's own jitted norm is a float32 sum over leaves of up
to 262 144 squares, off by up to 1e-4); the gradient itself, recovered
from each package's first moment with its own clip scale undone, rel 1e-5
of each leaf's largest magnitude (measured: at most 5.7e-6, whisper-small);
the updated parameters rel 1e-5 of a leaf's largest magnitude wherever the
gradient check fixes the entry's sign (the reference's entry above that
gradient tolerance, and above 1e4 eps, where AdamW's step no longer
depends on the magnitude), and within 2 lr + rel 1e-5 elsewhere: AdamW's
first step moves an entry by lr g / (|g| + eps), so an entry the gradient
check leaves within its tolerance of zero may take either sign.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as JO
import repro.train.steps as JS
import repro_torch.optim as PO
import repro_torch.train.steps as PS
from repro_torch.tree import tree_leaves
from test_torch_serve import ARCHS, RTOL, _close, _inputs, _setup

B1, EPS = 0.9, 1e-8                          # AdamW's defaults
LR = float(JO.cosine_schedule(1e-3, 2, 10)(0))   # the first step's rate


def _grads(m, norm):
    """The raw gradient from a first moment after one AdamW step,
    m = (1 - b1) min(1, 1 / |g|) g, with the package's own norm |g|."""
    scale = min(1.0, 1.0 / max(float(norm), 1e-9))
    return [np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                       else x, np.float64) / ((1 - B1) * scale) for x in m]


def _grads_close(port_m, port_norm, ref_m, ref_norm):
    """Each leaf of the port's gradient within rel 1e-5 of the
    reference's largest entry of that leaf."""
    port = _grads(tree_leaves(port_m), port_norm)
    ref = _grads(jax.tree_util.tree_leaves(ref_m), ref_norm)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= RTOL * max(np.abs(b).max(), 1e-30)


def _updated_params_close(port, ref, ref_m):
    """Updated parameters after one AdamW step (module docstring); ref_m is
    the reference's new first moment, (1 - b1) times its clipped
    gradient."""
    for a, b, m in zip(tree_leaves(port), jax.tree_util.tree_leaves(ref),
                       jax.tree_util.tree_leaves(ref_m)):
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        g = np.abs(np.asarray(m, np.float32)) / (1 - B1)
        assert a.shape == b.shape
        d, tol = np.abs(a - b), RTOL * max(np.abs(b).max(), 1e-30)
        resolved = (g > RTOL * g.max()) & (g > 1e4 * EPS)
        assert d[resolved].max(initial=0.0) <= tol
        assert d.max() <= tol + 2 * LR


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``build_train_step`` step from the same parameters and batch:
    loss, metrics, the gradient and the updated parameters (module
    docstring)."""
    jcfg, pcfg, jp, pp, toks, kw = _setup(arch)
    n = 32
    jkw, pkw = _inputs(kw, n)
    batch = {"tokens": toks[:, :n], "labels": toks[:, 1:n + 1],
             "weights": np.array([1.0, 0.5], np.float32)}
    jstep = jax.jit(JS.build_train_step(jcfg, JO.cosine_schedule(1e-3, 2,
                                                                  10)))
    pstep = PS.build_train_step(pcfg, PO.cosine_schedule(1e-3, 2, 10),
                                grad_specs=object())
    jp2, jo2, jm = jstep(jp, JO.adamw_init(jp),
                         {**{k: jnp.asarray(v) for k, v in batch.items()},
                          **jkw})
    pp2, po2, pm = pstep(pp, PO.adamw_init(pp),
                         {**{k: torch.from_numpy(v) for k, v in
                             batch.items()}, **pkw})
    assert sorted(pm) == sorted(jm)
    _close(pm["loss"], jm["loss"])
    _close(pm["lr"], jm["lr"])
    # the reference's first moment is (1 - b1) min(1, 1 / |g|) g, with its
    # own float32 |g|: undo the scale, sum the squares in float64
    scale = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    ref_norm = np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2) for x in
                           jax.tree_util.tree_leaves(jo2.m))) / (1 - B1) \
        / scale
    _close(pm["grad_norm"], ref_norm)
    for name in ("load_balance", "router_z"):
        _close(pm[name], jm[name])
    assert int(po2.count) == 1
    _grads_close(po2.m, pm["grad_norm"], jo2.m, jm["grad_norm"])
    _updated_params_close(pp2, jp2, jo2.m)
