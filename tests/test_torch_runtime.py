"""The port's per-step math, runners and strategies against the JAX
package, on the CPU (each kernel's plain PyTorch version), plus the
port's own invariants and its isolation from JAX.

Both packages get one encoded problem (``EncodedProblem.from_numpy``) and
one schedule.  Objectives are compared with a RELATIVE tolerance: float32
sums taken in another order differ by a few ulps of the value (the
reference's own absolute 1e-5 trips on objectives near 30), so traces and
iterates must agree to rtol 1e-5 of the reference's magnitude.  Inside the
port, batched R = 1 equals single and cell-batched equals per-cell bit for
bit.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime as jrt
import repro_torch.core as tcore
import repro_torch.runtime as trt

M, K, P, N, T, R = 8, 6, 24, 96, 20, 3
RTOL = 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"


def _rel_close(out, ref, rtol=RTOL):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


@pytest.fixture(scope="module")
def spec():
    return jrt.ProblemSpec.synthetic(N, P, noise=0.5, lam=0.05, seed=0)


@pytest.fixture(scope="module")
def probs(spec):
    jp = jcore.make_encoded_problem(spec.X, spec.y,
                                    jcore.hadamard_encoder(N, 2.0), M,
                                    lam=spec.lam)
    tp = tcore.EncodedProblem.from_numpy(
        np.asarray(jp.SX), np.asarray(jp.Sy), np.asarray(jp.X),
        np.asarray(jp.y), lam=jp.lam, beta=jp.beta, n=jp.n, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def batch():
    eng = jrt.ClusterEngine(jcore.bimodal_delays(), M, seed=0)
    return eng.sample_schedules(T, jrt.FastestK(K), R)


@pytest.fixture(scope="module")
def fault_batch():
    eng = jrt.ClusterEngine(jcore.bimodal_delays(), M, seed=1,
                            faults="crash:p=0.5,at=0.5;corrupt:p=0.2")
    return eng.sample_schedules(T, jrt.FastestK(K), R)


def _tw(w):
    return torch.tensor(np.asarray(w), dtype=torch.float32)


# ---------------------------------------------------------------------------
# per-step math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", ["l2", "l1", "none"])
def test_step_math_matches_reference(probs, h):
    jp, tp = probs
    rng = np.random.default_rng(3)
    w = rng.standard_normal(P).astype(np.float32)
    mask = (rng.random(M) < 0.7).astype(np.float32)
    jw, jm = jnp.asarray(w), jnp.asarray(mask)
    tw, tm = torch.tensor(w), torch.tensor(mask)
    _rel_close(tcore.original_objective(tp, tw, h=h),
               jcore.original_objective(jp, jw, h=h))
    _rel_close(tcore.encoded_gradients(tp, tw),
               jcore.encoded_gradients(jp, jw))
    _rel_close(tcore.masked_gradient(tp, tw, tm),
               jcore.masked_gradient(jp, jw, jm))
    _rel_close(tcore.gd_step(tp, tw, tm, 0.05, h=h),
               jcore.gd_step(jp, jw, jm, 0.05, h=h))
    from repro.core.data_parallel import prox_step
    _rel_close(tcore.prox_step(tp, tw, tm, 0.05),
               prox_step(jp, jw, jm, 0.05))


def test_prox_l1_matches_reference():
    v = np.linspace(-2, 2, 41).astype(np.float32)
    assert np.array_equal(tcore.prox_l1(torch.tensor(v), 0.5).numpy(),
                          np.asarray(jcore.prox_l1(jnp.asarray(v), 0.5)))


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,h", [("gd", "l2"), ("gd", "none"),
                                    ("prox", "l1")])
@pytest.mark.parametrize("eval_every", [1, 4])
def test_scan_matches_reference(probs, batch, kind, h, eval_every):
    jp, tp = probs
    masks = batch.masks[0]
    if kind == "gd":
        jw, jtr = jrt.scan_gd(jp, jnp.asarray(masks), 0.05, jnp.zeros(P),
                              h=h, eval_every=eval_every)
        tw, ttr = trt.scan_gd(tp, masks, 0.05, torch.zeros(P), h=h,
                              eval_every=eval_every)
    else:
        jw, jtr = jrt.scan_prox(jp, jnp.asarray(masks), 0.05, jnp.zeros(P),
                                eval_every=eval_every)
        tw, ttr = trt.scan_prox(tp, masks, 0.05, torch.zeros(P),
                                eval_every=eval_every)
    assert ttr.shape == (T // eval_every,)
    _rel_close(ttr, jtr)
    _rel_close(tw, jw)


@pytest.mark.parametrize("kind", ["gd", "prox"])
def test_hold_degrade_matches_reference(probs, fault_batch, kind):
    jp, tp = probs
    masks = fault_batch.masks[0]
    assert (masks.sum(-1) < K).any()          # sub-k rounds do occur
    deg = ("hold", K, 0.5)
    if kind == "gd":
        jw, jtr = jrt.scan_gd(jp, jnp.asarray(masks), 0.05, jnp.zeros(P),
                              degrade=deg)
        tw, ttr = trt.scan_gd(tp, masks, 0.05, torch.zeros(P), degrade=deg)
    else:
        jw, jtr = jrt.scan_prox(jp, jnp.asarray(masks), 0.05, jnp.zeros(P),
                                degrade=deg)
        tw, ttr = trt.scan_prox(tp, masks, 0.05, torch.zeros(P),
                                degrade=deg)
    _rel_close(ttr, jtr)
    _rel_close(tw, jw)


@pytest.mark.parametrize("kind", ["gd", "prox"])
def test_batched_matches_reference_with_step_vector(probs, batch, kind):
    jp, tp = probs
    steps = np.asarray([0.02, 0.05, 0.08], np.float32)
    if kind == "gd":
        jw, jtr = jrt.batched_scan_gd(jp, jnp.asarray(batch.masks),
                                      jnp.asarray(steps), jnp.zeros((R, P)),
                                      eval_every=5)
        tw, ttr = trt.batched_scan_gd(tp, batch.masks, torch.tensor(steps),
                                      torch.zeros((R, P)), eval_every=5)
    else:
        jw, jtr = jrt.batched_scan_prox(jp, jnp.asarray(batch.masks),
                                        jnp.asarray(steps),
                                        jnp.zeros((R, P)), eval_every=5)
        tw, ttr = trt.batched_scan_prox(tp, batch.masks,
                                        torch.tensor(steps),
                                        torch.zeros((R, P)), eval_every=5)
    assert ttr.shape == (R, T // 5)
    for q in range(R):
        _rel_close(ttr[q], jtr[q])
        _rel_close(tw[q], jw[q])


@pytest.mark.parametrize("degrade", [None, ("hold", K, 0.5)])
def test_batched_r1_equals_single_bitwise(probs, fault_batch, degrade):
    _, tp = probs
    masks = fault_batch.masks[1]
    w_s, tr_s = trt.scan_gd(tp, masks, 0.05, torch.zeros(P), degrade=degrade)
    w_b, tr_b = trt.batched_scan_gd(tp, masks[None], 0.05,
                                    torch.zeros((1, P)), degrade=degrade)
    assert torch.equal(w_b[0], w_s) and torch.equal(tr_b[0], tr_s)


def test_batched_rows_equal_single_runs_bitwise(probs, batch):
    _, tp = probs
    w_b, tr_b = trt.batched_scan_prox(tp, batch.masks, 0.05,
                                      torch.zeros((R, P)), eval_every=2)
    for q in range(R):
        w_s, tr_s = trt.scan_prox(tp, batch.masks[q], 0.05, torch.zeros(P),
                                  eval_every=2)
        assert torch.equal(w_b[q], w_s) and torch.equal(tr_b[q], tr_s)


def test_eval_every_must_divide(probs, batch):
    _, tp = probs
    with pytest.raises(ValueError):
        trt.batched_scan_gd(tp, batch.masks, 0.05, torch.zeros((R, P)),
                            eval_every=3)


def test_sharded_falls_back_to_batched(probs, batch):
    _, tp = probs
    w, tr, ndev = trt.sharded_scan_gd(tp, batch.masks, 0.05,
                                      torch.zeros((R, P)), eval_every=5)
    w_b, tr_b = trt.batched_scan_gd(tp, batch.masks, 0.05,
                                    torch.zeros((R, P)), eval_every=5)
    assert ndev == 1 == trt.trials_device_count(R)
    assert torch.equal(w, w_b) and torch.equal(tr, tr_b)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

STRATEGIES = [("coded-gd", "l2", {}), ("coded-gd", "l2",
                                       {"encoder": "fast-hadamard"}),
              ("coded-prox", "l1", {}), ("uncoded", "l2", {}),
              ("replication", "l2", {})]


def _specs(h):
    jspec = jrt.ProblemSpec.synthetic(N, P, noise=0.5, lam=0.05, h=h, seed=2)
    tspec = trt.ProblemSpec.synthetic(N, P, noise=0.5, lam=0.05, h=h, seed=2)
    assert np.array_equal(jspec.X, tspec.X)
    return jspec, tspec


def _engines(seed=0, faults=None):
    return (jrt.ClusterEngine(jcore.bimodal_delays(), M, seed=seed,
                              faults=faults),
            trt.ClusterEngine(tcore.bimodal_delays(), M, seed=seed,
                              faults=faults))


@pytest.mark.parametrize("name,h,cfg", STRATEGIES)
def test_strategy_run_matches_reference(name, h, cfg):
    jspec, tspec = _specs(h)
    je, te = _engines()
    ref = jrt.get_strategy(name).run(jspec, je, steps=T, k=K, **cfg)
    out = trt.get_strategy(name).run(tspec, te, steps=T, k=K, device="cpu",
                                     **cfg)
    assert np.array_equal(out.times, ref.times)
    _rel_close(out.objective, ref.objective)
    _rel_close(out.w, ref.w)
    assert out.meta == ref.meta
    assert out.to_record().keys() == ref.to_record().keys()


@pytest.mark.parametrize("name,h,cfg", STRATEGIES)
def test_strategy_run_batched_matches_reference(name, h, cfg):
    jspec, tspec = _specs(h)
    je, te = _engines(seed=3)
    ref = jrt.get_strategy(name).run_batched(jspec, je, steps=T, trials=R,
                                             eval_every=5, k=K, **cfg)
    out = trt.get_strategy(name).run_batched(tspec, te, steps=T, trials=R,
                                             eval_every=5, k=K, device="cpu",
                                             **cfg)
    assert np.array_equal(out.times, ref.times)
    for q in range(R):
        _rel_close(out.objective[q], ref.objective[q])
    assert out.meta == ref.meta
    assert out.summary().keys() == ref.summary().keys()


@pytest.mark.parametrize("placement", ["single", "sharded"])
def test_run_batched_placements(placement):
    _, tspec = _specs("l2")
    _, te = _engines(seed=4)
    st = trt.get_strategy("coded-gd")
    base = st.run_batched(tspec, te, steps=T, trials=R, k=K, device="cpu")
    out = st.run_batched(tspec, te, steps=T, trials=R, k=K, device="cpu",
                         placement=placement)
    assert np.array_equal(out.times, base.times)
    assert np.array_equal(out.objective, base.objective)
    if placement == "sharded":
        assert out.meta["placement_devices"] == 1


def test_hold_degrade_strategy_matches_reference():
    jspec, tspec = _specs("l2")
    je, te = _engines(seed=5, faults="preset:zone-outage")
    ref = jrt.get_strategy("coded-gd").run(jspec, je, steps=T, k=K,
                                           degrade="hold")
    out = trt.get_strategy("coded-gd").run(tspec, te, steps=T, k=K,
                                           degrade="hold", device="cpu")
    assert np.array_equal(out.times, ref.times)
    _rel_close(out.objective, ref.objective)
    assert out.meta == ref.meta


@pytest.mark.parametrize("name,h", [("coded-gd", "l2"), ("coded-prox", "l1")])
def test_cellbatched_equals_percell_bitwise(name, h):
    _, tspec = _specs(h)
    engines = [trt.ClusterEngine(tcore.bimodal_delays(), M, seed=0),
               trt.ClusterEngine(tcore.power_law_delays(), M, seed=1)]
    cfgs = [{"k": K}, {"k": K - 1, "step_size": 0.02}]
    st = trt.get_strategy(name)
    cells = st.run_cellbatched(tspec, engines, steps=T, trials=R,
                               eval_every=5, cfgs=cfgs, device="cpu")
    for eng, cfg, cell in zip(engines, cfgs, cells):
        alone = st.run_batched(tspec, eng, steps=T, trials=R, eval_every=5,
                               device="cpu", **cfg)
        assert np.array_equal(cell.objective, alone.objective)
        assert np.array_equal(cell.w, alone.w)
        assert np.array_equal(cell.times, alone.times)
        assert cell.meta["cell_batched"] == 2


def test_run_batched_realization0_equals_run():
    _, tspec = _specs("l2")
    _, te = _engines(seed=6)
    st = trt.get_strategy("coded-gd")
    single = st.run(tspec, te, steps=T, k=K, device="cpu")
    batched = st.run_batched(tspec, te, steps=T, trials=R, k=K,
                             device="cpu")
    assert np.array_equal(batched.objective[0], single.objective)
    assert np.array_equal(batched.times[0], single.times)


def test_coded_prox_requires_l1():
    _, tspec = _specs("l2")
    _, te = _engines()
    with pytest.raises(ValueError):
        trt.get_strategy("coded-prox").run(tspec, te, steps=4, device="cpu")


def test_registry_and_validation_match_reference():
    # every strategy of the reference, coded SGD included
    assert trt.available_strategies() == jrt.available_strategies()
    for bad in [(10, 0, 1), (10, 2, -1), (10, 2, 3)]:
        with pytest.raises(ValueError):
            jrt.check_trials(*bad)
        with pytest.raises(ValueError):
            trt.check_trials(*bad)
    assert trt.resolve_eval_every(10, 0) == jrt.resolve_eval_every(10, 0)


# ---------------------------------------------------------------------------
# device policy and isolation from JAX
# ---------------------------------------------------------------------------

def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tspec = _specs("l2")
    _, te = _engines()
    st = trt.get_strategy("coded-gd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.run(tspec, te, steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.run_batched(tspec, te, steps=4, trials=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.run_cellbatched(tspec, [te], steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.make_encoded_problem(tspec.X, tspec.y,
                                   tcore.hadamard_encoder(N), M)
    with pytest.raises(RuntimeError):
        tcore.EncodedProblem.from_numpy(np.zeros((1, 1, 1)), np.zeros((1, 1)),
                                        np.zeros((1, 1)), np.zeros(1), lam=0,
                                        beta=1, n=1, device="cuda")


def test_import_leaves_jax_and_repro_unimported():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.runtime, "
            "repro_torch.kernels.ops, repro_torch.configs, repro_torch.data, "
            "repro_torch.obs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_import_no_jax_and_no_reference():
    import re
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
