"""Encoded L-BFGS, encoded BCD and the async stale-gradient baseline of the
port against the JAX package, on the CPU, plus the paper's convergence
guarantees (Thms 4 and 6) on the port itself.

Both packages get one problem (``EncodedProblem.from_numpy`` /
``LiftedProblem.from_numpy``) and one mask schedule or event stream.
Tolerances, relative to the reference's largest magnitude:
  * L-BFGS objectives 1e-4 and iterates 1e-3: the two-loop recursion and
    the exact line search divide by inner products of float32 differences,
    which magnify a few ulps of difference in the gradients;
  * BCD and async objectives and iterates 1e-5: plain float32 products
    summed in another order, with no division by small differences.
Inside the port, strategies' ``times`` equal the reference's bit for bit
(the engine is a copy) and batched rows equal single runs bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.runtime as jrt
import repro_torch.core as tcore
import repro_torch.runtime as trt

M, K = 16, 12                    # tests/test_convergence.py's cluster
LBFGS_RTOL, LBFGS_W_RTOL, RTOL = 1e-4, 1e-3, 1e-5


def _rel_close(out, ref, rtol):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


def _port_problem(jp):
    return tcore.EncodedProblem.from_numpy(
        np.asarray(jp.SX), np.asarray(jp.Sy), np.asarray(jp.X),
        np.asarray(jp.y), lam=jp.lam, beta=jp.beta, n=jp.n, device="cpu")


def _ridge_problem(n=256, p=64, lam=0.05, seed=0, encoder="hadamard"):
    """tests/test_convergence.py's ridge problem, in both packages."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    y = X @ rng.standard_normal(p) + 0.1 * rng.standard_normal(n)
    enc = jcore.make_encoder(encoder, n, beta=2.0, seed=seed)
    jp = jcore.make_encoded_problem(X, y, enc, M, lam=lam)
    w_star = np.linalg.solve(X.T @ X / n + lam * np.eye(p), X.T @ y / n)
    f_star = float(jcore.original_objective(jp, jnp.asarray(w_star),
                                            h="l2"))
    return jp, _port_problem(jp), f_star


def _adversarial_masks(T):
    return np.stack([tcore.active_mask(M, A)
                     for A in tcore.adversarial_sets(M, K, T)])


def _random_masks(T, seed=0):
    return np.stack([tcore.active_mask(M, A) for _, A, _ in
                     tcore.simulate_run(tcore.bimodal_delays(), M, K, T,
                                        seed=seed)])


@pytest.fixture(scope="module")
def ridge():
    return _ridge_problem()


# ---------------------------------------------------------------------------
# encoded L-BFGS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masks_kind", ["random", "adversarial"])
def test_lbfgs_matches_reference(ridge, masks_kind):
    jp, tp, _ = ridge
    masks = (_random_masks(60, seed=3) if masks_kind == "random"
             else _adversarial_masks(60))
    jw, jtr = jcore.run_encoded_lbfgs(jp, masks, memory=10)
    tw, ttr = tcore.run_encoded_lbfgs(tp, masks, memory=10)
    assert ttr.shape == (60,) and ttr.dtype == torch.float32
    _rel_close(ttr, jtr, LBFGS_RTOL)
    _rel_close(tw, jw, LBFGS_W_RTOL)


def test_lbfgs_line_search_set_memory_and_start_match_reference(ridge):
    """A line-search schedule D_t of its own, a short memory (pairs are
    dropped) and a non-zero start."""
    jp, tp, _ = ridge
    masks_A = _random_masks(30, seed=7)
    masks_D = _random_masks(30, seed=8)
    w0 = np.random.default_rng(2).standard_normal(64).astype(np.float32)
    jw, jtr = jcore.run_encoded_lbfgs(jp, masks_A, masks_D, memory=3,
                                      rho=0.7, w0=jnp.asarray(w0))
    tw, ttr = tcore.run_encoded_lbfgs(tp, masks_A, masks_D, memory=3,
                                      rho=0.7, w0=torch.tensor(w0))
    _rel_close(ttr, jtr, LBFGS_RTOL)
    _rel_close(tw, jw, LBFGS_W_RTOL)


def test_lbfgs_state_and_direction_match_reference():
    from repro.core.lbfgs import LBFGSState as JState
    from repro.core.lbfgs import lbfgs_direction as j_direction
    rng = np.random.default_rng(0)
    js, ts = JState([], [], 3), tcore.LBFGSState([], [], 3)
    for j in range(6):
        u = rng.standard_normal(20).astype(np.float32)
        # every third pair fails the curvature safeguard (u^T r < 0)
        r = (-u if j % 3 == 2 else u + 0.1 * rng.standard_normal(20)
             ).astype(np.float32)
        js.push(jnp.asarray(u), jnp.asarray(r))
        ts.push(torch.tensor(u), torch.tensor(r))
        assert len(ts.u) == len(js.u) <= 3
    g = rng.standard_normal(20).astype(np.float32)
    _rel_close(tcore.lbfgs_direction(ts, torch.tensor(g)),
               j_direction(js, jnp.asarray(g)), RTOL)


def test_lbfgs_reuses_previous_blocks(ridge, monkeypatch):
    """The port keeps the previous step's worker gradients for the overlap
    difference where the reference recomputes them: one gradient pass a
    step instead of two.  Recomputing gives the same bits (the products
    are deterministic), so the trace is unchanged; the reference
    comparisons above hold it to the reference."""
    import repro_torch.core.lbfgs as tl
    _, tp, _ = ridge
    calls = []
    real = tl.encoded_gradients

    def counted(prob, w):
        calls.append(w)
        return real(prob, w)

    monkeypatch.setattr(tl, "encoded_gradients", counted)
    _, tr = tcore.run_encoded_lbfgs(tp, _random_masks(12, seed=4))
    assert len(calls) == 12 and torch.isfinite(tr).all()
    assert torch.equal(real(tp, calls[-2]), real(tp, calls[-2].clone()))


def test_lbfgs_thm4_linear_convergence(ridge):
    """Thm 4 on the port: the kappa-ball is reached quickly."""
    _, tp, f_star = ridge
    _, tr = tcore.run_encoded_lbfgs(tp, _random_masks(60, seed=3), memory=10)
    assert tr[-1] <= 1.05 * f_star
    assert tr[29] <= 1.2 * f_star
    _, tr = tcore.run_encoded_lbfgs(tp, _adversarial_masks(60), memory=10)
    assert tr[-1] <= 1.10 * f_star


# ---------------------------------------------------------------------------
# encoded BCD
# ---------------------------------------------------------------------------

def _lifted(phi: str, n=128, p=32, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    if phi == "logistic":
        y = np.sign(X @ rng.standard_normal(p) + 0.01)
        jpair, tpair = (jcore.phi_logistic(y),
                        tcore.phi_logistic(y, device="cpu"))
    else:
        y = X @ rng.standard_normal(p)
        jpair, tpair = (jcore.phi_quadratic(y),
                        tcore.phi_quadratic(y, device="cpu"))
    enc = jcore.hadamard_encoder(p, 2.0)
    jl = jcore.make_lifted_problem(X, enc, M, *jpair)
    tl = tcore.LiftedProblem.from_numpy(np.asarray(jl.XS), *tpair,
                                        beta=jl.beta, device="cpu")
    L = np.linalg.eigvalsh(X.T @ X / n).max()
    return jl, tl, X, y, L


@pytest.mark.parametrize("phi", ["quadratic", "logistic"])
def test_make_lifted_problem_matches_reference(phi):
    jl, _, X, y, _ = _lifted(phi)
    tpair = (tcore.phi_quadratic(y, device="cpu") if phi == "quadratic"
             else tcore.phi_logistic(y, device="cpu"))
    tl = tcore.make_lifted_problem(X, tcore.hadamard_encoder(32, 2.0), M,
                                   *tpair, device="cpu")
    assert tl.beta == jl.beta and tl.m == jl.m
    assert np.array_equal(tl.XS.numpy(), np.asarray(jl.XS))
    z = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    _rel_close(tl.phi_val(torch.tensor(z)), jl.phi_val(jnp.asarray(z)), RTOL)
    _rel_close(tl.phi_grad(torch.tensor(z)), jl.phi_grad(jnp.asarray(z)),
               RTOL)


def test_make_lifted_problem_fast_hadamard_matches_dense():
    """The fast-Hadamard encoder (SRHT kernel path) builds the same blocks
    as its dense matrix, to float32 rounding."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((64, 40))
    pair = tcore.phi_quadratic(rng.standard_normal(64), device="cpu")
    fast = tcore.FastHadamardEncoder(40, 2.0, seed=3)
    tl = tcore.make_lifted_problem(X, fast, 8, *pair, device="cpu")
    dense = tcore.make_lifted_problem(X, tcore.as_dense(fast), 8, *pair,
                                      device="cpu")
    _rel_close(tl.XS, dense.XS, RTOL)


@pytest.mark.parametrize("phi", ["quadratic", "logistic"])
def test_scan_bcd_matches_reference(phi):
    jl, tl, _, _, L = _lifted(phi)
    masks = _random_masks(50, seed=5)
    step = 2.0 if phi == "logistic" else 0.9 / (L * 2.0)
    jv, jtr = jrt.scan_bcd(jl, jnp.asarray(masks), step,
                           jnp.zeros((M, jl.XS.shape[-1])))
    tv, ttr = trt.scan_bcd(tl, masks, step, torch.zeros((M, tl.XS.shape[-1])))
    assert ttr.shape == (51,)                 # pre-commit trace + final
    _rel_close(ttr, jtr, RTOL)
    _rel_close(tv, jv, RTOL)
    _, rtr = tcore.run_encoded_bcd(tl, masks, step)
    assert torch.equal(rtr, ttr)


@pytest.mark.parametrize("phi", ["quadratic", "logistic"])
@pytest.mark.parametrize("R,eval_every", [(3, 5), (3, 1), (1, 1), (1, 10)])
def test_batched_scan_bcd_matches_reference(phi, R, eval_every):
    jl, tl, _, _, L = _lifted(phi)
    masks = np.stack([_random_masks(20, seed=s) for s in range(R)])
    step = 2.0 if phi == "logistic" else 0.9 / (L * 2.0)
    b = jl.XS.shape[-1]
    jv, jtr = jrt.batched_scan_bcd(jl, jnp.asarray(masks), step,
                                   jnp.zeros((R, M, b)),
                                   eval_every=eval_every)
    tv, ttr = trt.batched_scan_bcd(tl, masks, step, torch.zeros((R, M, b)),
                                   eval_every=eval_every)
    assert ttr.shape == (R, 20 // eval_every)   # post-commit trace
    for q in range(R):
        _rel_close(ttr[q], jtr[q], RTOL)
        _rel_close(tv[q], jv[q], RTOL)
        if eval_every == 1:
            _, single = trt.scan_bcd(tl, masks[q], step, torch.zeros((M, b)))
            assert torch.equal(ttr[q], single[1:])


def test_bcd_thm6_exact_convergence():
    """Thm 6 on the port: BCD on the lifted logistic problem descends
    monotonically to the exact optimum under adversarial erasures."""
    _, tl, _, _, _ = _lifted("logistic", n=256, p=64)
    _, tr = tcore.run_encoded_bcd(tl, _adversarial_masks(400), 2.0)
    tr = tr.numpy()
    assert tr[-1] < 0.1 * tr[0]
    assert (np.diff(tr) < 1e-6).all()


# ---------------------------------------------------------------------------
# async stale-gradient SGD
# ---------------------------------------------------------------------------

N_A, P_A = 256, 64


@pytest.fixture(scope="module")
def async_probs():
    spec = jrt.ProblemSpec.synthetic(N_A, P_A, noise=0.5, lam=0.05, seed=0)
    jp = jcore.make_encoded_problem(spec.X, spec.y,
                                    jcore.identity_encoder(N_A), M,
                                    lam=spec.lam)
    return jp, _port_problem(jp)


@pytest.mark.parametrize("h,eval_every", [("l2", 1), ("none", 8)])
def test_scan_async_matches_reference(async_probs, h, eval_every):
    jp, tp = async_probs
    tr = jrt.ClusterEngine(jcore.bimodal_delays(), M, seed=2).sample_async(
        160, staleness_bound=8)
    assert tr.staleness.max() > 0
    jw, jtr = jrt.scan_async(jp, jnp.asarray(tr.workers),
                             jnp.asarray(tr.staleness), 0.002,
                             jnp.zeros(P_A), buffer_size=9, h=h,
                             eval_every=eval_every)
    tw, ttr = trt.scan_async(tp, tr.workers, tr.staleness, 0.002,
                             torch.zeros(P_A), buffer_size=9, h=h,
                             eval_every=eval_every)
    assert ttr.shape == (160 // eval_every,)
    _rel_close(ttr, jtr, RTOL)
    _rel_close(tw, jw, RTOL)


def test_scan_async_zero_staleness_is_sequential_sgd(async_probs):
    """tests/test_runtime.py's check on the port: with staleness 0 every
    update reads the CURRENT iterate (a one-slot ring buffer)."""
    jp, tp = async_probs
    U = 64
    workers = np.random.default_rng(0).integers(0, M, size=U)
    step = 0.002
    w_dev, _ = trt.scan_async(tp, workers, np.zeros(U, np.int32), step,
                              torch.zeros(P_A), buffer_size=1, h="l2")
    jw, _ = jrt.scan_async(jp, jnp.asarray(workers), jnp.zeros(U, jnp.int32),
                           step, jnp.zeros(P_A), buffer_size=1, h="l2")
    w = np.zeros(P_A)
    SX, Sy = np.asarray(jp.SX), np.asarray(jp.Sy)
    for i in workers:
        g = SX[i].T @ (SX[i] @ w - Sy[i]) * (M / (jp.n * jp.beta))
        w = w - step * (g + jp.lam * w)
    np.testing.assert_allclose(w_dev.numpy(), w, atol=1e-5)
    _rel_close(w_dev, jw, RTOL)


def test_batched_scan_async_matches_reference(async_probs):
    jp, tp = async_probs
    R = 3
    batch = jrt.ClusterEngine(jcore.bimodal_delays(), M, seed=4
                              ).sample_asyncs(96, 6, R)
    jw, jtr = jrt.batched_scan_async(jp, jnp.asarray(batch.workers),
                                     jnp.asarray(batch.staleness), 0.002,
                                     jnp.zeros((R, P_A)), buffer_size=7,
                                     eval_every=12)
    tw, ttr = trt.batched_scan_async(tp, batch.workers, batch.staleness,
                                     0.002, torch.zeros((R, P_A)),
                                     buffer_size=7, eval_every=12)
    sw, str_, ndev = trt.sharded_scan_async(tp, batch.workers,
                                            batch.staleness, 0.002,
                                            torch.zeros((R, P_A)),
                                            buffer_size=7, eval_every=12)
    assert ndev == 1 and torch.equal(sw, tw) and torch.equal(str_, ttr)
    for q in range(R):
        _rel_close(ttr[q], jtr[q], RTOL)
        _rel_close(tw[q], jw[q], RTOL)
        w1, tr1 = trt.scan_async(tp, batch.workers[q], batch.staleness[q],
                                 0.002, torch.zeros(P_A), buffer_size=7,
                                 eval_every=12)
        assert torch.equal(tw[q], w1) and torch.equal(ttr[q], tr1)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

NS, PS, MS, KS, TS = 96, 24, 8, 6, 20

STRATEGIES = [("coded-lbfgs", {}), ("coded-lbfgs", {"encoder": "uncoded"}),
              ("coded-lbfgs", {"encoder": "replication"}),
              ("coded-lbfgs", {"encoder": "fast-hadamard", "memory": 4}),
              ("coded-bcd", {}), ("coded-bcd", {"step_size": 0.05}),
              ("async", {"staleness_bound": 6})]


def _specs():
    jspec = jrt.ProblemSpec.synthetic(NS, PS, noise=0.5, lam=0.05, seed=2)
    tspec = trt.ProblemSpec.synthetic(NS, PS, noise=0.5, lam=0.05, seed=2)
    return jspec, tspec


def _engines(seed=0, faults=None):
    return (jrt.ClusterEngine(jcore.bimodal_delays(), MS, seed=seed,
                              faults=faults),
            trt.ClusterEngine(tcore.bimodal_delays(), MS, seed=seed,
                              faults=faults))


def _strategy_rtol(name):
    return LBFGS_RTOL if name == "coded-lbfgs" else RTOL


@pytest.mark.parametrize("name,cfg", STRATEGIES)
def test_strategy_run_matches_reference(name, cfg):
    jspec, tspec = _specs()
    je, te = _engines()
    ref = jrt.get_strategy(name).run(jspec, je, steps=TS, k=KS, **cfg)
    out = trt.get_strategy(name).run(tspec, te, steps=TS, k=KS,
                                     device="cpu", **cfg)
    assert np.array_equal(out.times, ref.times)
    _rel_close(out.objective, ref.objective, _strategy_rtol(name))
    assert out.meta == ref.meta
    assert out.to_record().keys() == ref.to_record().keys()


@pytest.mark.parametrize("name,cfg", STRATEGIES)
@pytest.mark.parametrize("placement", ["vmap", "single", "sharded"])
def test_strategy_run_batched_matches_reference(name, cfg, placement):
    jspec, tspec = _specs()
    je, te = _engines(seed=3)
    ref = jrt.get_strategy(name).run_batched(
        jspec, je, steps=TS, trials=2, eval_every=5, k=KS,
        placement=placement, **cfg)
    out = trt.get_strategy(name).run_batched(
        tspec, te, steps=TS, trials=2, eval_every=5, k=KS,
        placement=placement, device="cpu", **cfg)
    assert np.array_equal(out.times, ref.times)
    for q in range(2):
        _rel_close(out.objective[q], ref.objective[q], _strategy_rtol(name))
    assert out.meta == ref.meta


@pytest.mark.parametrize("name,cfg", STRATEGIES)
def test_run_batched_realization0_equals_run(name, cfg):
    """Realization 0 of a batch is the single run on the same engine:
    times and objective bit for bit (the trace is strided at eval_every=1
    here, so whole)."""
    _, tspec = _specs()
    _, te = _engines(seed=6)
    st = trt.get_strategy(name)
    single = st.run(tspec, te, steps=TS, k=KS, device="cpu", **cfg)
    batched = st.run_batched(tspec, te, steps=TS, trials=2, k=KS,
                             device="cpu", **cfg)
    assert np.array_equal(batched.times[0], single.times)
    assert np.array_equal(batched.objective[0], single.objective)


@pytest.mark.parametrize("name", ["coded-lbfgs", "coded-bcd"])
def test_hold_degrade_rejected(name):
    chaos = "crash:p=0.3,at=0.3;blackout:p=0.3,at=0.1,dur=0.4;corrupt:p=0.1"
    _, tspec = _specs()
    _, te = _engines(faults=chaos)
    st = trt.get_strategy(name)
    with pytest.raises(ValueError, match="renormalize/backoff"):
        st.run(tspec, te, steps=8, degrade="hold", device="cpu")
    with pytest.raises(ValueError, match="renormalize/backoff"):
        st.run_batched(tspec, te, steps=8, trials=2, degrade="hold",
                       device="cpu")


def test_lbfgs_requires_ridge():
    jspec = trt.ProblemSpec.synthetic(NS, PS, h="l1", seed=2)
    _, te = _engines()
    with pytest.raises(ValueError, match="ridge"):
        trt.get_strategy("coded-lbfgs").run(jspec, te, steps=4, device="cpu")
    with pytest.raises(ValueError, match="smooth"):
        trt.get_strategy("async").run(jspec, te, steps=4, device="cpu")


def test_async_crash_and_corruption_accounting():
    """tests/test_faults.py's async accounting on the port's engine, and
    the async strategy's fault record against the reference's."""
    eng = trt.ClusterEngine(tcore.bimodal_delays(), MS, seed=0,
                            faults="crash:p=0.4,at=1.0;corrupt:p=0.1")
    tr = eng.sample_async(60, staleness_bound=8)
    assert tr.updates == 60
    assert tr.corrupted > 0
    assert tr.fault_events
    fr = eng.faults.realize(MS, eng.seed)
    for w in np.nonzero(np.isfinite(fr.crash_time))[0]:
        late = tr.times[tr.workers == w]
        assert (late <= fr.crash_time[w] + 10.0).all()
    jspec, tspec = _specs()
    je, te = _engines(faults="crash:p=0.4,at=1.0;corrupt:p=0.1")
    ref = jrt.get_strategy("async").run(jspec, je, steps=8, degrade="hold")
    out = trt.get_strategy("async").run(tspec, te, steps=8, degrade="hold",
                                        device="cpu")
    assert out.meta == ref.meta and out.meta["corrupted"] > 0
    assert np.array_equal(out.times, ref.times)
    _rel_close(out.objective, ref.objective, RTOL)


def test_async_all_crashed_raises():
    eng = trt.ClusterEngine(tcore.constant_delays(0.05), MS, seed=0,
                            faults=f"zone:workers=0-{MS - 1},at=0.5")
    with pytest.raises(ValueError, match="async cluster died"):
        eng.sample_async(500, staleness_bound=4)


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tspec = _specs()
    _, te = _engines()
    for name in ("coded-lbfgs", "coded-bcd", "async"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trt.get_strategy(name).run(tspec, te, steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.phi_quadratic(np.zeros(4))


# ---------------------------------------------------------------------------
# encoded GD and ISTA entry points (tests/test_convergence.py's cases) and
# the runners' fused / combine dispatch (REPRO_FUSED)
# ---------------------------------------------------------------------------

def _lipschitz(jp):
    X = np.asarray(jp.X, np.float64)
    return float(np.linalg.eigvalsh(X.T @ X / X.shape[0]).max())


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("masks_kind", ["adversarial", "random"])
def test_run_encoded_gd_matches_reference_and_converges(
        ridge, masks_kind, fused, monkeypatch):
    """Thm 2 on the port, on either branch of the runners' dispatch, held
    to the reference's trace."""
    jp, tp, f_star = ridge
    masks = (_adversarial_masks(200) if masks_kind == "adversarial"
             else _random_masks(200))
    step = 1.0 / (1.3 * _lipschitz(jp) + 0.05)
    jw, jtr = jcore.run_encoded_gd(jp, masks, step_size=step)
    monkeypatch.setenv("REPRO_FUSED", fused)
    tw, ttr = tcore.run_encoded_gd(tp, masks, step_size=step, device="cpu")
    assert isinstance(ttr, np.ndarray) and ttr.shape == (200,)
    assert tw.device.type == "cpu"
    _rel_close(ttr, jtr, RTOL)
    _rel_close(tw, jw, RTOL)
    assert ttr[-1] <= 1.10 * f_star
    assert ttr[-1] <= 0.05 * ttr[0] + 1.10 * f_star
    assert np.isfinite(ttr).all()


def test_run_encoded_gd_uncoded_baseline_worse_under_erasures():
    jp_c, tp_c, _ = _ridge_problem(encoder="hadamard")
    jp_u, tp_u, _ = _ridge_problem(encoder="uncoded")
    masks = _adversarial_masks(200)
    step = 1.0 / (1.3 * _lipschitz(jp_c) + 0.05)
    _, tr_c = tcore.run_encoded_gd(tp_c, masks, step_size=step,
                                   device="cpu")
    _, tr_u = tcore.run_encoded_gd(tp_u, masks, step_size=step,
                                   device="cpu")
    _, jtr_u = jcore.run_encoded_gd(jp_u, masks, step_size=step)
    _rel_close(tr_u, jtr_u, RTOL)
    assert tr_c[-1] <= tr_u[-1] + 1e-6


@pytest.mark.parametrize("fused", ["1", "0"])
def test_run_encoded_proximal_lasso_recovery_matches_reference(fused,
                                                               monkeypatch):
    """Thm 5 + §5.4 on the port: ISTA on encoded data recovers the
    support, with the reference's trace."""
    rng = np.random.default_rng(0)
    n, p, s = 256, 64, 8
    X = rng.standard_normal((n, p))
    w_true = np.zeros(p)
    w_true[:s] = rng.standard_normal(s) * 2.0
    y = X @ w_true + 0.05 * rng.standard_normal(n)
    jp = jcore.make_encoded_problem(X, y, jcore.hadamard_encoder(n, 2.0,
                                                                 seed=1),
                                    M, lam=0.1)
    tp = _port_problem(jp)
    step = 0.5 / np.linalg.eigvalsh(X.T @ X / n).max()
    masks = _adversarial_masks(300)
    jw, jtr = jcore.run_encoded_proximal(jp, masks, step_size=step)
    monkeypatch.setenv("REPRO_FUSED", fused)
    tw, ttr = tcore.run_encoded_proximal(tp, masks, step_size=step,
                                         device="cpu")
    _rel_close(ttr, jtr, RTOL)
    _rel_close(tw, jw, RTOL)
    w = tw.numpy()
    assert (np.abs(w[:s]) > 1e-3).all()
    assert (np.abs(w[s:]) > 1e-3).sum() <= 2
    assert (ttr[1:] / np.maximum(ttr[:-1], 1e-12)).max() < 2.0


def test_run_encoded_wrappers_use_the_runners(ridge):
    """tests/test_runtime.py's wrapper case: the entry points are thin
    wrappers over scan_gd / scan_prox (same bits), each matching the
    reference's wrapper."""
    jp, tp, _ = ridge
    masks = _random_masks(20, seed=5)
    w1, tr1 = tcore.run_encoded_gd(tp, masks, 0.01, device="cpu")
    w2, tr2 = trt.scan_gd(tp, masks, 0.01, torch.zeros(64), h="l2")
    assert torch.equal(w1, w2) and np.array_equal(tr1, tr2.numpy())
    _rel_close(tr1, jcore.run_encoded_gd(jp, masks, 0.01)[1], RTOL)
    w3, tr3 = tcore.run_encoded_proximal(tp, masks, 0.01, device="cpu")
    w4, tr4 = trt.scan_prox(tp, masks, 0.01, torch.zeros(64))
    assert torch.equal(w3, w4) and np.array_equal(tr3, tr4.numpy())
    _rel_close(tr3, jcore.run_encoded_proximal(jp, masks, 0.01)[1], RTOL)


def test_run_encoded_entry_points_without_device_raise_when_no_card(
        ridge, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp, _ = ridge
    masks = _random_masks(4)
    for fn in (tcore.run_encoded_gd, tcore.run_encoded_proximal):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(tp, masks, 0.01)


@pytest.mark.parametrize("value,expected", [
    (None, True), ("1", True), ("yes", True), ("0", False), ("", False),
    ("false", False), ("No", False)])
def test_fused_enabled_reads_repro_fused(value, expected, monkeypatch):
    from repro.kernels.fused_step import fused_enabled as j_enabled
    from repro_torch.kernels.fused_step import fused_enabled
    if value is None:
        monkeypatch.delenv("REPRO_FUSED", raising=False)
    else:
        monkeypatch.setenv("REPRO_FUSED", value)
        assert j_enabled() == expected       # the reference's reading
    assert fused_enabled() == expected


@pytest.mark.parametrize("kind", ["gd", "prox"])
@pytest.mark.parametrize("fused", ["1", "0"])
def test_runners_dispatch_on_fused_enabled(ridge, kind, fused, monkeypatch):
    """REPRO_FUSED=1 runs every step through the fused kernel's wrapper and
    never the unfused path; REPRO_FUSED=0 the reverse, through the coded
    combine.  Both agree with each other and name the path in the span."""
    import repro_torch.runtime.runners as tr
    from repro_torch.obs import TraceRecorder
    _, tp, _ = ridge
    masks = _random_masks(10, seed=6)
    R = 3
    batch = np.stack([_random_masks(10, seed=s) for s in range(R)])
    calls = {"fused": 0, "unfused": 0}
    real_fused, real_unfused = tr.fused_masked_gradient, tr.masked_gradient

    def fused_counted(*a, **kw):
        calls["fused"] += 1
        return real_fused(*a, **kw)

    def unfused_counted(*a, **kw):
        calls["unfused"] += 1
        return real_unfused(*a, **kw)

    monkeypatch.setattr(tr, "fused_masked_gradient", fused_counted)
    monkeypatch.setattr(tr, "masked_gradient", unfused_counted)
    monkeypatch.setenv("REPRO_FUSED", fused)
    rec = TraceRecorder()
    with rec.activate():
        if kind == "gd":
            w, t1 = trt.scan_gd(tp, masks, 0.01, torch.zeros(64))
            W, tB = trt.batched_scan_gd(tp, batch, 0.01, torch.zeros(R, 64))
        else:
            w, t1 = trt.scan_prox(tp, masks, 0.01, torch.zeros(64))
            W, tB = trt.batched_scan_prox(tp, batch, 0.01,
                                          torch.zeros(R, 64))
    names = {e.name for e in rec.events() if e.kind == "span"}
    if fused == "1":
        assert calls == {"fused": 20, "unfused": 0}
        assert f"runner:{kind}:fused" in names
    else:
        assert calls == {"fused": 0, "unfused": 10 + 10 * R}
        assert f"runner:{kind}" in names
        assert not any(n.endswith(":fused") for n in names)
    monkeypatch.setenv("REPRO_FUSED", "1" if fused == "0" else "0")
    w_other, t_other = (trt.scan_gd if kind == "gd" else trt.scan_prox)(
        tp, masks, 0.01, torch.zeros(64))
    _rel_close(t1, t_other, RTOL)
    _rel_close(w, w_other, RTOL)
    # realization 0 of the batch is the single run on its masks
    _rel_close(tB[0], (trt.scan_gd if kind == "gd" else trt.scan_prox)(
        tp, batch[0], 0.01, torch.zeros(64))[1], RTOL)


def test_fused_refusal_past_max_cols_names_the_switch():
    """Past MAX_COLS the fused kernel refuses (on the card) and its error
    says that REPRO_FUSED=0 takes the combine path; the operand check is
    reachable from the CPU."""
    from repro_torch.kernels.fused_step import MAX_COLS, _check_kernel_operands
    p = MAX_COLS + 1
    SX = torch.zeros((2, 1, p))
    with pytest.raises(ValueError, match="REPRO_FUSED=0") as err:
        _check_kernel_operands(SX, torch.zeros((2, 1)), torch.zeros((1, p)),
                               torch.ones((1, 2)))
    assert "p <=" in str(err.value) and "combine" in str(err.value)


def test_combine_path_takes_any_width_on_the_cpu(monkeypatch):
    """Under REPRO_FUSED=0 a GD run past the fused kernel's width runs on
    the combine path (the reference runs there too)."""
    from repro_torch.kernels.fused_step import MAX_COLS
    rng = np.random.default_rng(0)
    p = MAX_COLS + 1
    SX = rng.standard_normal((2, 2, p)).astype(np.float32)
    Sy = rng.standard_normal((2, 2)).astype(np.float32)
    X = rng.standard_normal((4, p)).astype(np.float32)
    tp = tcore.EncodedProblem.from_numpy(SX, Sy, X, np.ones(4), lam=0.1,
                                         beta=1.0, n=4, device="cpu")
    monkeypatch.setenv("REPRO_FUSED", "0")
    masks = np.ones((2, 2), np.float32)
    w, tr = tcore.run_encoded_gd(tp, masks, 1e-4, device="cpu")
    assert w.shape == (p,) and np.isfinite(tr).all()
