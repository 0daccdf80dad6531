"""Coded SGD in the port (``repro_torch.core.gradient_coding``,
``repro_torch.data.pipeline``'s token batchers, ``repro_torch.optim``,
``repro_torch.train``, ``repro_torch.checkpoint`` and the ``coded-sgd``
strategy) against the JAX package, on the CPU.

Tolerances:
  * bit for bit: gradient codes' assignments, coefficient matrices and
    decode weights (host numpy and float32 arithmetic in the reference's
    order), token streams and coded batches (the same numpy draws), the
    engine's simulated times, and the FRC update under two masks that keep
    one replica of every cluster (replicas compute the same bits);
  * rel 1e-5 of the largest magnitude: the first train step's loss and
    combined gradient from the same converted parameters (float32 sums in
    another order), the cosine schedule and AdamW on the same inputs;
  * rel 1e-4: losses over 5 steps, and the losses of a train cell through
    ``execute`` (AdamW's first steps move each weight by about lr whatever
    the gradient's size, so a rounding in a small gradient entry reaches
    the next losses);
  * rel 2e-5 / abs 1e-7: the FRC update under a partial mask against the
    full-mask update (``tests/test_coded_sgd.py``'s bound).
Parameters are made by the reference's ``init_params`` and carried across
with ``repro_torch.models.params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as JB
import repro.core.gradient_coding as JG
import repro.data.pipeline as JD
import repro.models.transformer as JT
import repro.optim as JO
import repro.train.coded as JC
import repro_torch.core.gradient_coding as PG
import repro_torch.data.pipeline as PD
import repro_torch.models.transformer as PT
import repro_torch.optim as PO
import repro_torch.train.coded as PC
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.models import params_from_numpy, state_from_numpy
from repro_torch.runtime import (ClusterEngine, FastestK, get_strategy,
                                 make_delay_model)
from repro_torch.runtime.faults import make_fault_model
from repro_torch.tree import tree_leaves, tree_paths

M = 8
RTOL, LOSS_RTOL = 1e-5, 1e-4
CODES = ("frc", "cyclic", "stochastic", "uncoded")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8))


def _rel(out, ref, rtol):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rtol * max(np.max(np.abs(ref)),
                                                   1e-30)


def _tiny():
    return (JC.TrainProblem(seq_len=16, vocab=64).build_cfg(),
            PC.TrainProblem(seq_len=16, vocab=64).build_cfg())


def _ref_cfg(cfg):
    """The reference's ArchConfig with the port config's fields."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["period"] = tuple(JB.BlockSpec(**dataclasses.asdict(b))
                         for b in cfg.period)
    return JB.ArchConfig(**kw)


def _reference_init(cfg, key, *, device=None):
    """The port's ``init_params`` replaced by the reference's parameters
    for the same config and seed, carried across."""
    jp = JT.init_params(_ref_cfg(cfg), jax.random.key(int(key)))
    return params_from_numpy(jax.tree.map(np.asarray, jp), device)


def _masks(m, seed, n=12):
    rng = np.random.default_rng(seed)
    out = [np.ones(m), np.zeros(m)]
    out += [(rng.random(m) < rng.uniform(0.2, 0.95)).astype(np.float64)
            for _ in range(n)]
    return out


# ---------------------------------------------------------------------------
# gradient codes: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODES)
@pytest.mark.parametrize("m,beta", [(4, 2), (8, 2), (12, 3), (16, 4),
                                    (6, 1)])
def test_codes_equal_reference_bit_for_bit(name, m, beta):
    for seed in (0, 1, 7):
        j = JG.make_code(name, m, beta=beta, seed=seed)
        p = PG.make_code(name, m, beta=beta, seed=seed)
        assert (p.codename, p.num_groups, p.stochastic) == \
            (j.codename, j.num_groups, j.stochastic)
        _bits_equal(p.worker_groups, j.worker_groups)
        _bits_equal(p.worker_coeffs, j.worker_coeffs)
        _bits_equal(PG.assignment_matrix(p), JG.assignment_matrix(j))
        for t in (0, 3):
            jt, pt = j.at_step(t), p.at_step(t)
            _bits_equal(pt.worker_groups, jt.worker_groups)
            for mask in _masks(m, seed + 10 * t):
                _bits_equal(pt.decode_weights(mask), jt.decode_weights(mask))
                _bits_equal(PG.coded_weights(pt, mask),
                            np.asarray(JG.coded_weights(jt, mask)))
                assert PG.decode_exact_possible(pt, mask) == \
                    JG.decode_exact_possible(jt, mask)
        if isinstance(j, JG.FRCode):
            _bits_equal(PG.coded_microbatch_index(p),
                        JG.coded_microbatch_index(j))


def test_frc_flake_seeds_equal_reference():
    """The seeds at which the reference's float32 FRC weights miss rtol
    1e-6 of the exact ones at beta = 3 (ROADMAP Queue 3 item 4): the port
    holds the reference's weights, flake included."""
    for seed in (42, 50, 66):
        rng = np.random.default_rng(seed)
        for m in (6, 9, 12, 15, 18, 24):
            j, p = JG.make_frc(m, 3), PG.make_frc(m, 3)
            for _ in range(20):
                mask = (rng.random(m) < 0.6).astype(np.float64)
                _bits_equal(p.decode_weights(mask), j.decode_weights(mask))


def test_make_code_registry():
    assert sorted(PG.GRADIENT_CODES) == sorted(JG.GRADIENT_CODES)
    assert PG.make_code("uncoded", M).num_groups == M
    assert PG.make_code("bernoulli", M, beta=2).stochastic
    code = PG.make_frc(M)
    assert PG.make_code(code, M) is code
    with pytest.raises(KeyError, match="frc"):
        PG.make_code("no-such-code", M)
    with pytest.raises(ValueError, match="not divisible"):
        PG.make_frc(6, 4)


def test_cyclic_decode_recovers_full_gradient():
    """Cyclic repetition: for any <= beta-1 TOTAL erasures the decode
    weights satisfy B^T a = 1, so the combined gradient equals the
    full-batch mean exactly."""
    code = PG.make_cyclic(M, beta=3, seed=0)
    rng = np.random.default_rng(0)
    g = rng.standard_normal((M, 5))
    workers = np.asarray(code.B) @ g
    for erased in [(), (2,), (6, 1)]:
        mask = np.ones(M)
        mask[list(erased)] = 0.0
        assert code.decode_exact_possible(mask)
        a = np.asarray(code.decode_weights(mask))
        assert np.all(a[list(erased)] == 0.0)
        est = (a @ workers) / code.num_groups
        np.testing.assert_allclose(est, g.mean(axis=0), rtol=1e-5,
                                   atol=1e-7)
    mask = np.ones(M)
    mask[[0, 3, 5]] = 0.0
    assert not code.decode_exact_possible(mask)
    assert np.all(np.isfinite(code.decode_weights(mask)))


# ---------------------------------------------------------------------------
# token batches: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODES)
def test_group_batcher_equals_reference(name):
    j = JG.make_code(name, M, beta=2, seed=3)
    p = PG.make_code(name, M, beta=2, seed=3)
    jb = JD.GroupBatcher(JD.TokenStream(96, seed=5), j, 2, 12, seed=5)
    pb = PD.GroupBatcher(PD.TokenStream(96, seed=5), p, 2, 12, seed=5)
    for t in range(4):
        for a, b in zip(pb.next_batch(p.at_step(t)),
                        jb.next_batch(j.at_step(t))):
            _bits_equal(a, b)


def test_token_stream_and_coded_batcher_equal_reference():
    js, ps = JD.TokenStream(200, seed=1), PD.TokenStream(200, seed=1)
    _bits_equal(ps._probs, js._probs)
    _bits_equal(ps._motifs, js._motifs)
    _bits_equal(ps.sample(np.random.default_rng(2), 7, 33),
                js.sample(np.random.default_rng(2), 7, 33))
    jb = JD.CodedBatcher(js, JG.make_frc(M, 2), 2, 16, seed=4)
    pb = PD.CodedBatcher(ps, PG.make_frc(M, 2), 2, 16, seed=4)
    for mask in _masks(M, 9, n=4):
        for a, b in zip(pb.next_batch(mask), jb.next_batch(mask)):
            _bits_equal(a, b)


def test_coded_batcher_replica_consistency():
    b = PD.CodedBatcher(PD.TokenStream(128, seed=0), PG.make_frc(8, 2),
                        rows_per_worker=2, seq_len=16)
    toks, labels, w = b.next_batch(np.ones(8))
    assert toks.shape == (16, 16) and labels.shape == (16, 16)
    np.testing.assert_array_equal(labels[:, :-1], toks[:, 1:])
    t = toks.reshape(8, 2, 16)
    for i in range(4):
        np.testing.assert_array_equal(t[i], t[i + 4])
    np.testing.assert_allclose(w, 0.5)


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def test_adamw_and_schedule_match_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}
    mk = lambda s: jax.tree.map(  # noqa: E731
        lambda sh: rng.standard_normal(sh).astype(np.float32), s,
        is_leaf=lambda x: isinstance(x, tuple))
    params, grads = mk(shapes), mk(shapes)
    jlr, plr = JO.cosine_schedule(1e-2, 3, 10), PO.cosine_schedule(1e-2, 3,
                                                                   10)
    for step in (0, 2, 3, 7, 12):
        _rel(plr(torch.tensor(step, dtype=torch.int32)), jlr(step), RTOL)
    jp, js = params, JO.adamw_init(params)
    pp = params_from_numpy(params, "cpu")
    ps = PO.adamw_init(pp)
    for step in range(3):
        g = jax.tree.map(lambda x: x * (step + 1), grads)
        jp, js, jm = JO.adamw_update(g, js, jp, lr=jlr(js.count))
        pp, ps, pm = PO.adamw_update(params_from_numpy(g, "cpu"), ps, pp,
                                     lr=plr(ps.count))
        _rel(pm["grad_norm"], jm["grad_norm"], RTOL)
        assert int(ps.count) == int(js.count) == step + 1
        for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
            _rel(a, b, RTOL)
        for a, b in zip(tree_leaves(ps.v), jax.tree_util.tree_leaves(js.v)):
            _rel(a, b, RTOL)


# ---------------------------------------------------------------------------
# the coded train step against the reference
# ---------------------------------------------------------------------------

def _steps(code_name):
    jcfg, pcfg = _tiny()
    j, p = JG.make_code(code_name, M, 2), PG.make_code(code_name, M, 2)
    kw = dict(rows_per_group=1, num_groups=j.num_groups)
    jstep = JC.build_coded_train_step(jcfg, JO.cosine_schedule(1e-3, 2, 10),
                                      **kw)
    pstep = PC.build_coded_train_step(pcfg, PO.cosine_schedule(1e-3, 2, 10),
                                      **kw)
    jp = JT.init_params(jcfg, jax.random.key(0))
    jo = JO.adamw_init(jp)
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    po = state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    jb = JD.GroupBatcher(JD.TokenStream(64, seed=0), j, 1, 16, seed=0)
    pb = PD.GroupBatcher(PD.TokenStream(64, seed=0), p, 1, 16, seed=0)
    return (j, jstep, jp, jo, jb), (p, pstep, pp, po, pb)


def test_first_step_loss_and_combined_gradient_match_reference(
        monkeypatch):
    got = {}
    jcall, pcall = JC.coded_combine_call, PC.coded_combine_call
    monkeypatch.setattr(JC, "coded_combine_call", lambda g, c: got.setdefault(
        "j", (g, jcall(g, c)))[1])
    monkeypatch.setattr(PC, "coded_combine_call", lambda g, c: got.setdefault(
        "p", (g, pcall(g, c)))[1])
    (j, jstep, jp, jo, jb), (p, pstep, pp, po, pb) = _steps("frc")
    mask = np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float64)
    jt, jl, jc = jb.next_batch()
    pt, pl, pc = pb.next_batch()
    d = p.decode_weights(mask)
    # the reference's block and combined gradient leave its compiled step
    # as extra outputs of the same trace
    (_, _, jm), got["j"] = jax.jit(lambda *a: (jstep(*a), got["j"]))(
        jp, jo, jnp.asarray(jt), jnp.asarray(jl), jnp.asarray(jc),
        jnp.asarray(d))
    _, _, pm = pstep(pp, po, torch.from_numpy(pt), torch.from_numpy(pl),
                     torch.from_numpy(pc), torch.from_numpy(d))
    _rel(pm["loss"], jm["loss"], RTOL)
    _rel(got["p"][0], got["j"][0], RTOL)          # the (m, P_total) block
    _rel(got["p"][1], got["j"][1], RTOL)          # the combined gradient
    assert tuple(got["p"][0].shape) == (M, PT.count_params(
        PC.TrainProblem(seq_len=16, vocab=64).build_cfg()))


@pytest.mark.parametrize("code_name", ["frc", "cyclic", "stochastic"])
def test_five_step_losses_match_reference(code_name):
    (j, jstep, jp, jo, jb), (p, pstep, pp, po, pb) = _steps(code_name)
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(1)
    jl_, pl_ = [], []
    for t in range(5):
        jt, jl, jc = jb.next_batch(j.at_step(t))
        pt, pl, pc = pb.next_batch(p.at_step(t))
        mask = (rng.random(M) < 0.75).astype(np.float64)
        d = p.at_step(t).decode_weights(mask)
        jp, jo, jm = jstep(jp, jo, jnp.asarray(jt), jnp.asarray(jl),
                           jnp.asarray(jc), jnp.asarray(d))
        pp, po, pm = pstep(pp, po, torch.from_numpy(pt),
                           torch.from_numpy(pl), torch.from_numpy(pc),
                           torch.from_numpy(d))
        jl_.append(float(jm["loss"]))
        pl_.append(float(pm["loss"]))
    _rel(pl_, jl_, LOSS_RTOL)


def test_frc_step_exact_under_per_cluster_erasures():
    """FRC (beta=2): any erasure pattern leaving >=1 survivor per cluster
    yields the identical update — bit for bit across patterns (the
    surviving replica computed the same rows), and equal to the full-mask
    update within float32 tolerance."""
    _, cfg = _tiny()
    code = PG.make_frc(M, 2)
    tokens, labels, coeff = PD.GroupBatcher(
        PD.TokenStream(cfg.vocab, seed=0), code, 1, 16, seed=0).next_batch()
    step = PC.build_coded_train_step(
        cfg, PO.cosine_schedule(1e-3, 2, 10), rows_per_group=1,
        num_groups=code.num_groups)
    params = PT.init_params(cfg, 0, device="cpu")
    opt = PO.adamw_init(params)
    args = (torch.from_numpy(tokens), torch.from_numpy(labels),
            torch.from_numpy(coeff))
    outs = {}
    for name, mask in [("a", [1, 1, 1, 1, 0, 0, 0, 0]),
                       ("b", [0, 0, 0, 0, 1, 1, 1, 1]),
                       ("full", [1] * M)]:
        mask = np.asarray(mask, np.float64)
        assert code.decode_exact_possible(mask)
        d = torch.from_numpy(code.decode_weights(mask))
        p, _, met = step(params, opt, *args, d)
        outs[name] = ([x.numpy() for x in tree_leaves(p)],
                      float(met["loss"]))
    for la, lb in zip(outs["a"][0], outs["b"][0]):
        np.testing.assert_array_equal(la, lb)
    assert outs["a"][1] == outs["b"][1]
    for la, lf in zip(outs["a"][0], outs["full"][0]):
        np.testing.assert_allclose(la, lf, rtol=2e-5, atol=1e-7)
    assert outs["a"][1] == pytest.approx(outs["full"][1], rel=1e-5)


def test_step_leaves_its_inputs_unchanged():
    _, cfg = _tiny()
    code = PG.make_frc(M, 2)
    batch = PD.GroupBatcher(PD.TokenStream(cfg.vocab), code, 1,
                            16).next_batch()
    step = PC.build_coded_train_step(cfg, PO.cosine_schedule(1e-3, 1, 5),
                                     rows_per_group=1, num_groups=4)
    params = PT.init_params(cfg, 0, device="cpu")
    opt = PO.adamw_init(params)
    before = [x.clone() for x in tree_leaves((params, opt))]
    new, new_opt, _ = step(params, opt,
                           *(torch.from_numpy(a) for a in batch),
                           torch.from_numpy(code.decode_weights(np.ones(M))))
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves((params, opt))))
    assert not torch.equal(new["embed"], params["embed"])
    assert int(new_opt.count) == 1 and not any(
        x.requires_grad for x in tree_leaves((new, new_opt)))


def test_step_refuses_patch_and_encoder_inputs():
    cfg = PC.TrainProblem(arch="whisper-small").build_cfg()
    with pytest.raises(ValueError, match="token-only"):
        PC.build_coded_train_step(cfg, PO.cosine_schedule(1e-3, 1, 5),
                                  rows_per_group=1, num_groups=4)


# ---------------------------------------------------------------------------
# trainer, strategy, experiments
# ---------------------------------------------------------------------------

def test_coded_trainer_runs_off_engine_schedule():
    _, cfg = _tiny()
    tcfg = PC.TrainerConfig(m_workers=M, beta=2, wait_k=6,
                            rows_per_worker=1, seq_len=16, steps=3, lr=1e-3,
                            warmup=1, log_every=0)
    eng = ClusterEngine(make_delay_model("bimodal"), M, seed=1,
                        faults=make_fault_model("preset:ec2-tail"))
    tr = PC.CodedTrainer(cfg, tcfg, eng, policy=FastestK(6), device="cpu")
    _, _, hist = tr.run()
    assert len(hist) == 3
    assert all(np.isfinite(h["loss"]) for h in hist)
    times = [h["sim_time_s"] for h in hist]
    assert times == sorted(times)
    assert tr.last_schedule is not None
    assert [h["active"] for h in hist] == \
        [int(m.sum()) for m in np.asarray(tr.last_schedule.masks) > 0]
    assert all(h["compiles"] == 0 and h["host_s"] >= h["execute_s"] > 0
               for h in hist)


def test_trainer_loss_decreases():
    from repro_torch.configs import ARCHS
    from repro_torch.core import bimodal_delays
    from repro_torch.train import Trainer, TrainerConfig
    cfg = ARCHS["deepseek-7b"].smoke_variant().with_overrides(
        n_layers=2, vocab=256)
    tcfg = TrainerConfig(m_workers=4, beta=2, wait_k=3, rows_per_worker=2,
                         seq_len=32, steps=25, lr=3e-3, warmup=5,
                         log_every=0)
    tr = Trainer(cfg, tcfg, delay_model=bimodal_delays(), device="cpu")
    _, _, hist = tr.run()
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert hist[-1]["sim_time_s"] > 0


def test_run_coded_sgd_strategy_surface():
    spec = PC.TrainProblem(seq_len=16, vocab=64)
    eng = ClusterEngine(make_delay_model("bimodal"), M, seed=0)
    res = get_strategy("coded-sgd").run(spec, eng, steps=2, k=6,
                                        code="stochastic", warmup=1,
                                        device="cpu")
    assert res.strategy == "coded-sgd"
    assert len(res.objective) == 2 and np.all(np.isfinite(res.objective))
    assert res.meta["code"] == "stochastic"
    assert res.meta["exact_fraction"] == 0.0
    with pytest.raises(ValueError, match="unknown coded-sgd config"):
        PC.run_coded_sgd(spec, eng, steps=2, nonsense=1, device="cpu")


@pytest.mark.parametrize("code", ["frc", "cyclic"])
def test_strategy_run_matches_reference(monkeypatch, code):
    """The whole strategy from the reference's parameters: times and
    schedule bit for bit, losses rel 1e-4, meta equal apart from timing."""
    from repro.runtime import ClusterEngine as JEngine, get_strategy as jget
    monkeypatch.setattr(PT, "init_params", _reference_init)
    kw = dict(steps=4, k=6, code=code, warmup=1)
    ref = jget("coded-sgd").run(
        JC.TrainProblem(seq_len=16, vocab=64),
        JEngine(make_delay_model("bimodal"), M, seed=2), **kw)
    out = get_strategy("coded-sgd").run(
        PC.TrainProblem(seq_len=16, vocab=64),
        ClusterEngine(make_delay_model("bimodal"), M, seed=2),
        device="cpu", **kw)
    _bits_equal(out.times, ref.times)
    _bits_equal(out.schedule.masks, ref.schedule.masks)
    _rel(out.objective, ref.objective, LOSS_RTOL)
    timing = {"host_s", "compile_s", "compiles"}
    assert {k: v for k, v in out.meta.items() if k not in timing} == \
        {k: v for k, v in ref.meta.items() if k not in timing}


def test_run_batched_stacks_trials():
    spec = PC.TrainProblem(seq_len=16, vocab=64)
    eng = ClusterEngine(make_delay_model("bimodal"), M, seed=0)
    res = get_strategy("coded-sgd").run_batched(
        spec, eng, steps=2, trials=2, eval_every=1, k=6, device="cpu")
    assert res.objective.shape == (2, 2) and res.times.shape == (2, 2)
    assert res.meta["trials"] == 2 and res.meta["batched"] is False
    assert not np.array_equal(res.times[0], res.times[1])


def test_experiments_train_cell_plan_and_execute(tmp_path, monkeypatch):
    from repro_torch.experiments.execute import execute
    from repro_torch.experiments.plan import plan
    from repro_torch.experiments.spec import (DelayAxis, ExperimentSpec,
                                              ObsAxis, PlacementAxis,
                                              ProblemAxis, StrategyAxis,
                                              TrialsAxis)
    monkeypatch.setenv("REPRO_RUNSTORE", str(tmp_path / "store"))
    spec = ExperimentSpec(
        problems=(ProblemAxis.train("deepseek-7b", seq_len=16, vocab=64),),
        strategies=(StrategyAxis(name="coded-sgd", k=6,
                                 options=(("code", "cyclic"),
                                          ("warmup", 1))),
                    StrategyAxis(name="uncoded", k=M),
                    StrategyAxis(name="coded-gd")),
        delays=DelayAxis(delays=("bimodal",), m=M),
        trials=TrialsAxis(trials=1, eval_every=1, seed=0),
        placement=PlacementAxis(mode="single"),
        steps=2, obs=ObsAxis())
    pl = plan(spec)
    assert len(pl.cells) == 3
    skips = {c.resolved_strategy: c.skip for c in pl.cells}
    assert skips["coded-sgd"] is None and skips["uncoded"] is None
    assert "train-kind" in skips["coded-gd"]
    result = execute(pl, device="cpu")
    recs = {r["strategy"]: r for r in result.records}
    assert "skipped" in recs["coded-gd"]
    for name, code in [("coded-sgd", "cyclic"), ("uncoded", "uncoded")]:
        rec = recs[name]
        assert rec["metric_name"] == "loss"
        assert np.isfinite(rec["final_metric"])
        assert rec["meta"]["code"] == code
    assert result.run_id is not None
    assert (tmp_path / "store" / result.run_id / "manifest.json").exists()


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = PC.TrainProblem(seq_len=16, vocab=64)
    eng = ClusterEngine(make_delay_model("bimodal"), M, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_strategy("coded-sgd").run(spec, eng, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.CodedTrainer(spec.build_cfg(), PC.TrainerConfig(steps=1), eng)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, dtype):
    _, cfg = _tiny()
    cfg = cfg.with_overrides(param_dtype=dtype)
    params = PT.init_params(cfg, 3, device="cpu")
    opt = PO.adamw_init(params)
    opt = opt._replace(count=opt.count + 5)
    assert latest_step(str(tmp_path)) is None
    save(str(tmp_path), 3, (params, opt))
    save(str(tmp_path), 7, (params, opt))
    assert latest_step(str(tmp_path)) == 7
    like = (PT.init_params(cfg, 4, device="cpu"), PO.adamw_init(params))
    p2, o2 = restore(str(tmp_path), 3, like)
    assert isinstance(o2, PO.AdamWState) and int(o2.count) == 5
    for a, b in zip(tree_leaves((params, opt)), tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(tmp_path / "step_3.npz") as data:
        n = len(tree_leaves((params, opt)))
        assert sorted(data.files) == sorted(f"leaf_{i}" for i in range(n))
    with pytest.raises(ValueError, match="leaves"):
        restore(str(tmp_path), 3, params)


def test_checkpoint_leaf_order_equals_reference(tmp_path):
    """The port's npz holds the reference's leaves in the reference's order
    for the same (params, opt) tree."""
    from repro.checkpoint import save as jsave
    jcfg, _ = _tiny()
    jp = JT.init_params(jcfg, jax.random.key(0))
    jo = JO.adamw_init(jp)
    jsave(str(tmp_path / "j"), 1, (jp, jo))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    po = state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    save(str(tmp_path / "p"), 1, (pp, po))
    with np.load(tmp_path / "j" / "step_1.npz") as a, \
            np.load(tmp_path / "p" / "step_1.npz") as b:
        assert a.files == b.files
        for f in a.files:
            _bits_equal(b[f], a[f])


def test_trainer_checkpoints_through_its_config(tmp_path):
    _, cfg = _tiny()
    tcfg = PC.TrainerConfig(m_workers=M, steps=4, seq_len=16, log_every=0,
                            checkpoint_dir=str(tmp_path),
                            checkpoint_every=2)
    eng = ClusterEngine(make_delay_model("bimodal"), M, seed=0)
    tr = PC.CodedTrainer(cfg, tcfg, eng, device="cpu")
    params, opt, _ = tr.run()
    assert latest_step(str(tmp_path)) == 4
    p2, o2 = restore(str(tmp_path), 4, (params, opt))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((params, opt)), tree_leaves((p2, o2))))
    assert [p for p, _ in tree_paths(p2)] == [p for p, _ in
                                              tree_paths(params)]
