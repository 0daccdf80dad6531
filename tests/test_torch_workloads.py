"""The port's workload zoo (``repro_torch.workloads``) and the data and
config pieces it needs, against the JAX package's ``repro.workloads``, on
the CPU, plus the reference's own end-to-end properties on the port.

Both packages build each workload's ``smoke`` preset from the same seeded
numpy generators and draw from the same engine seed.  The reference runs
its kernels as its own CPU tests run them.  Tolerances:
  * bit for bit: the data generators, the ground-truth scorer, the dense
    and block-diagonal streaming encode, every ``times`` trace and MF's
    active sets (host numpy copied into the port);
  * rel 1e-5 of the reference's largest magnitude: GD / ISTA / BCD
    objective traces and LASSO iterates (float32 sums in another order),
    and the fast-Hadamard streaming encode (float32 butterflies);
  * rel 1e-4: ``coded-lbfgs`` traces and MF's objective and RMSE (the
    two-loop recursion divides by inner products of float32 differences);
    ridge suboptimality gaps to abs 1e-4 |f*|;
  * equal: LASSO support F1 and logistic test error at every record.
"""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.runtime as jrt
import repro.workloads as jwl
from repro.configs import paper_native as jcfg
from repro.workloads import base as jbase

import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.runtime as trt
import repro_torch.workloads as twl
from repro_torch.configs import paper_native as tcfg
from repro_torch.workloads import base as tbase

RTOL, LBFGS_RTOL = 1e-5, 1e-4
SRC = Path(__file__).resolve().parents[1] / "src"
tgt, jgt = twl.ground_truth, jwl.ground_truth


def _rel_close(out, ref, rtol=RTOL):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rtol * max(np.max(np.abs(ref)), 1e-30)


def _bitwise(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.array_equal(out, ref)


@functools.lru_cache(maxsize=None)
def _pair(workload: str, strategy: str, encoder: str | None = None):
    """(reference, port) results of one smoke cell, default engines."""
    cfg = {} if encoder is None else {"encoder": encoder}
    ref = jwl.get_workload(workload).run(strategy, preset="smoke", **cfg)
    out = twl.get_workload(workload).run(strategy, preset="smoke",
                                         device="cpu", **cfg)
    return ref, out


def _full_participation_engine(m: int):
    return trt.ClusterEngine(tcore.constant_delays(0.1), m, seed=0)


# ---------------------------------------------------------------------------
# Configs, registry, presets
# ---------------------------------------------------------------------------

def test_paper_problems_equal_reference():
    assert tcfg.PAPER_PROBLEMS.keys() == jcfg.PAPER_PROBLEMS.keys()
    for name, cfg in tcfg.PAPER_PROBLEMS.items():
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(jcfg.PAPER_PROBLEMS[name])


def test_registry_round_trip():
    names = twl.available_workloads()
    assert names == ["lasso", "logistic", "mf", "ridge"]
    assert names == jwl.available_workloads()
    for name in names:
        wl, ref = twl.get_workload(name), jwl.get_workload(name)
        assert isinstance(wl, twl.Workload)
        assert wl.name == name
        assert wl.metric_name != "?"
        assert (wl.metric_name, wl.metric_goal, wl.canonical_coded) == \
            (ref.metric_name, ref.metric_goal, ref.canonical_coded)
        assert {"smoke", "bench", "paper"} <= set(wl.presets)
        assert {k: dataclasses.asdict(p) for k, p in wl.presets.items()} == \
            {k: dataclasses.asdict(p) for k, p in ref.presets.items()}
        assert dataclasses.asdict(wl.paper_config) == \
            dataclasses.asdict(ref.paper_config)
        # the 'coded' alias resolves to a workload-specific coded scheme
        assert wl.resolve_strategy("coded") == wl.canonical_coded
        assert wl.supports(wl.canonical_coded) is None


def test_registry_unknown_raises():
    with pytest.raises(KeyError, match="unknown workload"):
        twl.get_workload("nope")


@pytest.mark.parametrize("name", ["lasso", "logistic", "mf", "ridge"])
def test_skip_reasons_match_reference(name):
    wl, ref = twl.get_workload(name), jwl.get_workload(name)
    for strategy in trt.available_strategies() + ["coded"]:
        assert wl.skip_reason(strategy) == ref.skip_reason(strategy)
    # the strategy lists differ by coded SGD (not ported yet), so a typo's
    # message does too, past its first words
    assert wl.skip_reason("coded-lbgfs").startswith(
        "unknown strategy 'coded-lbgfs'")


def test_unsupported_strategy_carries_reason():
    with pytest.raises(twl.UnsupportedStrategy, match="l1"):
        twl.get_workload("ridge").run("coded-prox", preset="smoke",
                                      device="cpu")


def test_paper_presets_match_published_dims():
    # the 'paper' preset is configs.paper_native verbatim
    ridge = twl.get_workload("ridge")
    assert ridge.presets["paper"].dims["n"] == ridge.paper_config.n == 4096
    assert ridge.presets["paper"].dims["p"] == ridge.paper_config.p == 6000
    assert ridge.presets["paper"].m == ridge.paper_config.m == 32
    for name in ("lasso", "logistic"):
        wl = twl.get_workload(name)
        assert wl.presets["paper"].dims["n"] == wl.paper_config.n
        assert wl.presets["paper"].dims["p"] == wl.paper_config.p
        assert wl.presets["paper"].m == wl.paper_config.m
    mf = twl.get_workload("mf")
    assert mf.presets["paper"].m == mf.paper_config.m == 24


def test_sub_engine_and_chunk_sizes_match_reference():
    je = jrt.ClusterEngine(jcore.bimodal_delays(), 8, seed=3)
    te = trt.ClusterEngine(tcore.bimodal_delays(), 8, seed=3)
    for tag in (0, 1, 7):
        js, ts = jbase.sub_engine(je, tag), tbase.sub_engine(te, tag)
        assert ts.seed == js.seed == 3 + 7919 * (tag + 1)
        a = js.sample_schedule(5, jrt.FastestK(6))
        b = ts.sample_schedule(5, trt.FastestK(6))
        _bitwise(b.masks, a.masks)
        _bitwise(b.times, a.times)
    for steps, records in ((240, 8), (10, 3), (5, 9), (7, 0)):
        assert tbase.chunk_sizes(steps, records) == \
            jbase.chunk_sizes(steps, records)


# ---------------------------------------------------------------------------
# Data generators and the ground-truth scorer: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 600), (100, 300), (4000, 4200),
                                   (50, 50)])
def test_logreg_rows_bitwise(lo, hi):
    kw = dict(density=0.2, noise=0.3, seed=3)
    for a, b in zip(tdata.logreg_rows(lo, hi, 24, **kw),
                    jdata.logreg_rows(lo, hi, 24, **kw)):
        _bitwise(a, b)


def test_logreg_dataset_and_mf_ratings_bitwise():
    for a, b in zip(tdata.logreg_dataset(300, 16, noise=0.7, seed=1),
                    jdata.logreg_dataset(300, 16, noise=0.7, seed=1)):
        _bitwise(a, b)
    for a, b in zip(tdata.mf_ratings_dataset(600, 40, rank=3, density=0.2,
                                             seed=5),
                    jdata.mf_ratings_dataset(600, 40, rank=3, density=0.2,
                                             seed=5)):
        _bitwise(a, b)


def test_logreg_rows_chunk_deterministic():
    X, labels, w = tdata.logreg_dataset(600, 24, seed=3)
    Xs, ls, ws = tdata.logreg_rows(100, 300, 24, seed=3)
    np.testing.assert_allclose(Xs, X[100:300])
    np.testing.assert_allclose(ls, labels[100:300])
    np.testing.assert_allclose(ws, w)
    assert set(np.unique(labels)) <= {-1.0, 1.0}
    rownorms = np.linalg.norm(X, axis=1)
    np.testing.assert_allclose(rownorms[rownorms > 1e-6], 1.0, atol=1e-9)


def test_mf_ratings_prefix_stable_and_split_disjoint():
    R1, tr1, te1 = tdata.mf_ratings_dataset(40, 30, rank=3, density=0.3,
                                            seed=5)
    R2, tr2, te2 = tdata.mf_ratings_dataset(64, 30, rank=3, density=0.3,
                                            seed=5)
    np.testing.assert_allclose(R2[:40], R1)
    np.testing.assert_array_equal(tr2[:40], tr1)
    assert not (tr1 & te1).any()
    assert R1.min() >= 1.0 and R1.max() <= 5.0


@pytest.mark.parametrize("encoder", ["hadamard", "block-diagonal",
                                     "fast-hadamard"])
def test_stream_worker_blocks_match_reference(encoder):
    n, q, m = 96, 5, 4
    kw = {"device": "cpu"} if encoder == "fast-hadamard" else {}
    tenc = tcore.make_encoder(encoder, n, beta=2.0, seed=2, **kw)
    jenc = jcore.make_encoder(encoder, n, beta=2.0, seed=2)

    def rows(lo, hi):
        X, y, _ = tdata.lsq_rows(lo, hi, q - 1, seed=4)
        return np.concatenate([X, y[:, None]], axis=1)

    out = list(tdata.stream_worker_blocks(tenc, m, rows))
    ref = list(jdata.stream_worker_blocks(jenc, m, rows))
    assert [i for i, _ in out] == [i for i, _ in ref] == list(range(m))
    for (_, b), (_, rb) in zip(out, ref):
        assert isinstance(b, np.ndarray)
        if encoder == "fast-hadamard":       # float32 butterflies
            _rel_close(b, rb)
        else:
            _bitwise(b, rb)


def _gt_cases():
    X, y, w_true = tdata.lsq_dataset(128, 24, noise=0.5, sparse=6, seed=0)
    Xl, labels, _ = tdata.logreg_dataset(200, 12, noise=0.3, seed=0)
    R, train, test = tdata.mf_ratings_dataset(30, 20, rank=2, density=0.4,
                                              seed=1)
    w = np.random.default_rng(0).standard_normal(24)
    wl = np.random.default_rng(1).standard_normal(12)
    pred = R + np.random.default_rng(2).standard_normal(R.shape) * 0.3
    return {
        "ridge_objective": ((X, y, 0.05, w), {}),
        "ridge_solution": ((X, y, 0.05), {}),
        "lasso_objective": ((X, y, 0.05, w), {}),
        "lasso_fista": ((X, y, 0.05), {"iters": 300}),
        "support_f1": ((w * (np.abs(w) > 1.0), w_true), {}),
        "logistic_objective": ((Xl, labels, wl), {}),
        "logistic_newton": ((Xl, labels), {}),
        "classification_error": ((Xl, labels, wl), {}),
        "masked_rmse": ((pred, R, train), {}),
        "als_reference": ((R, train, test), {"rank": 2, "epochs": 2}),
    }


@pytest.mark.parametrize("fn", sorted(_gt_cases()))
def test_ground_truth_bitwise(fn):
    assert tgt.__all__ == jgt.__all__ and fn in tgt.__all__
    args, kw = _gt_cases()[fn]
    out = getattr(tgt, fn)(*args, **kw)
    ref = getattr(jgt, fn)(*args, **kw)
    if isinstance(ref, tuple):
        assert out == ref
    else:
        _bitwise(out, ref)


def test_ridge_ground_truth_is_stationary():
    X, y, _ = tdata.lsq_dataset(128, 32, noise=0.5, seed=0)
    w = tgt.ridge_solution(X, y, 0.05)
    grad = X.T @ (X @ w - y) / 128 + 0.05 * w
    assert np.abs(grad).max() < 1e-8


def test_lasso_fista_beats_planted_signal_objective():
    X, y, w_true = tdata.lsq_dataset(256, 64, noise=0.3, sparse=8, seed=0)
    w = tgt.lasso_fista(X, y, 0.05)
    assert tgt.lasso_objective(X, y, 0.05, w) <= \
        tgt.lasso_objective(X, y, 0.05, w_true) + 1e-9
    assert tgt.support_f1(w_true, w_true) == pytest.approx(1.0)


def test_logistic_newton_is_stationary():
    X, labels, _ = tdata.logreg_dataset(256, 32, noise=0.3, seed=0)
    w = tgt.logistic_newton(X, labels)
    z = X @ w
    s = 1.0 / (1.0 + np.exp(labels * z))
    grad = -(X.T @ (labels * s)) / X.shape[0]
    assert np.abs(grad).max() < 1e-6


@pytest.mark.parametrize("name", ["lasso", "logistic", "mf", "ridge"])
def test_build_equals_reference_bitwise(name):
    out = twl.get_workload(name).build("smoke")
    ref = jwl.get_workload(name).build("smoke")
    for field in dataclasses.fields(ref):
        a, b = getattr(out, field.name), getattr(ref, field.name)
        if field.name == "spec":
            _bitwise(a.X, b.X)
            _bitwise(a.y, b.y)
            assert (a.lam, a.h) == (b.lam, b.h)
        else:
            _bitwise(a, b)


# ---------------------------------------------------------------------------
# Port equals reference, end to end at the smoke preset
# ---------------------------------------------------------------------------

def _common(out, ref):
    _bitwise(out.times, ref.times)
    _bitwise(out.metric_times, ref.metric_times)
    assert (out.workload, out.strategy, out.preset, out.metric_name) == \
        (ref.workload, ref.strategy, ref.preset, ref.metric_name)
    assert out.meta.keys() == ref.meta.keys()
    rec, rref = out.to_record(), ref.to_record()
    assert rec.keys() == rref.keys()
    assert json.loads(json.dumps(rec)).keys() == rref.keys()


@pytest.mark.parametrize("strategy,encoder,rtol", [
    ("coded", None, LBFGS_RTOL), ("coded", "fast-hadamard", LBFGS_RTOL),
    ("uncoded", None, RTOL), ("replication", None, RTOL)])
def test_ridge_matches_reference(strategy, encoder, rtol):
    ref, out = _pair("ridge", strategy, encoder)
    _common(out, ref)
    _rel_close(out.objective, ref.objective, rtol)
    f_star = ref.meta["f_star"]
    assert out.meta["f_star"] == f_star
    assert np.max(np.abs(out.metric - ref.metric)) <= 1e-4 * abs(f_star)


@pytest.mark.parametrize("strategy,eval_every,rtol", [
    ("coded", 1, LBFGS_RTOL), ("replication", 5, RTOL)])
def test_ridge_run_trials_matches_reference(strategy, eval_every, rtol):
    R = 3
    ref = jwl.get_workload("ridge").run_trials(
        strategy, preset="smoke", trials=R, eval_every=eval_every)
    out = twl.get_workload("ridge").run_trials(
        strategy, preset="smoke", trials=R, eval_every=eval_every,
        device="cpu")
    assert len(out) == len(ref) == R
    for o, r in zip(out, ref):
        _common(o, r)
        _rel_close(o.objective, r.objective, rtol)
        assert np.max(np.abs(o.metric - r.metric)) <= \
            1e-4 * abs(r.meta["f_star"])
    # realization 0 replays the single run's schedule
    single = _pair("ridge", strategy)[1]
    _bitwise(out[0].times, single.times[eval_every - 1::eval_every])
    _bitwise(out[0].objective, single.objective[eval_every - 1::eval_every])


def test_sequential_run_trials_matches_reference():
    """The chunked lowerings run realization r on ``engine.trial(r)``."""
    ref = jwl.get_workload("logistic").run_trials("coded", preset="smoke",
                                                  trials=2)
    out = twl.get_workload("logistic").run_trials("coded", preset="smoke",
                                                  trials=2, device="cpu")
    assert len(out) == len(ref) == 2
    assert not np.array_equal(out[0].times, out[1].times)
    for o, r in zip(out, ref):
        _common(o, r)
        _rel_close(o.objective, r.objective)
        _bitwise(o.metric, r.metric)


def test_lasso_matches_reference():
    ref, out = _pair("lasso", "coded")
    _common(out, ref)
    _rel_close(out.objective, ref.objective)
    _bitwise(out.metric, ref.metric)              # F1 at every record
    _rel_close(out.w, ref.w)


def test_lasso_chunked_iterates_match_reference():
    """Every record's iterate of the chunked coded-prox run."""
    ps = twl.get_workload("lasso").presets["smoke"]
    tdata_ = twl.get_workload("lasso").build("smoke")
    jdata_ = jwl.get_workload("lasso").build("smoke")
    kw = dict(steps=ps.steps, records=ps.dims["records"], k=ps.k,
              step_size=1.0 / (1.3 * tdata_.lipschitz + ps.lam))
    te = twl.get_workload("lasso").default_engine("smoke")
    je = jwl.get_workload("lasso").default_engine("smoke")
    t_times, t_obj, t_recs, _ = tbase.run_strategy_chunked(
        "coded-prox", tdata_.spec, te, device="cpu", **kw)
    j_times, j_obj, j_recs, _ = jbase.run_strategy_chunked(
        "coded-prox", jdata_.spec, je, **kw)
    _bitwise(t_times, j_times)
    _rel_close(t_obj, j_obj)
    assert len(t_recs) == len(j_recs) == ps.dims["records"]
    for (tt, tw), (jt, jw) in zip(t_recs, j_recs):
        assert tt == jt
        assert isinstance(tw, np.ndarray)
        _rel_close(tw, jw)


@pytest.mark.parametrize("encoder", [None, "fast-hadamard"])
def test_logistic_matches_reference(encoder):
    ref, out = _pair("logistic", "coded", encoder)
    _common(out, ref)
    _rel_close(out.objective, ref.objective)
    _bitwise(out.metric, ref.metric)              # test error, every record
    assert out.meta["train_error"] == ref.meta["train_error"]
    assert out.meta["encoder"] == ref.meta["encoder"]
    _rel_close(out.w, ref.w)


def test_mf_matches_reference():
    ref, out = _pair("mf", "coded")
    _common(out, ref)
    _rel_close(out.objective, ref.objective, LBFGS_RTOL)
    _rel_close(out.metric, ref.metric, LBFGS_RTOL)   # test RMSE
    hs, hr = out.extras["half_steps"], ref.extras["half_steps"]
    assert len(hs) == len(hr) == 4
    for a, b in zip(hs, hr):
        assert a.keys() == b.keys()
        assert (a["epoch"], a["side"], a["t_start"], a["t_end"]) == \
            (b["epoch"], b["side"], b["t_start"], b["t_end"])
        assert a["active_sets"] == b["active_sets"]
        for key in ("train_rmse", "test_rmse", "als_objective"):
            _rel_close(a[key], b[key], LBFGS_RTOL)
    json.dumps(out.to_record())


def test_mf_half_step_design_guard_matches_reference():
    from repro.workloads.matrix_factorization import \
        _half_step_design as jdesign
    from repro_torch.workloads.matrix_factorization import \
        _half_step_design as tdesign
    wl = twl.get_workload("mf")
    data = wl.build("smoke")
    fixed = np.random.default_rng(0).standard_normal((36, 4)).astype(
        np.float32)
    for a, b in zip(tdesign(data.R - 3.0, data.train, fixed, "u"),
                    jdesign(data.R - 3.0, data.train, fixed, "u")):
        _bitwise(a, b)
    # MovieLens-1M's users x movies at rank 15: a sparse mask of ~11 000
    # ratings already asks for a 1e9-cell dense design
    shape = (6040, 3706)
    mask = np.random.default_rng(1).random(shape) < 5e-4
    Rc = np.broadcast_to(np.float32(0.0), shape)
    with pytest.raises(MemoryError, match="paper"):
        tdesign(Rc, mask, np.zeros((shape[1], 16)), "u")
    with pytest.raises(MemoryError, match="paper"):
        jdesign(Rc, mask, np.zeros((shape[1], 16)), "u")


# ---------------------------------------------------------------------------
# The reference's end-to-end properties, on the port
# ---------------------------------------------------------------------------

def test_ridge_gap_shrinks_and_traces_align():
    res = twl.get_workload("ridge").run(
        "coded", _full_participation_engine(8), preset="smoke", k=8,
        device="cpu")
    assert res.metric_name == "subopt_gap"
    assert len(res.times) == len(res.objective) == len(res.metric)
    assert res.metric[-1] < 1e-2 * res.metric[0]
    assert (res.metric >= 0).all()


def test_lasso_support_recovery_f1_at_smoke_scale():
    _, res = _pair("lasso", "coded")   # native engine, k < m
    assert res.metric_name == "support_f1"
    assert res.final_metric >= 0.85
    # F1 recorded at chunk boundaries, with matching time stamps
    assert len(res.metric_times) == len(res.metric) > 1
    assert res.metric_times[-1] == pytest.approx(res.times[-1])


def test_logistic_bcd_approaches_host_newton():
    wl = twl.get_workload("logistic")
    data = wl.build("smoke")
    res = wl.run("coded", _full_participation_engine(8), preset="smoke",
                 data=data, k=8, steps=600, device="cpu")
    f_newton = tgt.logistic_objective(
        data.X_train, data.y_train,
        tgt.logistic_newton(data.X_train, data.y_train))
    assert res.final_objective >= f_newton - 1e-6   # Newton is the optimum
    assert res.final_objective <= f_newton + 0.03   # ...and BCD approaches it
    assert res.final_metric < 0.45                  # held-out error beats coin
    # the objective is monotone under full participation (exact lifting)
    assert (np.diff(np.asarray(res.objective)) <= 1e-6).all()


def test_mf_als_objective_monotone_under_full_participation():
    wl = twl.get_workload("mf")
    res = wl.run("uncoded", _full_participation_engine(8), preset="smoke",
                 k=8, device="cpu")
    obj = np.asarray(res.objective)
    assert len(obj) == 2 * wl.presets["smoke"].dims["epochs"]
    assert (np.diff(obj) <= 1e-8).all(), f"ALS objective not monotone: {obj}"
    half_steps = res.extras["half_steps"]
    assert len(half_steps) == len(obj)
    for hs in half_steps:
        assert len(hs["active_sets"]) == wl.presets["smoke"].steps
        assert all(len(a) == 8 for a in hs["active_sets"])  # k = m = 8


def test_mf_coded_matches_exact_als_reference():
    wl = twl.get_workload("mf")
    data = wl.build("smoke")
    ps = wl.presets["smoke"]
    _, ref_test = tgt.als_reference(data.R, data.train, data.test,
                                    rank=ps.dims["rank"], lam=ps.lam,
                                    epochs=ps.dims["epochs"])
    _, res = _pair("mf", "coded")
    assert abs(res.final_metric - ref_test) < 0.1


# ---------------------------------------------------------------------------
# Device policy and isolation from JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lasso", "logistic", "mf", "ridge"])
def test_entry_points_without_device_raise_when_no_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = twl.get_workload(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wl.run("coded", preset="smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wl.run_trials("coded", preset="smoke", trials=2)
    if name == "lasso":
        data = wl.build("smoke")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbase.run_strategy_chunked("coded-prox", data.spec,
                                       wl.default_engine("smoke"), steps=4,
                                       records=2)


def test_workloads_import_leaves_jax_and_repro_unimported():
    code = ("import sys\n"
            "import repro_torch.workloads, repro_torch.data, "
            "repro_torch.configs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "assert repro_torch.workloads.available_workloads() == "
            "['lasso', 'logistic', 'mf', 'ridge']\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
