"""The port's observability stack (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the CPU.

  * the sketches and metrics are host numpy copies: on the same seeded
    inputs (and on schedules from the port's engine, itself a copy) they
    equal the reference's exactly;
  * ``analyze``, ``diff`` and ``report`` are copies: on the same stored run
    and trace their output (summaries, diff reports, text, HTML, exit
    codes) equals the reference's;
  * ``timing``, ``profile`` and ``runstore.provenance`` are rewritten on
    torch: they are held to their documented CPU behaviour (no build to
    count, host clock, a Chrome trace of host activity, ``{}`` / ``None``
    for device memory, a "cpu" backend stamp).
"""
import copy
import json
import os
import time
import types

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.obs import analyze as j_analyze
from repro.obs import report as j_report
from repro.obs.diff import main as j_diff
from repro.runtime import ClusterEngine as JEngine
from repro.runtime import FastestK as JFastestK
from repro.runtime import make_delay_model as j_delay
from repro_torch.obs import analyze as t_analyze
from repro_torch.obs import report as t_report
from repro_torch.obs.diff import main as t_diff
from repro_torch.runtime import ClusterEngine as TEngine
from repro_torch.runtime import FastestK as TFastestK
from repro_torch.runtime import make_delay_model as t_delay

M, K = 8, 6
CHAOS = "crash:p=0.3,at=0.4;blackout:p=0.3,dur=0.4;corrupt:p=0.05"


def test_obs_all_equals_reference():
    assert tobs.__all__ == jobs.__all__
    for name in tobs.__all__:
        assert hasattr(tobs, name), name


# ---------------------------------------------------------------------------
# sketches and metrics: exact on the same inputs
# ---------------------------------------------------------------------------

def _samples(dist, n, seed=7):
    rng = np.random.default_rng(seed)
    return {"lognormal": lambda: rng.lognormal(0.0, 1.0, n),
            "uniform": lambda: rng.random(n),
            "exponential": lambda: rng.exponential(1.0, n)}[dist]()


@pytest.mark.parametrize("n,buffer_size", [(50, 64), (20000, 256),
                                           (20000, 4096)])
@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_quantile_sketch_equals_reference(dist, n, buffer_size):
    x = _samples(dist, n)
    a = tobs.QuantileSketch(buffer_size=buffer_size)
    b = jobs.QuantileSketch(buffer_size=buffer_size)
    for chunk in np.array_split(x, 7):
        a.observe_many(chunk)
        b.observe_many(chunk)
    assert a.spilled == b.spilled
    assert a.summary() == b.summary()
    for q in (50, 95, 99):
        assert a.quantile(q) == b.quantile(q)


@pytest.mark.parametrize("q", [0.1, 0.5, 0.99])
def test_p2_quantile_and_ewma_equal_reference(q):
    x = _samples("lognormal", 3000, seed=3)
    a, b = tobs.P2Quantile(q), jobs.P2Quantile(q)
    ea, eb = tobs.Ewma(0.3), jobs.Ewma(0.3)
    for v in x:
        a.observe(float(v))
        b.observe(float(v))
        assert ea.update(float(v)) == eb.update(float(v))
    assert a.value == b.value


def _engines(seed=0, faults=None, tail=False):
    kw = {"seed": seed, "faults": faults}
    ta = tobs.DelayTailEstimator(M) if tail else None
    ja = jobs.DelayTailEstimator(M) if tail else None
    te = TEngine(t_delay("bimodal"), M, tail_estimator=ta, **kw)
    je = JEngine(j_delay("bimodal"), M, tail_estimator=ja, **kw)
    return te, je, ta, ja


@pytest.mark.parametrize("faults", [None, CHAOS])
def test_schedule_and_fault_metrics_equal_reference(faults):
    te, je, ta, ja = _engines(faults=faults, tail=True)
    ts = [te.sample_schedule(20, TFastestK(K)) for _ in range(2)]
    js = [je.sample_schedule(20, JFastestK(K)) for _ in range(2)]
    assert tobs.schedule_metrics(ts, k=K) == jobs.schedule_metrics(js, k=K)
    assert tobs.fault_metrics(ts, k=K) == jobs.fault_metrics(js, k=K)
    assert ta.snapshot() == ja.snapshot()


@pytest.mark.parametrize("faults", [None, "crash:p=0.3,at=0.4"])
def test_async_metrics_and_cell_summary_equal_reference(faults):
    te, je, _, _ = _engines(seed=3, faults=faults)
    trec, jrec = tobs.TraceRecorder(), jobs.TraceRecorder()
    with trec.activate():
        tt = te.sample_async(40, 5)
        te.sample_schedule(10, TFastestK(K))
    with jrec.activate():
        jt = je.sample_async(40, 5)
        je.sample_schedule(10, JFastestK(K))
    assert tobs.async_metrics([tt]) == jobs.async_metrics([jt])
    assert tobs.cell_summary(trec.sources_since(0)) == \
        jobs.cell_summary(jrec.sources_since(0))


def test_registry_and_clamp_equal_reference():
    regs = []
    for mod in (tobs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("hits").inc()
        reg.counter("hits").inc(2)
        reg.gauge("m").set(8)
        reg.histogram("lat").observe_many(_samples("uniform", 5000))
        reg.histogram("ints").observe_many([1, 2, 2, 3, 7])
        regs.append(reg.summary())
    assert regs[0] == regs[1]
    for u in range(6):
        for tau in range(-2, 8):
            for rv in range(0, 8):
                assert tobs.clamp_async_event(u, tau, rv, 6) == \
                    jobs.clamp_async_event(u, tau, rv, 6)


# ---------------------------------------------------------------------------
# analyze, diff and report: the same output on the same stored run
# ---------------------------------------------------------------------------

def _port_run(tmp_path):
    """One port run with the obs axis on, recorded into a store, plus its
    trace; the store is read by both packages."""
    import repro_torch.experiments as P
    store = tobs.RunStore(str(tmp_path / "store"))
    prefix = str(tmp_path / "trace")
    spec = P.ExperimentSpec(
        problems=(P.ProblemAxis.synthetic(64, 16),),
        strategies=(P.StrategyAxis("coded-gd"), P.StrategyAxis("async")),
        delays=P.DelayAxis.of("bimodal", "exponential", m=M, faults=CHAOS),
        trials=P.TrialsAxis(trials=2), steps=8,
        obs=P.ObsAxis(trace=prefix, metrics=True))
    result = P.execute(P.plan(spec), device="cpu", record_to=store)
    return store, result, prefix + ".jsonl"


@pytest.fixture()
def stored(tmp_path):
    return _port_run(tmp_path)


def _slowed_copy(store, run_id, factor):
    m = copy.deepcopy(store.load(run_id))
    m.pop("run_id")
    for cell in m["cells"]:
        if "wallclock_s" in cell:
            cell["wallclock_s"] *= factor
    return store.record(m)


def test_analyze_summaries_and_diff_reports_equal_reference(stored):
    store, result, _ = stored
    assert t_analyze.summarize_records(result.records) == \
        j_analyze.summarize_records(result.records)
    a = store.load(result.run_id)
    for factor in (1.0, 2.0, 0.5):
        b = store.load(_slowed_copy(store, result.run_id, factor))
        ta = t_analyze.diff_manifests(a, b, a_label="a", b_label="b")
        ja = j_analyze.diff_manifests(a, b, a_label="a", b_label="b")
        assert ta.to_dict() == ja.to_dict()
        assert ta.render_text() == ja.render_text()
        assert ta.render_html_section() == ja.render_html_section()
        assert ta.exit_code == (1 if factor == 2.0 else 0)


@pytest.mark.parametrize("factor,rc", [(1.0, 0), (2.0, 1)])
def test_diff_cli_output_equals_reference(stored, tmp_path, capsys, factor,
                                          rc):
    store, result, _ = stored
    b = _slowed_copy(store, result.run_id, factor)
    outs = []
    for main, tag in ((t_diff, "t"), (j_diff, "j")):
        js, html = tmp_path / f"{tag}.json", tmp_path / f"{tag}.html"
        assert main([result.run_id, b, "--store", store.root, "--json",
                     str(js), "--html", str(html)]) == rc
        outs.append((capsys.readouterr().out, js.read_text(),
                     html.read_text()))
    assert outs[0] == outs[1]
    assert t_diff(["nope-a", "nope-b", "--store", store.root]) == 2


def test_bench_diff_equals_reference(tmp_path, capsys):
    base = {"bench": "x", "meta": {"git_sha": "a"},
            "results": [{"case": "r16", "us_per_call": 100.0,
                         "seconds_per_matrix": 1.0}]}
    cand = copy.deepcopy(base)
    cand["results"][0]["us_per_call"] = 250.0
    (tmp_path / "base.json").write_text(json.dumps(base))
    (tmp_path / "cand.json").write_text(json.dumps(cand))
    args = [str(tmp_path / "cand.json"), "--against-baseline",
            str(tmp_path / "base.json")]
    assert t_diff(args) == 1
    ours = capsys.readouterr().out
    assert j_diff(args) == 1
    assert ours == capsys.readouterr().out


def test_report_text_and_html_equal_reference(stored, tmp_path, capsys):
    store, result, trace = stored
    assert t_report.main([trace, "--max-steps", "4"]) == \
        j_report.main([trace, "--max-steps", "4"])
    th, jh = tmp_path / "t.html", tmp_path / "j.html"
    t_report.main([trace, "--html", str(th)])
    j_report.main([trace, "--html", str(jh)])
    assert th.read_text() == jh.read_text()
    text = t_report.main([trace])
    assert "phase breakdown" in text and "straggler timeline" in text
    capsys.readouterr()


# ---------------------------------------------------------------------------
# runstore: the reference's store, the port's provenance
# ---------------------------------------------------------------------------

def test_manifest_roundtrip_and_cpu_provenance(stored):
    store, result, _ = stored
    m = store.load(result.run_id)
    assert m["status"] == "complete" and m["kind"] == "experiment"
    assert m["spec_hash"] == tobs.spec_hash(result.spec)
    assert m["backend"] == "cpu" and m["device_name"] == "cpu"
    assert m["device_count"] == 1
    assert m["torch_version"] == torch.__version__
    assert m["cuda_version"] == torch.version.cuda
    assert "jax_version" not in m
    assert [r["run_id"] for r in store.runs()] == [result.run_id]
    assert store.runs()[0]["backend"] == "cpu"
    # the reference's store reads the port's manifest
    from repro.obs.runstore import RunStore as JStore
    assert JStore(store.root).resolve("latest")["run_id"] == result.run_id


def test_provenance_fields():
    p = tobs.provenance("cpu")
    assert set(p) == {"git_sha", "timestamp", "backend", "torch_version",
                      "cuda_version", "device_count", "device_name"}
    assert p["backend"] == "cpu" and "T" in p["timestamp"]
    if not torch.cuda.is_available():
        assert tobs.provenance()["backend"] == "cpu"


def test_execute_records_by_default_and_env_disables(tmp_path, monkeypatch):
    import repro_torch.experiments as P
    root = tmp_path / "envstore"
    monkeypatch.setenv("REPRO_RUNSTORE", str(root))
    spec = P.ExperimentSpec(
        problems=(P.ProblemAxis.synthetic(48, 8),),
        strategies=(P.StrategyAxis("uncoded"),),
        delays=P.DelayAxis.of("bimodal", m=4), steps=4)
    result = P.execute(P.plan(spec), device="cpu")
    assert result.run_id is not None
    assert tobs.RunStore(str(root)).load(result.run_id)["spec_hash"] == \
        tobs.spec_hash(spec)
    monkeypatch.setenv("REPRO_RUNSTORE", "0")
    assert P.execute(P.plan(spec), device="cpu").run_id is None


# ---------------------------------------------------------------------------
# timing and profile on the CPU
# ---------------------------------------------------------------------------

def test_block_waits_only_for_card_tensors():
    assert tobs.block(3.0) == 3.0
    t = torch.ones(3)
    out = (t, [t * 2, {"a": t}], "x")
    assert tobs.block(out) is out
    from repro_torch.obs.timing import _cuda_devices
    assert _cuda_devices(out) == []


def test_time_us_takes_the_host_clock_for_host_values():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.002)
        return torch.zeros(2)

    us = tobs.time_us(fn, 1, iters=3, warmup=2)
    assert len(calls) == 5 and us >= 2000.0


def test_compile_watch_counts_a_fresh_build(monkeypatch, tmp_path):
    """``load_library`` counts its loads for the watch: a build
    counts as one compile, and its time goes to ``compile_s``; a load of a
    library already on disk adds time but no compile."""
    from repro_torch.kernels import _build
    lib = tmp_path / "librepro_kernels-test.so"

    def fake_compile(path):
        time.sleep(0.05)
        path.write_bytes(b"")
        return ""

    def fake_cdll(path):
        return types.SimpleNamespace(**{
            name: types.SimpleNamespace() for name in _build._SIGNATURES})

    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    with tobs.CompileWatch() as cold:
        _build.load_library.__wrapped__()
    assert cold.compiles == 1 and cold.compile_s >= 0.05
    np.testing.assert_allclose(cold.compile_s + cold.execute_s,
                               cold.total_s)
    with tobs.CompileWatch() as warm:
        _build.load_library.__wrapped__()
        time.sleep(0.01)
    assert warm.compiles == 0 and 0.0 < warm.compile_s < warm.total_s
    with tobs.CompileWatch() as idle:
        time.sleep(0.01)
    assert idle.compiles == 0 and idle.compile_s == 0.0
    assert idle.execute_s == idle.total_s > 0


def test_profile_region_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tobs.profile_region(str(tmp_path / "prof"), device="cpu"):
        torch.ones(64) @ torch.ones(64)
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in doc
    with tobs.profile_region(None, device="cpu"):
        pass
    with tobs.profile_region(None):          # no logdir: a no-op anywhere
        pass


def test_memory_hooks_on_the_cpu_and_without_a_card(monkeypatch):
    assert tobs.memory_stats("cpu") == {}
    assert tobs.memory_high_water("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tobs.memory_stats, tobs.memory_high_water):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tobs.profile_region("unused"):
            pass


def test_profiled_execute_on_the_cpu(tmp_path):
    """``--profile`` through execute: a trace a cell, no memory gauge on
    the CPU, the CompileWatch split on every record."""
    import repro_torch.experiments as P
    spec = P.ExperimentSpec(
        problems=(P.ProblemAxis.synthetic(48, 8),),
        strategies=(P.StrategyAxis("uncoded"),),
        delays=P.DelayAxis.of("bimodal", m=4), steps=4,
        obs=P.ObsAxis(profile=str(tmp_path / "prof")))
    result = P.execute(P.plan(spec), device="cpu", record_to=False)
    [rec] = result.records
    assert "memory_high_water_bytes" not in rec["obs"]
    assert rec["compiles"] == 0 and rec["host_s"] > 0
    assert os.path.isfile(tmp_path / "prof" / "cell000" / "trace.json")
