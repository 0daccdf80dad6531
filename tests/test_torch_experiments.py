"""The port's experiment harness (``repro_torch.experiments``, the
``runtime.compare`` and ``workloads.run`` CLIs) against the JAX package's
``repro.experiments``, on the CPU.

One ``ExperimentSpec`` goes through both packages (the port with
``device="cpu"``); the reference runs its kernels as its own CPU tests run
them.  Records are compared field by field, apart from the timing fields
(``host_s``, ``compile_s``, ``execute_s``, ``compiles``, ``obs``):
  * bit for bit: every host-side schedule and wall-clock field (``times``,
    ``wallclock_s``, ``metric_times``, MF's half-step windows and active
    sets), every int, string and flag, and the skip reasons;
  * rel 1e-5 of the reference's largest magnitude: the other floats
    (objectives, metrics, summaries), 1e-4 for ``coded-lbfgs`` cells and
    MF (the two-loop recursion divides by inner products of float32
    differences) — the tolerances of ``test_torch_runtime.py`` and
    ``test_torch_workloads.py``;
  * suboptimality gaps to abs 1e-4 |f*|.
The executor's fault cases (streamed cells, resume, spec-mismatch refusal,
retry) are ``tests/test_faults.py``'s, on the port.
"""
import csv
import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.experiments as J
import repro_torch.experiments as P
from repro.obs import analyze as j_analyze
from repro.obs.runstore import RunStore as JStore
from repro_torch.obs.runstore import RunStore, spec_hash

RTOL, LBFGS_RTOL, GAP_ATOL = 1e-5, 1e-4, 1e-4
M = 8
TIMING = ("host_s", "compile_s", "execute_s", "compiles", "obs")
EXACT = {"times", "wallclock_s", "metric_times", "t_start", "t_end",
         "active_sets"}
SRC = Path(__file__).resolve().parents[1] / "src"
SYNTHETIC = ("coded-gd", "coded-prox", "coded-lbfgs", "uncoded",
             "replication", "async")


# ---------------------------------------------------------------------------
# Record comparison
# ---------------------------------------------------------------------------

def _is_num(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _all_num(xs):
    if isinstance(xs, list):
        return all(_all_num(x) for x in xs)
    return _is_num(xs)


def _compare(out, ref, path, rtol, gap_atol):
    exact = any(p in EXACT for p in path)
    if isinstance(ref, dict):
        assert isinstance(out, dict) and out.keys() == ref.keys(), path
        for k in ref:
            _compare(out[k], ref[k], path + (k,), rtol, gap_atol)
    elif isinstance(ref, list) and ref and _all_num(ref) and \
            any(isinstance(x, float) or isinstance(x, list)
                for x in ref):
        a = np.asarray(out, np.float64)
        b = np.asarray(ref, np.float64)
        assert a.shape == b.shape, path
        if exact:
            assert np.array_equal(a, b, equal_nan=True), path
        elif _gap(path):
            assert np.max(np.abs(a - b)) <= gap_atol, path
        else:
            _rel(a, b, rtol, path)
    elif isinstance(ref, list):
        assert isinstance(out, list) and len(out) == len(ref), path
        for i, (o, r) in enumerate(zip(out, ref)):
            _compare(o, r, path + (i,), rtol, gap_atol)
    elif isinstance(ref, float) and not exact:
        assert _is_num(out), path
        if _gap(path):
            assert abs(out - ref) <= gap_atol, path
        else:
            _rel(np.asarray(out), np.asarray(ref), rtol, path)
    else:
        assert out == ref, (path, out, ref)


def _gap(path):
    return any(isinstance(p, str) and "subopt" in p for p in path)


def _rel(a, b, rtol, path):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    assert np.array_equal(fin, np.isfinite(a)), path
    if fin.any():
        scale = max(np.max(np.abs(b[fin])), 1e-30)
        assert np.max(np.abs(a[fin] - b[fin])) <= rtol * scale, path


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in TIMING}


def _rtol(rec):
    lbfgs = (rec.get("strategy") == "coded-lbfgs" or
             rec.get("workload") == "mf")
    return LBFGS_RTOL if lbfgs else RTOL


def assert_records_match(out_records, ref_records):
    assert len(out_records) == len(ref_records)
    for out, ref in zip(out_records, ref_records):
        out, ref = _strip(out), _strip(ref)
        f_star = (ref.get("meta") or {}).get("f_star")
        gap_atol = GAP_ATOL * abs(f_star) if f_star is not None else 0.0
        if ref.get("metric_name") == "subopt_gap":
            for key in ("metric", "final_metric"):
                if key in ref:
                    arr = np.asarray(out[key], np.float64)
                    assert np.max(np.abs(
                        arr - np.asarray(ref[key], np.float64))) <= gap_atol
                    out = {k: v for k, v in out.items() if k != key}
                    ref = {k: v for k, v in ref.items() if k != key}
            summary = ref.get("summary", {})
            if "final_metric" in summary:
                for stat, v in summary["final_metric"].items():
                    assert abs(out["summary"]["final_metric"][stat] - v) \
                        <= gap_atol
                ref = {**ref, "summary": {k: v for k, v in summary.items()
                                          if k != "final_metric"}}
                out = {**out, "summary": {
                    k: v for k, v in out["summary"].items()
                    if k != "final_metric"}}
        _compare(out, ref, (), _rtol(ref), max(gap_atol, GAP_ATOL * 1e-2))


# ---------------------------------------------------------------------------
# Specs, built alike in both packages
# ---------------------------------------------------------------------------

def _synthetic_spec(E, *, placement="vmap", cell_batch=False, faults=None,
                    degrade=None, trials=2, strategies=SYNTHETIC,
                    obs=None):
    return E.ExperimentSpec(
        problems=(E.ProblemAxis.synthetic(64, 16),
                  E.ProblemAxis.synthetic(64, 16, h="l1", lam=0.02)),
        strategies=tuple(E.StrategyAxis(s, degrade=degrade
                                        if s == "coded-gd" else None)
                         for s in strategies),
        delays=E.DelayAxis.of("bimodal", "exponential", m=M, faults=faults),
        trials=E.TrialsAxis(trials=trials, eval_every=2 if trials > 1
                            else 1),
        placement=E.PlacementAxis(mode=placement, cell_batch=cell_batch),
        steps=12, obs=obs if obs is not None else E.ObsAxis())


def _workload_spec(E, name, trials=1):
    return E.ExperimentSpec(
        problems=(E.ProblemAxis.from_workload(name, "smoke"),),
        strategies=(E.StrategyAxis("coded"), E.StrategyAxis("uncoded"),
                    E.StrategyAxis("replication")),
        trials=E.TrialsAxis(trials=trials))


def _train_spec(E):
    return E.ExperimentSpec(
        problems=(E.ProblemAxis.train("deepseek-7b"),),
        strategies=(E.StrategyAxis("coded-sgd"), E.StrategyAxis("uncoded"),
                    E.StrategyAxis("coded-gd")),
        delays=E.DelayAxis.of("bimodal"))


def _run_both(make, **port_kw):
    ref = J.execute(J.plan(make(J)), record_to=False)
    out = P.execute(P.plan(make(P)), device="cpu", record_to=False,
                    **port_kw)
    return out, ref


SPECS = {
    "synthetic": lambda E: _synthetic_spec(E),
    "single": lambda E: _synthetic_spec(E, placement="single"),
    "faulted": lambda E: _synthetic_spec(
        E, faults="crash:p=0.3,at=0.4;corrupt:p=0.05",
        degrade="hold:shrink=0.5"),
    "workloads": lambda E: E.ExperimentSpec(
        problems=tuple(E.ProblemAxis.from_workload(w, "bench")
                       for w in ("ridge", "lasso", "logistic", "mf")),
        strategies=(E.StrategyAxis("coded"), E.StrategyAxis("async"),
                    E.StrategyAxis("coded-bcd", k=3))),
    "train": _train_spec,
}


# ---------------------------------------------------------------------------
# spec -> plan: hash, cells and labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_hash_plan_and_labels_match_reference(name):
    from repro.obs.runstore import spec_hash as j_hash
    js, ps = SPECS[name](J), SPECS[name](P)
    assert spec_hash(ps) == j_hash(js)
    jp, pp = J.plan(js), P.plan(ps)
    assert len(pp) == len(jp) and pp.describe() == jp.describe()
    fields = ("index", "resolved_strategy", "delay", "m", "k", "steps",
              "trials", "eval_every", "seed", "placement", "compute_time",
              "skip", "metric_name", "faults", "degrade", "kind")
    for pc, jc in zip(pp.cells, jp.cells):
        assert [getattr(pc, f) for f in fields] == \
            [getattr(jc, f) for f in fields]
        assert P.cell_label(pc) == J.cell_label(jc)


def test_spec_hash_of_a_concrete_problem_matches_reference():
    from repro.obs.runstore import spec_hash as j_hash
    from repro.runtime import ProblemSpec as JSpec
    from repro_torch.runtime import ProblemSpec as PSpec
    js = J.ExperimentSpec(
        problems=(J.ProblemAxis.from_spec(JSpec.synthetic(48, 8)),),
        strategies=(J.StrategyAxis("uncoded"),),
        delays=J.DelayAxis.of("bimodal", m=M))
    ps = P.ExperimentSpec(
        problems=(P.ProblemAxis.from_spec(PSpec.synthetic(48, 8)),),
        strategies=(P.StrategyAxis("uncoded"),),
        delays=P.DelayAxis.of("bimodal", m=M))
    assert spec_hash(ps) == j_hash(js)


# ---------------------------------------------------------------------------
# execute: the same spec, the same records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement,cell_batch", [
    ("vmap", False), ("single", False), ("vmap", True)])
def test_synthetic_matrix_matches_reference(placement, cell_batch):
    out, ref = _run_both(lambda E: _synthetic_spec(
        E, placement=placement, cell_batch=cell_batch))
    assert_records_match(out.records, ref.records)
    assert out.device == torch.device("cpu")
    assert sum("skipped" in r for r in out.records) == \
        sum("skipped" in r for r in ref.records) > 0
    if cell_batch:
        batched = [r for r in out.records
                   if r.get("meta", {}).get("cell_batched")]
        assert batched and all(r["meta"]["cell_batched"] == 2
                               for r in batched)


def test_single_trial_matrix_matches_reference():
    out, ref = _run_both(lambda E: _synthetic_spec(E, trials=1))
    assert_records_match(out.records, ref.records)
    assert all("trials" not in r for r in out.records)


def test_faulted_matrix_matches_reference():
    """One ``--faults`` and one ``--degrade`` spec (hold on coded-gd)."""
    out, ref = _run_both(SPECS["faulted"])
    assert_records_match(out.records, ref.records)
    gd = [r for r in out.records if r["strategy"] == "coded-gd"]
    assert gd and all(r["meta"]["degrade"] == "hold" for r in gd)
    assert any(r["meta"].get("faults") for r in out.records)


@pytest.mark.parametrize("name", ["lasso", "logistic", "mf", "ridge"])
def test_workload_smoke_matrix_matches_reference(name):
    out, ref = _run_both(lambda E: _workload_spec(E, name))
    assert_records_match(out.records, ref.records)
    assert [r.get("skipped") for r in out.records] == \
        [r.get("skipped") for r in ref.records]


def test_workload_trials_record_matches_reference():
    out, ref = _run_both(lambda E: _workload_spec(E, "ridge", trials=2))
    assert_records_match(out.records, ref.records)
    rec = next(r for r in out.records if "skipped" not in r)
    assert rec["trials"] == 2 and len(rec["times"]) == 2


def test_obs_axis_records_match_reference(tmp_path):
    """With the obs axis on, the per-cell obs summaries (from the realized
    schedules) equal the reference's and every record carries the
    CompileWatch split; the trace files are written."""
    def make(E, d):
        return _synthetic_spec(
            E, strategies=("coded-gd", "async"),
            obs=E.ObsAxis(trace=str(tmp_path / d / "trace"), metrics=True))
    ref = J.execute(J.plan(make(J, "j")), record_to=False)
    out = P.execute(P.plan(make(P, "p")), device="cpu", record_to=False)
    assert_records_match(out.records, ref.records)
    for o, r in zip(out.records, ref.records):
        if "skipped" in r:
            continue
        assert o["obs"] == r["obs"]
        assert o["compiles"] == 0 and o["compile_s"] == 0.0
        assert o["host_s"] >= o["execute_s"] > 0
    for suffix in (".jsonl", ".perfetto.json"):
        assert (tmp_path / "p" / ("trace" + suffix)).exists()


def test_outcomes_carry_port_results():
    out = P.execute(P.plan(_synthetic_spec(P, strategies=("uncoded",))),
                    device="cpu", record_to=False)
    from repro_torch.runtime import TrialsResult
    assert all(isinstance(o.result, TrialsResult) for o in out.outcomes)


def test_train_spec_refused_before_any_cell_runs(tmp_path):
    store = RunStore(str(tmp_path / "runs"))
    pl = P.plan(_train_spec(P))
    assert any(c.kind == "train" for c in pl.cells)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        P.execute(pl, device="cpu", record_to=store)
    assert store.runs() == [] and not os.path.exists(store.root)


def test_execute_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.execute(P.plan(_synthetic_spec(P)), record_to=False)


def _wide_spec():
    """GD cells one column past the fused kernel's width (a step size is
    given, so no p x p eigensolve runs)."""
    from repro_torch.kernels.fused_step import MAX_COLS
    opts = (("step_size", 1e-4),)
    return P.ExperimentSpec(
        problems=(P.ProblemAxis.synthetic(32, MAX_COLS + 1),),
        strategies=(P.StrategyAxis("coded-gd", options=opts),
                    P.StrategyAxis("uncoded", options=opts)),
        delays=P.DelayAxis.of("bimodal", m=4), steps=2)


def test_cells_past_max_cols_are_skip_records_naming_the_switch(monkeypatch):
    """Past MAX_COLS the card's fused kernel refuses; through ``execute``
    the refusal becomes each cell's skip record, whose reason names
    REPRO_FUSED=0, and under REPRO_FUSED=0 the cells run on the combine
    path.  The CPU tensors here go through the card's operand check."""
    import repro_torch.runtime.runners as runners
    from repro_torch.kernels.fused_step import _check_kernel_operands
    fused = runners.fused_masked_gradient

    def card_checked(SX, Sy, W, masks, **kw):
        _check_kernel_operands(SX, Sy, W, masks)
        return fused(SX, Sy, W, masks, **kw)
    monkeypatch.setattr(runners, "fused_masked_gradient", card_checked)
    monkeypatch.delenv("REPRO_FUSED", raising=False)
    out = P.execute(P.plan(_wide_spec()), device="cpu", record_to=False)
    assert len(out.records) == 2
    for rec in out.records:
        assert "REPRO_FUSED=0" in rec["skipped"]
    monkeypatch.setenv("REPRO_FUSED", "0")
    out = P.execute(P.plan(_wide_spec()), device="cpu", record_to=False)
    for rec in out.records:
        assert "skipped" not in rec
        assert np.isfinite(rec["objective"]).all()


# ---------------------------------------------------------------------------
# The resilient executor (tests/test_faults.py's cases on the port)
# ---------------------------------------------------------------------------

def _matrix_spec():
    return P.ExperimentSpec(
        problems=(P.ProblemAxis.synthetic(96, 24),),
        strategies=(P.StrategyAxis("coded-gd", degrade="hold:shrink=0.5"),
                    P.StrategyAxis("uncoded")),
        delays=P.DelayAxis.of("bimodal", m=M,
                              faults="crash:p=0.3,at=0.4;corrupt:p=0.05"),
        trials=P.TrialsAxis(trials=2, eval_every=4), steps=12)


def test_execute_streams_cells_and_resumes_identically(tmp_path):
    store = RunStore(str(tmp_path / "runs"))
    full = P.execute(P.plan(_matrix_spec()), device="cpu", record_to=store)
    assert full.run_id is not None
    cells = store.cells_dir(full.run_id)
    assert sorted(os.listdir(cells)) == ["0000.json", "0001.json"]
    mpath = os.path.join(store.root, full.run_id, "manifest.json")
    manifest = json.loads(open(mpath).read())
    assert manifest["status"] == "complete"
    assert manifest["backend"] == "cpu"

    # kill the matrix after cell 0: drop cell 1 and mark the run running
    os.remove(os.path.join(cells, "0001.json"))
    manifest["status"] = "running"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    resumed = P.execute(P.plan(_matrix_spec()), device="cpu",
                        record_to=store, resume=full.run_id)
    assert resumed.records == full.records     # bit-identical replay
    assert resumed.run_id == full.run_id
    a, b = tmp_path / "full.json", tmp_path / "resumed.json"
    full.to_json(str(a))
    resumed.to_json(str(b))
    assert a.read_bytes() == b.read_bytes()


def test_resume_rejects_spec_mismatch(tmp_path):
    store = RunStore(str(tmp_path / "runs"))
    full = P.execute(P.plan(_matrix_spec()), device="cpu", record_to=store)
    other = P.ExperimentSpec(
        problems=(P.ProblemAxis.synthetic(64, 16),),
        strategies=(P.StrategyAxis("uncoded"),),
        delays=P.DelayAxis.of("bimodal", m=M), steps=8)
    with pytest.raises(ValueError, match="spec hash mismatch"):
        P.execute(P.plan(other), device="cpu", record_to=store,
                  resume=full.run_id)
    with pytest.raises(KeyError, match="is empty"):
        P.execute(P.plan(other), device="cpu",
                  record_to=RunStore(str(tmp_path / "empty")),
                  resume="latest")


def test_retry_reruns_flaky_cell(tmp_path, monkeypatch, capsys):
    ex = importlib.import_module("repro_torch.experiments.execute")
    real = ex._execute_cell
    failures = {"left": 2}

    def flaky(cell, caches, device):
        if failures["left"] > 0:
            failures["left"] -= 1
            raise RuntimeError("transient device loss")
        return real(cell, caches, device)

    monkeypatch.setattr(ex, "_execute_cell", flaky)
    monkeypatch.setattr(ex.time, "sleep", lambda s: None)
    spec = P.ExperimentSpec(
        problems=(P.ProblemAxis.synthetic(64, 16),),
        strategies=(P.StrategyAxis("uncoded"),),
        delays=P.DelayAxis.of("bimodal", m=M), steps=8)
    result = P.execute(P.plan(spec), device="cpu", retries=3,
                       record_to=RunStore(str(tmp_path / "runs")))
    assert len(result.records) == 1 and failures["left"] == 0
    assert "retry" in capsys.readouterr().out
    failures["left"] = 99
    with pytest.raises(RuntimeError, match="transient device loss"):
        P.execute(P.plan(spec), device="cpu", retries=1)


def test_retry_delay_matches_reference():
    from repro.experiments.execute import _retry_delay as j_delay
    from repro_torch.experiments.execute import _retry_delay
    for base, attempt, index in [(0.5, 1, 0), (0.5, 2, 0), (0.5, 30, 0),
                                 (0.1, 3, 7), (2.0, 4, 11)]:
        assert _retry_delay(base, attempt, index) == \
            j_delay(base, attempt, index)


# ---------------------------------------------------------------------------
# The reference's regression gate on a port run
# ---------------------------------------------------------------------------

def test_reference_diff_passes_port_run_against_reference_run(tmp_path,
                                                              capsys):
    """ROADMAP's gate for the harness: ``repro.obs.diff`` aligns a port run
    with a reference run of the same spec and reports no regression."""
    from repro.obs.diff import main as j_diff
    jstore = JStore(str(tmp_path / "ref"))
    pstore = RunStore(str(tmp_path / "port"))
    J.execute(J.plan(_synthetic_spec(J)), record_to=jstore)
    P.execute(P.plan(_synthetic_spec(P)), device="cpu", record_to=pstore)
    a = jstore.resolve("latest")
    b = JStore(pstore.root).resolve("latest")
    assert a["spec_hash"] == b["spec_hash"]
    report = j_analyze.diff_manifests(a, b)
    assert report.exit_code == 0 and not report.regressions
    assert not report.unmatched_a and not report.unmatched_b
    assert len(report.deltas) == sum("skipped" not in c
                                     for c in a["cells"])
    a_dir = os.path.join(jstore.root, a["run_id"])
    b_dir = os.path.join(pstore.root, b["run_id"])
    assert j_diff([a_dir, b_dir]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The CLIs: same flags, same outputs (plus --device)
# ---------------------------------------------------------------------------

def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _csv_match(out_rows, ref_rows):
    assert len(out_rows) == len(ref_rows)
    for o, r in zip(out_rows, ref_rows):
        assert o.keys() == r.keys()
        for k in r:
            if o[k] == r[k]:
                continue
            a, b = float(o[k]), float(r[k])
            assert k not in EXACT and abs(a - b) <= RTOL * max(abs(b), 1.0)


def test_compare_cli_matches_reference(tmp_path, capsys):
    from repro.runtime.compare import main as j_main
    from repro_torch.runtime.compare import main as p_main
    args = ["--strategies", "coded-gd,uncoded,replication,async",
            "--delays", "bimodal,exponential", "--n", "64", "--p", "16",
            "--m", "8", "--steps", "8", "--trials", "2"]
    ref = j_main(args + ["--out", str(tmp_path / "j")])
    out = p_main(args + ["--out", str(tmp_path / "p"), "--device", "cpu"])
    assert_records_match(out, ref)
    assert_records_match(
        json.loads((tmp_path / "p" / "compare.json").read_text()),
        json.loads((tmp_path / "j" / "compare.json").read_text()))
    _csv_match(_read_csv(tmp_path / "p" / "compare.csv"),
               _read_csv(tmp_path / "j" / "compare.csv"))
    capsys.readouterr()


def test_workloads_cli_matches_reference(tmp_path, capsys):
    from repro.workloads.runner import main as j_main
    from repro_torch.workloads.runner import main as p_main
    args = ["--workload", "ridge,logistic", "--strategies",
            "coded,uncoded", "--steps", "10"]
    ref = j_main(args + ["--out", str(tmp_path / "j")])
    out = p_main(args + ["--out", str(tmp_path / "p"), "--device", "cpu"])
    assert_records_match(out, ref)
    assert_records_match(
        json.loads((tmp_path / "p" / "workloads.json").read_text()),
        json.loads((tmp_path / "j" / "workloads.json").read_text()))
    _csv_match(_read_csv(tmp_path / "p" / "summary.csv"),
               _read_csv(tmp_path / "j" / "summary.csv"))
    capsys.readouterr()


def test_experiments_cli_matches_reference(tmp_path, capsys):
    from repro.experiments.run import main as j_main
    from repro_torch.experiments.run import main as p_main
    args = ["--strategies", "coded-gd,coded-lbfgs", "--delays", "bimodal",
            "--n", "64", "--p", "16", "--m", "8", "--steps", "8",
            "--encoder", "fast-hadamard", "--metrics-out"]
    ref = j_main(args + [str(tmp_path / "j.csv"), "--out",
                         str(tmp_path / "j")])
    out = p_main(args + [str(tmp_path / "p.csv"), "--out",
                         str(tmp_path / "p"), "--device", "cpu"])
    assert_records_match(out.records, ref.records)
    for name in ("experiments.csv", "summary.csv"):
        _csv_match(_read_csv(tmp_path / "p" / name),
                   _read_csv(tmp_path / "j" / name))
    j_rows, p_rows = (_read_csv(tmp_path / "j.csv"),
                      _read_csv(tmp_path / "p.csv"))
    assert [r.keys() for r in p_rows] == [r.keys() for r in j_rows]
    capsys.readouterr()
    j_main(["--workloads", "ridge,mf", "--strategies", "coded,async",
            "--plan-only"])
    ref_plan = capsys.readouterr().out
    p_main(["--workloads", "ridge,mf", "--strategies", "coded,async",
            "--plan-only"])
    assert capsys.readouterr().out == ref_plan


def test_cli_without_device_raises_when_no_card(tmp_path, monkeypatch):
    from repro_torch.runtime.compare import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--strategies", "uncoded", "--delays", "bimodal", "--n", "32",
              "--p", "8", "--m", "4", "--steps", "2", "--out",
              str(tmp_path)])


def test_run_matrix_and_run_workload_matrix_exports():
    import repro_torch.runtime as trt
    import repro_torch.workloads as twl
    assert "run_matrix" in trt.__all__ and "run_workload_matrix" in \
        twl.__all__
    recs = trt.run_matrix(["uncoded"], ["bimodal"], n=48, p=8, m=4,
                          steps=4, device="cpu")
    assert len(recs) == 1 and recs[0]["strategy"] == "uncoded"
    recs = twl.run_workload_matrix(["ridge"], ["uncoded"], steps=4,
                                   device="cpu")
    assert recs[0]["workload"] == "ridge"


# ---------------------------------------------------------------------------
# Isolation from JAX and the reference package
# ---------------------------------------------------------------------------

_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)


def test_port_sources_import_no_jax_or_reference():
    """No file of the port (the harness and obs modules included) imports
    ``jax`` or the ``repro`` package."""
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert any(f.parent.name == "experiments" for f in files)
    for f in files + [SRC.parent / "chip_smoke.py"]:
        assert not _IMPORT.search(f.read_text()), f


def test_harness_import_leaves_jax_and_repro_unimported():
    code = ("import sys\n"
            "import repro_torch.experiments, repro_torch.obs\n"
            "import repro_torch.experiments.run, repro_torch.obs.diff\n"
            "import repro_torch.obs.report, repro_torch.runtime.compare\n"
            "import repro_torch.workloads.runner\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
