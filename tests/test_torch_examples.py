"""The port's examples and CLIs as a user runs them, on the CPU.

Each port example (``examples/torch_*.py``) runs with ``--device cpu`` in
a subprocess beside its reference example (``examples/*.py``), the two
started together, each with its own timeout, and their printed lines are
compared token by token: the words equal, and the numbers
  * objectives and losses (and ``train_lm``'s loss ratio) to rel 1e-4;
  * ``train_lm``'s gradient norms to rel 1e-3: the reference's jitted
    norm sums in float32 in one pass, up to 1e-4 off a float64 sum
    (ROADMAP Queue 3 item 3), and is printed to 5 digits;
  * simulated times, step and worker counts, F1 values and the other
    counts equal as printed;
  * suboptimality gaps to abs 1e-4 |f*|, the rule of
    ``test_torch_experiments.py``: a gap is f - f* with f about 10^3-10^4
    times the gap in these runs, so a float32 ulp of f is about 1e-3 of
    it in either package, and rel 1e-4 on the gap is not attainable.
``train_lm`` starts both packages from the reference's initial
parameters (the port's ``init_params`` replaced in its subprocess by the
reference's, carried across; the two packages' random generators differ),
with ``--steps 12 --log-every 4``, and also compares the two ``--out``
summaries.

Then the port's CLIs, each a ``python -m`` subprocess:
``repro_torch.experiments.run --device cpu`` beside
``repro.experiments.run`` on the same cell (records compared as in
``test_torch_experiments.py``, apart from timing fields),
``repro_torch.launch.train --smoke --device cpu`` (simulated times equal
to the reference CLI's on the same flags) and one
``repro_torch.launch.dryrun`` record.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from test_torch_experiments import assert_records_match

ROOT = Path(__file__).resolve().parents[1]
RTOL, GAP_ATOL, NORM_RTOL = 1e-4, 1e-4, 1e-3
TIMEOUT = 240
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|inf")


def _env():
    """Each subprocess on two threads: the pairs run beside the suite's
    other workers."""
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
                MKL_NUM_THREADS="2",
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=2",
                PYTHONPATH=str(ROOT / "src") + os.pathsep +
                os.environ.get("PYTHONPATH", ""))


def _run_together(*commands) -> list[str]:
    """Start every command at once; each must exit 0 within TIMEOUT.
    Returns their standard outputs."""
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=_env(), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in commands]
    outs = []
    try:
        for cmd, proc in zip(commands, procs):
            out, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, (cmd, err[-3000:])
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def _example(name, *args):
    return [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args]


def _tokens(line):
    """(the words between the numbers, the numbers as printed)."""
    return NUMBER.split(line), NUMBER.findall(line)


def _compare(port: str, ref: str, kind_of) -> None:
    """Line by line: equal words; the i-th number of a line by
    ``kind_of(i, the words before it, the reference's line)`` -> "rel",
    "exact", "norm" or ("gap", f*)."""
    p_lines = [ln for ln in port.splitlines() if ln.strip()]
    r_lines = [ln for ln in ref.splitlines() if ln.strip()]
    assert len(p_lines) == len(r_lines), (port, ref)
    for pl, rl in zip(p_lines, r_lines):
        (pw, pn), (rw, rn) = _tokens(pl), _tokens(rl)
        assert pw == rw and len(pn) == len(rn), (pl, rl)
        for i, (a, b) in enumerate(zip(pn, rn)):
            kind = kind_of(i, "".join(rw[:i + 1]), rl)
            if kind == "exact":
                assert a == b, (pl, rl)
            elif kind in ("rel", "norm"):
                rtol = RTOL if kind == "rel" else NORM_RTOL
                assert abs(float(a) - float(b)) <= rtol * abs(float(b)), \
                    (pl, rl)
            else:
                _, f_star = kind
                assert abs(float(a) - float(b)) <= GAP_ATOL * abs(f_star), \
                    (pl, rl)


def _f_star(workload: str) -> float:
    from repro.workloads import get_workload
    wl = get_workload(workload)
    return float(wl.build(wl.preset("smoke")).f_star)


def test_quickstart_matches_reference():
    port, ref = _run_together(_example("torch_quickstart", "--device", "cpu"),
                              _example("quickstart"))

    def kind_of(i, before, line):
        if line.startswith("suboptimality"):    # f_T / f* - 1, in percent
            return ("gap", 100.0)
        if before.rstrip().endswith("="):       # f(w_0), f(w_1), f(w_T), f*
            return "rel"
        return "exact"                          # k, wall-clock, iterations

    _compare(port, ref, kind_of)
    assert "simulated wall-clock" in port and port.rstrip().endswith(
        "optimum")


def test_strategy_comparison_matches_reference():
    port, ref = _run_together(
        _example("torch_strategy_comparison", "--device", "cpu"),
        _example("strategy_comparison"))
    f_star = _f_star("ridge")

    def kind_of(i, before, line):
        # a row's columns: final gap, then the simulated wall_s, t_to_best
        return ("gap", f_star) if i == 0 else "exact"

    _compare(port, ref, kind_of)
    assert len(port.splitlines()) == 1 + 3 * 4


def test_lasso_recovery_matches_reference():
    port, ref = _run_together(
        _example("torch_lasso_recovery", "--device", "cpu"),
        _example("lasso_recovery"))
    f_star = _f_star("lasso")

    def kind_of(i, before, line):
        if before.endswith("final_obj="):
            return "rel"
        if before.endswith("f*: "):
            return ("gap", f_star)
        return "exact"                          # sizes, F1

    _compare(port, ref, kind_of)
    assert port.count("F1=") == 4


_PORT_FROM_REFERENCE_INIT = textwrap.dedent("""
    import dataclasses, runpy, sys
    import jax, numpy as np
    import repro.configs.base as JB
    import repro.models.transformer as JT
    import repro_torch.models.transformer as PT
    from repro_torch.models import params_from_numpy

    def reference_init(cfg, key, *, device=None):
        kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        kw["period"] = tuple(JB.BlockSpec(**dataclasses.asdict(b))
                             for b in cfg.period)
        jp = JT.init_params(JB.ArchConfig(**kw), jax.random.key(int(key)))
        return params_from_numpy(jax.tree.map(np.asarray, jp), device)

    PT.init_params = reference_init
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
""")


def test_train_lm_matches_reference_from_its_parameters(tmp_path):
    flags = ["--steps", "12", "--log-every", "4"]
    port, ref = _run_together(
        [sys.executable, "-c", _PORT_FROM_REFERENCE_INIT,
         *_example("torch_train_lm", *flags, "--device", "cpu", "--out",
                   str(tmp_path / "port.json"))[1:]],
        _example("train_lm", *flags, "--out", str(tmp_path / "ref.json")))

    def kind_of(i, before, line):
        words = before.split()
        last = words[-1] if words else ""
        if last == "gnorm":
            return "norm"
        if last == "loss" or "ratio" in before and \
                before.rstrip().endswith(":"):
            return "rel"
        if "(" in last and line.startswith("loss ratio"):
            return ("gap", 100.0)               # the ratio - 1, in percent
        return "exact"                          # steps, counts, sim times

    _compare(port.replace(str(tmp_path / "port.json"), "OUT"),
             ref.replace(str(tmp_path / "ref.json"), "OUT"), kind_of)
    po = json.loads((tmp_path / "port.json").read_text())
    re_ = json.loads((tmp_path / "ref.json").read_text())
    for arm in ("coded", "baseline"):
        a, b = (np.asarray(po[arm]["losses"]), np.asarray(re_[arm]["losses"]))
        assert a.shape == b.shape == (12,)
        assert np.max(np.abs(a - b) / np.abs(b)) <= RTOL
        assert po[arm]["sim_time_s"] == re_[arm]["sim_time_s"]
    assert abs(po["ratio"] - re_["ratio"]) <= RTOL * abs(re_["ratio"])
    assert po["verdict"] == re_["verdict"] and po["ok"] == re_["ok"]
    for key in ("exact_fraction", "mean_active"):
        assert po["coded"]["meta"][key] == re_["coded"]["meta"][key]


# ---------------------------------------------------------------------------
# The port's CLIs as a user runs them
# ---------------------------------------------------------------------------

def test_experiments_run_cli_matches_reference(tmp_path):
    args = ["--strategies", "coded-gd,uncoded,async", "--delays", "bimodal",
            "--n", "128", "--p", "32", "--m", "8", "--steps", "20",
            "--trials", "2", "--formats", "json"]
    _run_together(
        [sys.executable, "-m", "repro_torch.experiments.run", *args,
         "--device", "cpu", "--out", str(tmp_path / "p")],
        [sys.executable, "-m", "repro.experiments.run", *args, "--out",
         str(tmp_path / "j")])

    def records(d):
        data = json.loads((tmp_path / d / "experiments.json").read_text())
        return data["records"] if isinstance(data, dict) else data

    assert_records_match(records("p"), records("j"))


def test_launch_train_cli_smoke_run(tmp_path):
    flags = ["--arch", "deepseek-7b", "--smoke", "--steps", "3",
             "--seq-len", "32"]
    port, _ = _run_together(
        [sys.executable, "-m", "repro_torch.launch.train", *flags,
         "--device", "cpu", "--history-out", str(tmp_path / "p.json")],
        [sys.executable, "-m", "repro.launch.train", *flags,
         "--history-out", str(tmp_path / "j.json")])
    hist = json.loads((tmp_path / "p.json").read_text())
    ref = json.loads((tmp_path / "j.json").read_text())
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert np.isfinite([h["loss"] for h in hist]).all()
    # the schedule is host work from the same seeds: equal as printed
    assert [h["sim_time_s"] for h in hist] == [r["sim_time_s"] for r in ref]
    assert [h["active"] for h in hist] == [r["active"] for r in ref]
    assert port.strip().splitlines()[-1].startswith("final loss: ")


def test_launch_dryrun_cli_one_record(tmp_path):
    out, = _run_together(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-7b", "--shape", "train_4k", "--quiet", "--out",
         str(tmp_path)])
    assert "[OK] deepseek-7b|train_4k|single" in out
    assert out.strip().endswith("all dry-runs passed")
    rec = json.loads((tmp_path / "deepseek-7b__train_4k__single.json")
                     .read_text())
    assert (rec["arch"], rec["shape"]) == ("deepseek-7b", "train_4k")
    assert "error" not in rec
