"""The realization axis over several devices: the port's sharded runners
against the reference's ``shard_map`` over a ``trials`` mesh axis, on the
CPU.

The reference runs in a subprocess on a forced 4-device CPU mesh
(``--xla_force_host_platform_device_count=4``; the flag must be set before
JAX starts), at R = 8 on the small cell of
``tests/test_experiments.py``'s multi-device test (n 128, p 32, m 8, 12
steps), and saves its problem, schedules and results.  The port's
``_sharded_run`` takes the same problem and schedules over four ``cpu``
entries, the split, the per-device runs and the gather that a host with
four cards takes:
  * realization r equals the reference's to rel 1e-5 (the reference's own
    bound between its sharded and vmapped placements);
  * and the port's batched run bit for bit.
Also: ``trials_device_count``'s rule, the public runners and the harness
with the split forced on, the kernels' launch helper (one card's
operands, the stream of an index-less device).
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.experiments.run as PR
from repro_torch.core.data_parallel import EncodedProblem
from repro_torch.kernels import _build
from repro_torch.obs.trace import TraceRecorder
from repro_torch.runtime import runners

ROOT = Path(__file__).resolve().parents[1]
R, T, NDEV, RTOL = 8, 12, 4, 1e-5
CPUS = ["cpu"] * NDEV

_REFERENCE = textwrap.dedent("""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    assert len(jax.devices()) == 4, jax.devices()
    from repro.core import make_encoded_problem, make_encoder
    from repro.runtime.runners import (sharded_scan_async, sharded_scan_gd,
                                       sharded_scan_prox)
    R, T, n, p, m, k = 8, 12, 128, 32, 8, 6
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, p))
    y = X @ rng.standard_normal(p) + 0.5 * rng.standard_normal(n)
    prob = make_encoded_problem(X, y, make_encoder("hadamard", n, beta=2.0),
                                m, lam=0.05)
    step = 1.0 / (1.3 * np.linalg.eigvalsh(X.T @ X / n).max() + 0.05)
    masks = np.zeros((R, T, m), np.float32)
    for q in range(R):
        for t in range(T):
            masks[q, t, rng.permutation(m)[:k]] = 1.0
    workers = rng.integers(0, m, (R, 4 * T))
    staleness = rng.integers(0, 4, (R, 4 * T))
    w0 = np.zeros((R, p), np.float32)
    out = dict(SX=np.asarray(prob.SX), Sy=np.asarray(prob.Sy),
               X=np.asarray(prob.X), y=np.asarray(prob.y),
               lam=prob.lam, beta=prob.beta, n=prob.n, step=step,
               masks=masks, workers=workers, staleness=staleness)
    runs = {"gd": lambda: sharded_scan_gd(prob, jnp.asarray(masks), step,
                                          jnp.asarray(w0)),
            "prox": lambda: sharded_scan_prox(prob, jnp.asarray(masks),
                                              step, jnp.asarray(w0),
                                              eval_every=2),
            "async": lambda: sharded_scan_async(
                prob, jnp.asarray(workers), jnp.asarray(staleness),
                step / m, jnp.asarray(w0), buffer_size=4)}
    for kind, fn in runs.items():
        w, tr, ndev = fn()
        out[kind + "_w"], out[kind + "_trace"] = np.asarray(w), np.asarray(tr)
        out[kind + "_ndev"] = ndev
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src") + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return dict(np.load(path))


def _problem(ref) -> EncodedProblem:
    return EncodedProblem.from_numpy(
        ref["SX"], ref["Sy"], ref["X"], ref["y"], lam=float(ref["lam"]),
        beta=float(ref["beta"]), n=int(ref["n"]), device="cpu")


def _args(ref, kind):
    """The runner's positional and keyword arguments for ``kind``."""
    step, w0 = float(ref["step"]), torch.zeros((R, ref["SX"].shape[-1]))
    if kind == "async":
        return ((ref["workers"], ref["staleness"], step / ref["SX"].shape[0],
                 w0, 4, "l2", 1), {})
    return ((ref["masks"], step, w0),
            dict(h="l1" if kind == "prox" else "l2",
                 eval_every=2 if kind == "prox" else 1, degrade=None))


def _batched(prob, ref, kind):
    args, kw = _args(ref, kind)
    if kind == "async":
        return runners.batched_scan_async(prob, *args[:5], h=args[5],
                                          eval_every=args[6])
    fn = runners.batched_scan_prox if kind == "prox" else \
        runners.batched_scan_gd
    if kind == "prox":
        kw.pop("h")
    return fn(prob, *args, **kw)


def _rel(out, want):
    out, want = np.asarray(out, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(out - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("kind", ["gd", "prox", "async"])
def test_sharded_run_matches_reference_shard_map(ref, kind):
    """Four ``cpu`` entries against the reference's 4-device mesh: every
    realization of w and of the trace to rel 1e-5."""
    assert int(ref[kind + "_ndev"]) == NDEV
    args, kw = _args(ref, kind)
    w, tr = runners._sharded_run(CPUS, kind, _problem(ref), *args, **kw)
    assert w.shape == ref[kind + "_w"].shape
    assert tr.shape == ref[kind + "_trace"].shape
    for q in range(R):
        assert _rel(w[q], ref[kind + "_w"][q]) <= RTOL, q
        assert _rel(tr[q], ref[kind + "_trace"][q]) <= RTOL, q


@pytest.mark.parametrize("kind", ["gd", "prox", "async"])
@pytest.mark.parametrize("devices", [CPUS, ["cpu"] * 2, ["cpu"] * 8])
def test_sharded_run_equals_batched_bit_for_bit(ref, kind, devices):
    prob = _problem(ref)
    args, kw = _args(ref, kind)
    w, tr = runners._sharded_run(devices, kind, prob, *args, **kw)
    wb, tb = _batched(prob, ref, kind)
    assert torch.equal(w, wb) and torch.equal(tr, tb)


def test_sharded_run_splits_a_step_vector_with_its_chunk(ref):
    prob = _problem(ref)
    steps = np.linspace(0.5, 1.0, R) * float(ref["step"])
    w0 = torch.zeros((R, prob.SX.shape[-1]))
    w, tr = runners._sharded_run(CPUS, "gd", prob, ref["masks"], steps, w0,
                                 h="l2", eval_every=3, degrade=None)
    wb, tb = runners.batched_scan_gd(prob, ref["masks"], steps, w0,
                                     eval_every=3)
    assert torch.equal(w, wb) and torch.equal(tr, tb)
    # each realization keeps its own step size: no two traces coincide
    assert len({tuple(t.tolist()) for t in tr}) == R


def test_sharded_run_refuses_a_ragged_split_and_an_unknown_kind(ref):
    prob = _problem(ref)
    args, kw = _args(ref, "gd")
    with pytest.raises(ValueError, match="do not split evenly"):
        runners._sharded_run(["cpu"] * 3, "gd", prob, *args, **kw)
    with pytest.raises(KeyError, match="unknown sharded runner kind"):
        runners._sharded_run(CPUS, "bcd", prob, *args)


def test_sharded_run_raises_a_chunk_failure(ref, monkeypatch):
    """A chunk that fails raises from the call and is not run again, on
    another device or at all."""
    prob = _problem(ref)
    calls = []

    def failing(p, *a, **kw):
        calls.append(p.device)
        raise RuntimeError("kernel failed on this chunk")
        yield

    monkeypatch.setattr(runners, "_steps", failing)
    args, kw = _args(ref, "gd")
    with pytest.raises(RuntimeError, match="kernel failed"):
        runners._sharded_run(CPUS, "gd", prob, *args, **kw)
    assert calls == [torch.device("cpu")]


def test_sharded_run_enqueues_the_chunks_steps_in_turn(ref, monkeypatch):
    """One host thread, each chunk's step t before any chunk's step t + 1."""
    order = []
    steps = runners._steps

    def tagged(*a, **kw):
        gen = steps(*a, **kw)
        t = 0
        while True:
            try:
                next(gen)
            except StopIteration as done:
                return done.value
            order.append((id(gen), t, threading.get_ident()))
            t += 1
            yield

    monkeypatch.setattr(runners, "_steps", tagged)
    args, kw = _args(ref, "gd")
    runners._sharded_run(CPUS, "gd", _problem(ref), *args, **kw)
    assert len(order) == NDEV * T
    assert {tid for _, _, tid in order} == {threading.get_ident()}
    assert [t for _, t, _ in order] == [t for t in range(T)
                                        for _ in range(NDEV)]
    assert len({g for g, _, _ in order[:NDEV]}) == NDEV


def test_encoded_problem_to_keeps_scalars_and_values(ref):
    prob = _problem(ref)
    moved = prob.to("cpu")
    assert moved.SX is prob.SX and moved.X is prob.X     # no copy in place
    assert (moved.lam, moved.beta, moved.n) == (prob.lam, prob.beta, prob.n)
    meta = prob.to("meta")
    assert meta.device == torch.device("meta")
    assert meta.y.device.type == meta.Sy.device.type == "meta"
    assert meta.SX.shape == prob.SX.shape


# ---------------------------------------------------------------------------
# trials_device_count and the public runners
# ---------------------------------------------------------------------------

def test_trials_device_count_follows_the_reference_rule(monkeypatch):
    assert runners.trials_device_count(8, "cpu") == 1
    assert runners.trials_device_count(8, torch.device("cpu")) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert runners.trials_device_count(8) == 4
    assert runners.trials_device_count(8, "cuda") == 4
    assert runners.trials_device_count(8, "cuda:0") == 4
    assert runners.trials_device_count(6) == 1          # 4 does not divide
    assert runners.trials_device_count(8, "cpu") == 1   # a CPU problem
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runners.trials_device_count(8) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert runners.trials_device_count(8) == 1


@pytest.fixture
def four_way(monkeypatch):
    """The public runners' split forced on over four ``cpu`` entries."""
    monkeypatch.setattr(runners, "trials_device_count",
                        lambda trials, device=None: NDEV
                        if trials % NDEV == 0 else 1)
    monkeypatch.setattr(runners, "_visible_cards", lambda ndev: ["cpu"] * ndev)


@pytest.mark.parametrize("kind", ["gd", "prox", "async"])
def test_public_sharded_runners_split_and_name_their_span(ref, kind,
                                                          four_way):
    prob = _problem(ref)
    args, kw = _args(ref, kind)
    rec = TraceRecorder()
    with rec.activate():
        if kind == "async":
            w, tr, ndev = runners.sharded_scan_async(
                prob, *args[:5], h=args[5], eval_every=args[6])
        elif kind == "prox":
            kw.pop("h")
            w, tr, ndev = runners.sharded_scan_prox(prob, *args, **kw)
        else:
            w, tr, ndev = runners.sharded_scan_gd(prob, *args, **kw)
    assert ndev == NDEV
    names = {e.name for e in rec.spans()}
    assert f"runner:sharded_{kind}" in names, names
    wb, tb = _batched(prob, ref, kind)
    assert torch.equal(w, wb) and torch.equal(tr, tb)


def test_public_sharded_runner_falls_back_to_the_batched_run(ref):
    """On the CPU (one device) the public runner is the batched run."""
    prob = _problem(ref)
    args, kw = _args(ref, "gd")
    w, tr, ndev = runners.sharded_scan_gd(prob, *args, **kw)
    wb, tb = _batched(prob, ref, "gd")
    assert ndev == 1 and torch.equal(w, wb) and torch.equal(tr, tb)


# ---------------------------------------------------------------------------
# The harness: --placement sharded through experiments.run
# ---------------------------------------------------------------------------

HARNESS = ["--strategies", "coded-gd,async,coded-bcd", "--delays", "bimodal",
           "--n", "128", "--p", "32", "--m", "8", "--steps", "12",
           "--trials", "8", "--device", "cpu", "--formats", "json"]


def _records(tmp_path, placement, name):
    res = PR.main(HARNESS + ["--placement", placement, "--out",
                             str(tmp_path / name)])
    return {r["strategy"]: r for r in res.records}


@pytest.mark.parametrize("forced", [False, True])
def test_experiments_run_sharded_records_its_devices(tmp_path, monkeypatch,
                                                     forced, capsys):
    if forced:
        monkeypatch.setattr(runners, "trials_device_count",
                            lambda trials, device=None: NDEV)
        monkeypatch.setattr(runners, "_visible_cards",
                            lambda ndev: ["cpu"] * ndev)
    vmap = _records(tmp_path, "vmap", "v")
    sharded = _records(tmp_path, "sharded", "s")
    for name in ("coded-gd", "async"):
        meta = sharded[name]["meta"]
        assert meta["placement"] == "sharded"
        assert meta["placement_devices"] == (NDEV if forced else 1)
        assert sharded[name]["objective"] == vmap[name]["objective"]
        assert sharded[name]["times"] == vmap[name]["times"]
    # the lifted BCD problem stays on one device, with the reference's note
    bcd = sharded["coded-bcd"]["meta"]
    assert bcd["placement"] == "vmap" and "placement_fallback" in bcd
    assert sharded["coded-bcd"]["objective"] == vmap["coded-bcd"]["objective"]
    saved = json.loads((tmp_path / "s" / "experiments.json").read_text())
    assert any(r.get("meta", {}).get("placement_devices") for r in
               (saved["records"] if isinstance(saved, dict) else saved))
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The kernels' launch helper
# ---------------------------------------------------------------------------

def test_stream_of_resolves_an_index_less_device(monkeypatch):
    asked = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: asked.append(index) or 1000 + index,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert _build.stream_of(torch.device("cuda")) == 1003
    assert _build.stream_of(torch.device("cuda", 1)) == 1001
    assert asked == [3, 1]


def test_operands_on_two_devices_raise_naming_both():
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    assert _build.operands_device(a, a) == torch.device("cpu")
    with pytest.raises(ValueError) as e:
        _build.operands_device(a, a, b)
    assert "cpu" in str(e.value) and "meta" in str(e.value)
    with pytest.raises(ValueError, match="cpu and meta"):
        _build.launch("k", lambda *a: 0, (a, b), 1, 2)

