#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. device  - probe CUDA (exit 2 without a card), print the card's name and
             power limit;
2. build   - compile the CUDA kernels from src/repro_torch/kernels/csrc
             (the build's host time as ``obs.CompileWatch`` splits it);
3. kernels - hold every kernel against its plain PyTorch version on the
             card at the main path's shapes (FWHT (6001, 8192); SRHT full
             frame and one worker window of the (4096, 6001) data; fused
             gradient at (32, 256, 6000), single, batched R = 4, all
             masked, and batched row r == single call r bit for bit, also
             at R = 4 and R = 16 with one worker masked out in every
             realization and one realization all-masked; coded combine at
             (32, 6000) in float32 and bfloat16 and at the odd width
             (8, 6001), (m,) and (m, 1) weights bit for bit, all masked;
             the kernels' realization tile and row groups equal the
             wrappers' Python choices);
4. main    - the paper's ridge problem at its published size (PAPER_RIDGE:
             n = 4096, p = 6000, m = 32, k = 24, beta = 2, bimodal delays)
             through the strategy entry points: coded-gd ``run`` and
             ``run_batched(trials=4, eval_every=10)`` with the fast-Hadamard
             encoder, coded-prox on the l1 problem, one encode, decode_t and
             one aligned worker block; then the paper's own algorithm for
             this configuration, coded-lbfgs ``run`` (50 steps, memory 10)
             and ``run_batched(trials=2)``, one coded-bcd run on the lifted
             (feature-encoded) problem and one async run.  Launch counts
             are cleared just before each of these paths and read just
             after, and each path must launch exactly its own kernels (one
             fused launch a GD / ISTA step, one combine an L-BFGS step, none
             for async); the objectives must be finite and fall, and the
             card's coded-gd trace and the first 20 steps of its coded-lbfgs
             trace must match the port's own CPU run on the same encoded
             problem and masks;
   workloads - the paper's §5 workload zoo through ``get_workload(name)``:
             ridge at its published size (the ``paper`` preset, Fig. 7's
             three arms: ``run_trials("coded", trials=2, eval_every=10,
             encoder="fast-hadamard")``, which is coded-lbfgs, and
             ``run("replication")`` / ``run("uncoded")``, GD), the gap
             falling on each, and ``run("coded", encoder="fast-hadamard")``
             equal bit for bit to the direct ``coded-lbfgs`` strategy run;
             LASSO (coded-prox), logistic (coded-bcd, default and
             fast-Hadamard encoders) and matrix factorization (coded-lbfgs
             ALS) at their ``bench`` presets, on the card and again on the
             CPU, held to the CPU tests' tolerances.  Each prints its host
             clock split into data build, ground truth, run (and the
             run's encode) and scoring (obs spans) and the device's busy
             share of a profiled second run.  Every workload path is
             driven with the launch counts cleared just before and must
             launch exactly its kernels.  The phase also prints the sizes
             that keep LASSO and logistic ``paper`` off one card and MF
             ``paper``'s own MemoryError;
   harness - the experiment harness and its CLIs, each ``main(argv)``
             called in-process with the launch counts cleared just before
             and read just after: (a) ``repro_torch.runtime.compare`` at
             PAPER_RIDGE's width (coded-gd, coded-lbfgs, uncoded,
             replication x bimodal, exponential; fast-Hadamard encoder, 4
             realizations, 100 steps), one call a cell, each launching its
             own kernels, and the coded-gd cells again under REPRO_FUSED=0
             (the combine path, no fused launch, traces equal to the fused
             ones to rel 1e-4), each cell's host seconds split by
             ``obs.CompileWatch``; (b) Fig. 7 as a Monte-Carlo summary:
             ``repro_torch.workloads.run --workload ridge --preset paper
             --strategies coded,replication,uncoded --trials 32``, each
             arm's final gap and simulated wall-clock as median and
             p10-p90 over the realizations, and the wall-clock each arm
             takes to reach a common gap (reported, not gated), then
             ``--workload logistic --preset bench --strategies coded
             --encoder fast-hadamard`` on the card (one SRHT lift, one FWHT
             decode a chunk) and the CPU, objectives to rel 1e-5; (c)
             ``repro_torch.experiments.run`` on a small synthetic spec into
             a run store, on the card and with ``--device cpu``; the card
             run cut after cell 0 (later cell files deleted, manifest
             marked running) and ``--resume``d to the same records and a
             byte-identical JSON; ``repro_torch.obs.diff`` of the card run
             against the CPU run exits 0, and every cell's final objective
             matches the CPU's to rel 1e-4;
5. times   - each kernel (CUDA events, after warm-up) beside its bound, its
             plain version and, where one exists, one PyTorch call for the
             same function (the fused gradient also batched at R = 4 and
             R = 16; the combine also by the profiler's device time, and at
             (32, 4194304), the coded-SGD flat gradient's width); step
             times (CUDA events around a 100-step GD loop, a 50-step L-BFGS
             loop, the 20-step BCD loop and the 320-update async loop, five
             repetitions after a warm-up, every sample printed) and encode
             times (host clock, three repetitions); the profiler's
             breakdown of each step; peak device memory.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # float32 outside the tensor cores

ROOT = Path(__file__).resolve().parent


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over the memory rate
    and operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def samples_ms(fn, reps: int, warmup: int = 1) -> list[float]:
    """Device-clock time of each of ``reps`` calls of ``fn`` (CUDA events
    around each call, after warm-up).  The events sit on the stream, so a
    call's host launch gaps count, as they do for the user."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def spread(xs: list[float], unit: str, digits: int = 4) -> str:
    """'median (min-max; all samples)' of a list of times."""
    s = sorted(xs)
    return (f"{s[len(s) // 2]:.{digits}f} {unit} (min {s[0]:.{digits}f}, "
            f"max {s[-1]:.{digits}f}; samples "
            f"{', '.join(f'{x:.{digits}f}' for x in xs)})")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events after warm-up.  Every operand here is larger than the 50 MB L2,
    so each call finds its inputs in device memory, as the main path does."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the profiler's device time of
    every kernel and copy that ``reps`` calls launch, over ``reps``.  Host
    launch gaps are excluded, so for a launch-bound call this is the card's
    share and ``time_ms`` the caller's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0)
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3


def profile_device(fn) -> tuple[float, list]:
    """(wall us, [(device us, count, kernel name), ...] largest first) of
    one call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0:
            rows.append((us, ev.count, ev.key))
    return wall_us, sorted(rows, reverse=True)


def device_breakdown(fn, label: str) -> None:
    """Print where the device time of ``fn`` goes, kernel by kernel, from
    ``torch.profiler``, and the device's idle share of the wall time."""
    wall_us, rows = profile_device(fn)
    if not rows:
        print(f"profile {label}: the profiler recorded no device time")
        return
    busy = sum(r[0] for r in rows)
    print(f"profile {label}: wall {wall_us:.0f} us, device busy {busy:.0f} us"
          f" (idle share {max(0.0, 1 - busy / wall_us):.2f})")
    for us, count, key in rows[:8]:
        print(f"  {us:10.1f} us {count:5d}x  {key[:90]}")


def rel_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, that over max |ref|)."""
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return err, err / max(scale, 1e-30)


# the workload presets the workloads phase runs: ridge at its published
# size; LASSO, logistic and MF at the reference's own bench presets (their
# paper-size data does not fit one card: PERF.md §4)
WORKLOAD_PRESETS = {"ridge": "paper", "lasso": "bench", "logistic": "bench",
                    "mf": "bench"}


def timed(fn):
    """(result, host seconds, host seconds by obs span name) of one call of
    ``fn`` under a fresh obs recorder, the device synchronised before the
    clock stops."""
    import torch
    from repro_torch.obs import TraceRecorder
    rec = TraceRecorder()
    with rec.activate():
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans: dict[str, float] = {}
    for ev in rec.spans():
        spans[ev.name] = spans.get(ev.name, 0.0) + ev.dur
    return out, wall, spans


def device_share(fn) -> float:
    """The device's busy share of one profiled call of ``fn``."""
    wall_us, rows = profile_device(fn)
    return sum(r[0] for r in rows) / wall_us


def host_split(build_spans: dict, run_s: float, run_spans: dict) -> str:
    """Data build / ground truth / run / scoring host seconds of a cell;
    the run's share spent encoding (the strategies' ``encode`` spans: once
    a run, once a chunk or half-step where the workload re-runs its
    strategy) is given beside it."""
    score = run_spans.get("workload:score", 0.0)
    return (f"host s: data {build_spans.get('workload:data', 0.0):.3f}, "
            f"ground truth {build_spans.get('workload:ground_truth', 0.0):.3f}"
            f", run {run_s - score:.3f} (encode "
            f"{run_spans.get('encode', 0.0):.3f}), scoring {score:.4f}")


def workloads_phase(dev, smi: str, drive) -> None:
    """Paper §5's workloads through ``get_workload(name).run`` /
    ``run_trials`` (module docstring, phase "workloads"); ``drive`` runs
    one path with the launch counts cleared just before and read just
    after, and requires its kernels."""
    import numpy as np
    from repro_torch.core import hadamard_ensemble
    from repro_torch.kernels.fused_step import MAX_COLS
    from repro_torch.kernels.fwht import MAX_ONE_PASS
    from repro_torch.runtime import get_strategy
    from repro_torch.workloads import get_workload
    fused, srht, fwht, comb = ("fused_masked_gradient", "srht_encode",
                               "fwht", "coded_combine")
    t_phase = time.perf_counter()

    # the paper presets this phase leaves off the card, sized from the
    # presets; MF's own guard raised from its entry point
    ps = get_workload("lasso").preset("paper")
    n, p = ps.dims["n"], ps.dims["p"]
    N = hadamard_ensemble(n, 2.0, 0)[0]
    print(f"lasso paper (n, p) = ({n}, {p}): X float64 {n * p * 8 / 1e9:.1f}"
          f" GB on the host, S X ({N}, {p}) float32 {N * p * 4 / 1e9:.1f} GB "
          f"on the card; p > {MAX_COLS} (fused), N > {MAX_ONE_PASS} (SRHT)")
    ps = get_workload("logistic").preset("paper")
    n, p = ps.dims["n"], ps.dims["p"]
    n_train = n - int(round(n * ps.dims["test_frac"]))
    N = hadamard_ensemble(p, 2.0, 0)[0]
    print(f"logistic paper (n, p) = ({n}, {p}): X float32 "
          f"{n * p * 4 / 1e9:.1f} GB, lifted blocks X S^T ({n_train}, {N}) "
          f"float32 {n_train * N * 4 / 1e9:.1f} GB on the card")
    try:
        get_workload("mf").run("coded", preset="paper", device=dev)
    except MemoryError as exc:
        print(f"mf paper: MemoryError from run(): {exc}")
    else:
        raise SmokeFailure("mf paper: the dense design's guard did not raise")

    # ridge: Fig. 7's three arms at the published size
    wl = get_workload("ridge")
    ps = wl.preset(WORKLOAD_PRESETS["ridge"])
    data, build_s, build_spans = timed(lambda: wl.build(ps))
    X = data.spec.X
    print(f"workload ridge {ps.name}: X {X.shape}, m {ps.m}, k {ps.k}, "
          f"{ps.steps} steps, f* {data.f_star:.6g}; build {build_s:.2f} s "
          f"host clock")
    T, R, had = ps.steps, 2, dict(encoder="fast-hadamard")
    arms = (
        ("ridge coded run_trials", lambda: wl.run_trials(
            "coded", preset=ps, data=data, trials=R, eval_every=10,
            device=dev, **had), {comb: R * T, srht: 1}),
        ("ridge replication run", lambda: wl.run(
            "replication", preset=ps, data=data, device=dev), {fused: T}),
        ("ridge uncoded run", lambda: wl.run(
            "uncoded", preset=ps, data=data, device=dev), {fused: T}),
    )
    for label, fn, expect in arms:
        out, run_s, spans = timed(lambda: drive(label, fn, expect))
        for q, res in enumerate(out if isinstance(out, list) else [out]):
            gap = np.asarray(res.metric)
            require(np.isfinite(gap).all() and gap[-1] < gap[0],
                    f"{label} [{q}]: the gap did not fall: {gap[0]:.4g} -> "
                    f"{gap[-1]:.4g}")
            print(f"{label} [{q}] ({res.strategy}): gap {gap[0]:.6g} -> "
                  f"{gap[-1]:.6g}, final rel gap "
                  f"{res.meta['final_rel_subopt']:.3e}, simulated "
                  f"{res.wallclock:.3f} s")
        print(f"{label}: {host_split(build_spans, run_s, spans)}; device "
              f"busy share {device_share(fn):.3f}  [{smi}]")
    # the workload adds no arithmetic: its coded run is the strategy's
    via_wl = drive("ridge coded run", lambda: wl.run(
        "coded", preset=ps, data=data, device=dev, **had),
        {comb: T, srht: 1})
    direct = drive("coded-lbfgs run (direct)", lambda: get_strategy(
        "coded-lbfgs").run(data.spec, wl.default_engine(ps), steps=T,
                           k=ps.k, device=dev, **had), {comb: T, srht: 1})
    require(np.array_equal(via_wl.objective, direct.objective) and
            np.array_equal(via_wl.w, direct.w) and
            np.array_equal(via_wl.times, direct.times),
            "ridge run('coded') != get_strategy('coded-lbfgs').run")
    print("ridge run('coded', encoder='fast-hadamard') == "
          "get_strategy('coded-lbfgs').run(...): objective, w and times bit "
          "for bit")

    # LASSO, logistic (both encoders) and MF: the card against the CPU
    cells = (("lasso", "coded", {}, lambda p: {fused: p.steps}),
             ("logistic", "coded", {}, lambda p: {}),
             ("logistic", "coded", had,
              lambda p: {srht: 1, fwht: p.dims["records"]}),
             ("mf", "coded", {}, lambda p: {comb: 2 * p.dims["epochs"]
                                            * p.steps}))
    for name, strategy, cfg, expect in cells:
        wl = get_workload(name)
        ps = wl.preset(WORKLOAD_PRESETS[name])
        data, build_s, build_spans = timed(lambda: wl.build(ps))
        label = f"{name} {ps.name} {wl.resolve_strategy(strategy)}" + \
            (f" {cfg['encoder']}" if cfg else "")

        def run(device):
            return wl.run(strategy, preset=ps, data=data, device=device,
                          **cfg)
        gpu, run_s, spans = timed(lambda: drive(label, lambda: run(dev),
                                                expect(ps)))
        t0 = time.perf_counter()
        cpu = run("cpu")
        cpu_s = time.perf_counter() - t0
        require(np.array_equal(gpu.times, cpu.times), f"{label}: times")
        obj_tol = 1e-4 if gpu.strategy == "coded-lbfgs" else 1e-5
        go, co = np.asarray(gpu.objective), np.asarray(cpu.objective)
        obj_rel = float(np.max(np.abs(go - co)) / np.max(np.abs(co)))
        require(np.isfinite(go).all() and obj_rel <= obj_tol,
                f"{label}: card objective vs CPU rel {obj_rel:.2e}")
        gm, cm = np.asarray(gpu.metric), np.asarray(cpu.metric)
        if name == "mf":          # test RMSE
            met_rel = float(np.max(np.abs(gm - cm)) / np.max(np.abs(cm)))
            require(met_rel <= 1e-4, f"{label}: RMSE rel {met_rel:.2e}")
            met = f"rel {met_rel:.2e} (tol 1e-4)"
        else:                     # LASSO F1, logistic test error
            require(np.array_equal(gm, cm), f"{label}: {gpu.metric_name} "
                                            f"{gm} != CPU {cm}")
            met = "equal at every record"
        print(f"{label}: {gpu.metric_name} card {gpu.final_metric:.6g}, CPU "
              f"{cpu.final_metric:.6g} ({met}); objective "
              f"{go[0]:.6g} -> {go[-1]:.6g}, card vs CPU rel {obj_rel:.2e} "
              f"(tol {obj_tol:.0e}); simulated {gpu.wallclock:.3f} s")
        print(f"{label}: {host_split(build_spans, run_s, spans)}; CPU run "
              f"{cpu_s:.3f} s; device busy share "
              f"{device_share(lambda: run(dev)):.3f}  [{smi}]")
    print(f"workloads phase: {time.perf_counter() - t_phase:.1f} s host "
          f"clock")


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept off this script's (the
    CLIs print their own tables); returns (result, captured text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@contextlib.contextmanager
def env_var(name: str, value: str):
    """Set one environment variable for the block, then restore it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def pctl(xs) -> str:
    """'median (p10-p90)' of a list of numbers."""
    import numpy as np
    a = np.asarray(xs, dtype=float)
    return (f"{np.median(a):.6g} (p10 {np.percentile(a, 10):.6g}, p90 "
            f"{np.percentile(a, 90):.6g})")


def rel_max(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def harness_phase(cfg, smi: str, drive) -> None:
    """The experiment harness and its CLIs (module docstring, phase
    "harness"); ``drive`` runs one CLI call with the launch counts cleared
    just before and read just after, and requires its kernels."""
    import shutil

    import numpy as np
    from repro_torch.experiments.run import main as exp_main
    from repro_torch.obs import CompileWatch, RunStore
    from repro_torch.obs.diff import main as diff_main
    from repro_torch.runtime.compare import main as compare_main
    from repro_torch.workloads import get_workload
    from repro_torch.workloads.runner import main as workloads_main
    fused, srht, fwht, comb = ("fused_masked_gradient", "srht_encode",
                               "fwht", "coded_combine")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_harness_"))

    # (a) the compare CLI at PAPER_RIDGE's width, one call a cell
    S, R = 100, 4
    base = ["--n", str(cfg.n), "--p", str(cfg.p), "--m", str(cfg.m),
            "--k", str(cfg.k[1]), "--lam", str(cfg.lam), "--encoder",
            "fast-hadamard", "--trials", str(R), "--steps", str(S),
            "--formats", "json"]
    expect = {"coded-gd": {fused: S, srht: 1},
              "coded-lbfgs": {comb: S * R, srht: 1},
              "uncoded": {fused: S}, "replication": {fused: S}}
    traces = {}
    cells = [(st, d, "1") for d in ("bimodal", "exponential")
             for st in expect] + \
        [("coded-gd", d, "0") for d in ("bimodal", "exponential")]
    for st, delay, fused_env in cells:
        label = f"compare {st} x {delay}" + \
            (" REPRO_FUSED=0" if fused_env == "0" else "")
        want = expect[st] if fused_env == "1" else {comb: S * R, srht: 1}
        argv = base + ["--strategies", st, "--delays", delay, "--out",
                       str(tmp / "compare")]
        with env_var("REPRO_FUSED", fused_env), CompileWatch() as cw:
            (rec,), _ = drive(label, lambda: quiet(compare_main, argv), want)
        obj = np.asarray(rec["objective"])
        require(obj.shape == (R, S) and np.isfinite(obj).all() and
                (obj[:, -1] < obj[:, 0]).all(),
                f"{label}: objective {obj.shape} not finite or not falling")
        traces[(st, delay, fused_env)] = obj
        print(f"{label}: final objective {pctl(obj[:, -1])}, simulated "
              f"{pctl(np.asarray(rec['times'])[:, -1])} s; host_s "
              f"{cw.total_s:.3f}, compile_s {cw.compile_s:.3f}, execute_s "
              f"{cw.execute_s:.3f}, compiles {cw.compiles}  [{smi}]")
    for delay in ("bimodal", "exponential"):
        rel = rel_max(traces[("coded-gd", delay, "0")],
                      traces[("coded-gd", delay, "1")])
        require(rel <= 1e-4, f"coded-gd x {delay}: REPRO_FUSED=0 trace vs "
                             f"fused rel {rel:.2e}")
        print(f"compare coded-gd x {delay}: REPRO_FUSED=0 (combine) trace "
              f"vs fused: max rel diff {rel:.2e} (tol 1e-4)")

    # (b) Fig. 7 as a Monte-Carlo summary over the realizations
    RF = 32
    T = get_workload("ridge").preset("paper").steps
    argv = ["--workload", "ridge", "--preset", "paper", "--strategies",
            "coded,replication,uncoded", "--trials", str(RF), "--out",
            str(tmp / "fig7"), "--formats", "json"]
    with CompileWatch() as cw:
        recs, _ = drive("fig7 workloads.run ridge paper", lambda: quiet(
            workloads_main, argv), {comb: RF * T, fused: 2 * T})
    finals = {}
    for rec in recs:
        gaps = np.asarray(rec["metric"])
        times = np.asarray(rec["times"])
        require(gaps.shape == (RF, T) and np.isfinite(gaps).all() and
                (gaps[:, -1] < gaps[:, 0]).all(),
                f"fig7 {rec['strategy']}: gaps {gaps.shape} not finite or "
                f"not falling")
        finals[rec["strategy"]] = (gaps, times)
        print(f"fig7 {rec['strategy']} (R = {RF}, {T} steps): final gap "
              f"{pctl(gaps[:, -1])}; simulated wall-clock to reach it "
              f"{pctl(times[:, -1])} s")
    target = max(float(np.median(g[:, -1])) for g, _ in finals.values())
    for name, (gaps, times) in finals.items():
        hit = [float(t[np.argmax(g <= target)]) if (g <= target).any()
               else float("inf") for g, t in zip(gaps, times)]
        print(f"fig7 {name}: simulated wall-clock to reach gap "
              f"{target:.6g} (the largest median final gap): {pctl(hit)} s;"
              f" reached by {sum(np.isfinite(hit))}/{RF}")
    print(f"fig7: host_s {cw.total_s:.3f}, compile_s {cw.compile_s:.3f}, "
          f"execute_s {cw.execute_s:.3f}  [{smi}]")

    # logistic under the fast-Hadamard encoder: the SRHT lift and one FWHT
    # decode a chunk, on the card and on the CPU
    records = get_workload("logistic").preset("bench").dims["records"]
    argv = ["--workload", "logistic", "--preset", "bench", "--strategies",
            "coded", "--encoder", "fast-hadamard", "--formats", "json"]
    with CompileWatch() as cw:
        (lg,), _ = drive("workloads.run logistic bench fast-hadamard",
                         lambda: quiet(workloads_main, argv + [
                             "--out", str(tmp / "logistic")]),
                         {srht: 1, fwht: records})
    (lc,), _ = quiet(workloads_main, argv + ["--out", str(tmp / "lg_cpu"),
                                             "--device", "cpu"])
    go, co = np.asarray(lg["objective"]), np.asarray(lc["objective"])
    rel = float(np.max(np.abs(go - co)) / np.max(np.abs(co)))
    require(lg["times"] == lc["times"] and np.isfinite(go).all() and
            rel <= 1e-5, f"workloads.run logistic fast-hadamard: card vs CPU "
                         f"objective rel {rel:.2e}")
    print(f"workloads.run logistic bench {lg['strategy']} fast-hadamard: "
          f"test error {lg['final_metric']:.6g}, card vs CPU objective rel "
          f"{rel:.2e} (tol 1e-5); host_s {cw.total_s:.3f}, compile_s "
          f"{cw.compile_s:.3f}, execute_s {cw.execute_s:.3f}  [{smi}]")

    # (c) a run store: card run, CPU run, a cut and resumed card run, diff
    store_root = tmp / "store"
    argv = ["--strategies", "coded-gd,coded-lbfgs,uncoded,replication,async",
            "--delays", "bimodal,exponential", "--n", "512", "--p", "128",
            "--m", "16", "--steps", "40", "--trials", "2", "--encoder",
            "fast-hadamard", "--formats", "json"]
    pl = quiet(exp_main, argv + ["--plan-only"])[0].plan
    per_cell = {"coded-gd": {fused: 40, srht: 1},
                "coded-lbfgs": {comb: 80, srht: 1},
                "uncoded": {fused: 40}, "replication": {fused: 40},
                "async": {}}

    def launches_of(cells):
        total: dict[str, int] = {}
        for c in cells:
            for kn, v in per_cell[c.resolved_strategy].items():
                total[kn] = total.get(kn, 0) + v
        return total

    with env_var("REPRO_RUNSTORE", str(store_root)):
        card, _ = drive("experiments.run card", lambda: quiet(
            exp_main, argv + ["--out", str(tmp / "card")]),
            launches_of(pl.cells))
        cpu, _ = drive("experiments.run --device cpu", lambda: quiet(
            exp_main, argv + ["--out", str(tmp / "cpu"), "--device",
                              "cpu"]), {})
        store = RunStore(str(store_root))
        require(card.run_id and cpu.run_id, "runs not recorded")
        require(store.load(card.run_id)["backend"] == "cuda" and
                store.load(cpu.run_id)["backend"] == "cpu",
                "manifest backends")
        # stop the card run after cell 0, as a killed matrix leaves it
        cdir = Path(store.cells_dir(card.run_id))
        for f in sorted(cdir.glob("*.json"))[1:]:
            f.unlink()
        mpath = Path(store.manifest_path(card.run_id))
        manifest = json.loads(mpath.read_text())
        manifest["status"] = "running"
        mpath.write_text(json.dumps(manifest))
        resumed, _ = drive("experiments.run --resume", lambda: quiet(
            exp_main, argv + ["--out", str(tmp / "resumed"), "--resume",
                              card.run_id]), launches_of(pl.cells[1:]))
        require(resumed.records == card.records,
                "resumed records != the uninterrupted run's")
        a = (tmp / "card" / "experiments.json").read_bytes()
        b = (tmp / "resumed" / "experiments.json").read_bytes()
        require(a == b, "resumed experiments.json is not byte-identical")
        rc, diff_out = quiet(diff_main, [card.run_id, cpu.run_id, "--store",
                                         str(store_root)])
        require(rc == 0, f"obs.diff card vs CPU exit {rc}:\n{diff_out}")
    worst = 0.0
    for g, c in zip(card.records, cpu.records):
        require(("skipped" in g) == ("skipped" in c), "skips differ")
        if "skipped" in c:
            continue
        require(g["times"] == c["times"], f"{g['strategy']}: times differ")
        rel = abs(g["final_objective"] - c["final_objective"]) / \
            abs(c["final_objective"])
        require(rel <= 1e-4, f"{g['strategy']} x {g['delay']}: card final "
                             f"objective vs CPU rel {rel:.2e}")
        worst = max(worst, rel)
    print(f"harness store: {len(pl.cells)} cells on the card and the CPU; "
          f"resumed after cell 0: records equal, experiments.json "
          f"byte-identical ({len(a)} bytes); obs.diff card vs CPU exit 0; "
          f"final objectives card vs CPU max rel {worst:.2e} (tol 1e-4)")
    shutil.rmtree(tmp)
    print(f"harness phase: {time.perf_counter() - t_phase:.1f} s host "
          f"clock")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import PAPER_RIDGE as cfg
    from repro_torch.core import (EncodedProblem, FastHadamardEncoder,
                                  bimodal_delays, hadamard_ensemble,
                                  hadamard_matrix, make_encoded_problem,
                                  make_encoder, make_lifted_problem,
                                  phi_quadratic, run_encoded_lbfgs)
    from repro_torch.kernels import _build
    from repro_torch.kernels.coded_reduce import (coded_combine_call,
                                                  coded_combine_ref,
                                                  combine_row_groups)
    from repro_torch.kernels.encode import srht_encode_call, srht_encode_plain
    from repro_torch.kernels.fused_step import (
        MAX_COLS, fused_masked_gradient, fused_masked_gradient_plain,
        pick_fused_realization_tile)
    from repro_torch.kernels.fwht import fwht_kernel_call, fwht_plain
    from repro_torch.kernels.ref import fused_masked_gradient_ref
    from repro_torch.obs import CompileWatch
    from repro_torch.runtime import (ClusterEngine, FastestK, ProblemSpec,
                                     batched_scan_gd, get_strategy,
                                     scan_async, scan_bcd, scan_gd)

    # 1. device --------------------------------------------------------------
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products
    torch.backends.cudnn.allow_tf32 = False

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    with CompileWatch() as cw:
        _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{_build.library_path().name}; obs.CompileWatch: compile_s "
          f"{cw.compile_s:.1f}, compiles {cw.compiles}")
    log = _build.library_path().with_suffix(".log")
    if log.exists():      # absent when an earlier process built the library
        text = log.read_text()
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", text))
        print(f"ptxas: {len(regs)} kernel instantiations, at most "
              f"{max(regs, default=0)} registers a thread, {spills} bytes "
              f"of spills")

    gen = torch.Generator(device=dev).manual_seed(0)
    n, p, m = cfg.n, cfg.p, cfg.m
    k = cfg.k[1]                                    # 24 of 32
    N, cols, signs = hadamard_ensemble(n, cfg.beta, 0)
    r = N // m
    table = {}

    # 3. kernels against their plain versions --------------------------------
    # FWHT at decode_t's shape: the (p + 1)-column encoded frame, transposed
    x = torch.randn((p + 1, N), device=dev, generator=gen)
    err, rel = rel_err(fwht_kernel_call(x), fwht_plain(x))
    # f32 butterflies of 13 stages summed in another stage order
    require(rel <= 1e-5, f"fwht: max|d| {err:.3e} = {rel:.2e} max|ref|")
    print(f"check fwht {tuple(x.shape)}: max|d| {err:.3e} "
          f"({rel:.2e} of max|ref|, tol 1e-5)")
    table["fwht"] = {"max_abs_err": err}

    # SRHT of the (n, p + 1) data: full frame and worker 5's window
    X = torch.randn((n, p + 1), device=dev, generator=gen)
    xt = X.t().contiguous()
    cols_t = torch.as_tensor(cols.astype(np.int32), device=dev)
    signs_t = torch.as_tensor(signs.astype(np.float32), device=dev)
    scale = 1.0 / math.sqrt(n)
    srht_err = 0.0
    for lo, hi in ((0, N), (5 * r, 6 * r)):
        kw = dict(N=N, lo=lo, hi=hi, scale=scale)
        err, rel = rel_err(srht_encode_call(xt, cols_t, signs_t, **kw),
                           srht_encode_plain(xt, cols_t, signs_t, **kw))
        require(rel <= 1e-5, f"srht [{lo},{hi}): max|d| {err:.3e} = "
                             f"{rel:.2e} max|ref|")
        print(f"check srht window [{lo}, {hi}): max|d| {err:.3e} "
              f"({rel:.2e} of max|ref|, tol 1e-5)")
        srht_err = max(srht_err, err)
    table["srht_encode"] = {"max_abs_err": srht_err}

    # fused gradient at the slice's shapes
    SX = torch.randn((m, r, p), device=dev, generator=gen)
    Sy = torch.randn((m, r), device=dev, generator=gen)
    rng = np.random.default_rng(0)

    def fastest_mask(R):
        masks = np.zeros((R, m), np.float32)
        for q in range(R):
            masks[q, rng.permutation(m)[:k]] = 1.0
        return torch.as_tensor(masks, device=dev)

    w = torch.randn(p, device=dev, generator=gen) * 0.01
    mask = fastest_mask(1)[0]
    W4 = torch.randn((4, p), device=dev, generator=gen) * 0.01
    masks4 = fastest_mask(4)
    fkw = dict(n=n, beta=cfg.beta)
    g1 = fused_masked_gradient(SX, Sy, w, mask, **fkw)
    err1, rel1 = rel_err(g1, fused_masked_gradient_plain(SX, Sy, w[None],
                                                         mask[None],
                                                         **fkw)[0])
    g4 = fused_masked_gradient(SX, Sy, W4, masks4, **fkw)
    err4, rel4 = rel_err(g4, fused_masked_gradient_plain(SX, Sy, W4, masks4,
                                                         **fkw))
    # f32 sums of 6000 (matvec) and 8192 (row) terms in another order
    require(max(rel1, rel4) <= 1e-4,
            f"fused: rel err {rel1:.2e} / {rel4:.2e}")
    for q in range(4):
        require(torch.equal(g4[q], fused_masked_gradient(
            SX, Sy, W4[q], masks4[q], **fkw)),
            f"fused: batched row {q} != single call")
    zero = fused_masked_gradient(SX, Sy, w, torch.zeros_like(mask), **fkw)
    require(torch.count_nonzero(zero) == 0, "fused: all-masked != 0")
    print(f"check fused single: max|d| {err1:.3e} ({rel1:.2e} of max|ref|, "
          f"tol 1e-4); batched R=4: max|d| {err4:.3e} ({rel4:.2e}); "
          f"batched[r] == single(r) bitwise; all-masked == 0")
    fused_err = max(err1, err4)
    # tiles of realizations: worker 3 masked out in every realization (its
    # blocks are never read) and the last realization all-masked
    edge = {}
    for R in (4, 16):
        Wr = torch.randn((R, p), device=dev, generator=gen) * 0.01
        mr = fastest_mask(R)
        mr[:, 3] = 0.0
        mr[-1] = 0.0
        gr = fused_masked_gradient(SX, Sy, Wr, mr, **fkw)
        err, rel = rel_err(gr, fused_masked_gradient_plain(SX, Sy, Wr, mr,
                                                           **fkw))
        require(rel <= 1e-4, f"fused R={R}: rel err {rel:.2e}")
        for q in range(R):
            require(torch.equal(gr[q], fused_masked_gradient(
                SX, Sy, Wr[q], mr[q], **fkw)),
                f"fused R={R}: batched row {q} != single call")
        require(torch.count_nonzero(gr[-1]) == 0,
                f"fused R={R}: all-masked realization != 0")
        print(f"check fused R={R}, worker 3 out everywhere, realization "
              f"{R - 1} all-masked: max|d| {err:.3e} ({rel:.2e}, tol 1e-4); "
              f"batched[r] == single(r) bitwise for all {R}; all-masked "
              f"row == 0")
        fused_err = max(fused_err, err)
        edge[R] = (Wr, mr)
    table["fused_masked_gradient"] = {"max_abs_err": fused_err}
    # the kernels' own shape choices agree with the wrappers'
    lib = _build.load_library()
    bad_rt = [q for q in range(1, MAX_COLS + 1)
              if lib.repro_fused_realization_tile(q) !=
              pick_fused_realization_tile(q)]
    bad_g = [q for q in range(0, 257) if lib.repro_coded_combine_groups(q)
             != combine_row_groups(q)]
    require(not bad_rt and not bad_g, f"kernel and wrapper disagree: tile "
            f"at p {bad_rt[:5]}, row groups at m {bad_g[:5]}")
    print(f"check shape choices: realization tile at p = {p}: "
          f"{pick_fused_realization_tile(p)} (kernel == wrapper for every "
          f"p <= {MAX_COLS}); combine row groups at m = {m}: "
          f"{combine_row_groups(m)} (kernel == wrapper for m <= 256)")

    # coded combine at the L-BFGS step's (m, p), an odd width, bfloat16
    comb_err = 0.0
    for (cm, cp), dt, tol in (((m, p), torch.float32, 1e-5),
                              ((8, p + 1), torch.float32, 1e-5),
                              ((m, p), torch.bfloat16, 2.0 ** -7)):
        g = torch.randn((cm, cp), device=dev, generator=gen).to(dt)
        c = torch.rand(cm, device=dev, generator=gen)
        out = coded_combine_call(g, c)
        err, rel = rel_err(out, coded_combine_ref(g, c))
        # f32 sums of m terms in another order; bf16 one output ulp
        require(rel <= tol, f"combine {(cm, cp)} {dt}: max|d| {err:.3e} = "
                            f"{rel:.2e} max|ref|")
        require(torch.equal(out, coded_combine_call(g, c[:, None])),
                f"combine {(cm, cp)} {dt}: (m,) != (m, 1) weights")
        require(torch.count_nonzero(coded_combine_call(
            g, torch.zeros_like(c))) == 0, "combine: all-masked != 0")
        print(f"check coded_combine {(cm, cp)} {str(dt)[6:]}: max|d| "
              f"{err:.3e} ({rel:.2e} of max|ref|, tol {tol:.1e}); (m,) == "
              f"(m, 1) bitwise; all-masked == 0")
        comb_err = max(comb_err, err)
    table["coded_combine"] = {"max_abs_err": comb_err}

    # 4. main path -----------------------------------------------------------
    spec = ProblemSpec.synthetic(n, p, noise=0.5, lam=cfg.lam, seed=0)
    # the reference's step rule 1 / (1.3 L + lam), L = max eig(X^T X / n),
    # with the eigenvalues taken on the card in float64
    Xd = torch.as_tensor(spec.X, dtype=torch.float64, device=dev)
    L = float(torch.linalg.eigvalsh(Xd.T @ Xd / n).max())
    del Xd
    step = 1.0 / (1.3 * L + spec.lam)
    engine = ClusterEngine(bimodal_delays(), m, seed=0)
    steps, trials, prox_steps = 100, 4, 50
    run_kw = dict(policy=FastestK(k), encoder="fast-hadamard",
                  step_size=step)
    l1spec = ProblemSpec(X=spec.X, y=spec.y, lam=cfg.lam, h="l1")
    Xy = torch.as_tensor(np.concatenate([spec.X, spec.y[:, None]], 1),
                         dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counts: dict[str, int] = {}
    by_path: dict[str, dict[str, int]] = {}

    def drive(label, fn, expect):
        """Run one main-path entry with the launch counts cleared just
        before and read just after; it must launch exactly ``expect``."""
        _build.launches.clear()
        out = fn()
        torch.cuda.synchronize()
        got = {kn: v for kn, v in _build.launches.items() if v}
        require(got == expect, f"{label}: launches {got} != {expect}")
        by_path[label] = got
        for kn, v in got.items():
            counts[kn] = counts.get(kn, 0) + v
        return out

    fused, srht, fwht = "fused_masked_gradient", "srht_encode", "fwht"
    t0 = time.perf_counter()
    res = drive("coded-gd run", lambda: get_strategy("coded-gd").run(
        spec, engine, steps=steps, **run_kw), {fused: steps, srht: 1})
    bat = drive("coded-gd run_batched", lambda: get_strategy(
        "coded-gd").run_batched(spec, engine, steps=steps, trials=trials,
                                eval_every=10, **run_kw),
        {fused: steps, srht: 1})
    prox = drive("coded-prox run", lambda: get_strategy("coded-prox").run(
        l1spec, engine, steps=prox_steps, **run_kw),
        {fused: prox_steps, srht: 1})
    enc = FastHadamardEncoder(n, cfg.beta, seed=0).with_workers(m)
    E = drive("encode", lambda: enc.encode(Xy), {srht: 1})
    D = drive("decode_t", lambda: enc.decode_t(E), {fwht: 1})
    B5 = drive("worker_block", lambda: enc.worker_block(5, Xy), {fwht: 1})
    # the paper's algorithm for PAPER_RIDGE (algorithm="lbfgs"), then
    # coded BCD on the feature-encoded (lifted) problem and the async
    # baseline, on the same data
    comb = "coded_combine"
    lb_steps, lb_trials, bcd_steps, async_steps = 50, 2, 20, 10
    lb_kw = dict(policy=FastestK(k), encoder="fast-hadamard", memory=10)
    lb = drive("coded-lbfgs run", lambda: get_strategy("coded-lbfgs").run(
        spec, engine, steps=lb_steps, **lb_kw), {comb: lb_steps, srht: 1})
    lbb = drive("coded-lbfgs run_batched", lambda: get_strategy(
        "coded-lbfgs").run_batched(spec, engine, steps=lb_steps,
                                   trials=lb_trials, **lb_kw),
        {comb: lb_steps * lb_trials, srht: 1})
    # the lifted quadratic's Hessian has norm <= beta L (the strategy's
    # own rule, with L from the card instead of a host eigensolve)
    bcd = drive("coded-bcd run", lambda: get_strategy("coded-bcd").run(
        spec, engine, steps=bcd_steps, policy=FastestK(k),
        encoder="fast-hadamard", step_size=0.9 / (L * cfg.beta)),
        {srht: 1})
    asy = drive("async run", lambda: get_strategy("async").run(
        spec, engine, steps=async_steps, step_size=step), {})
    t_main = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"main path: {t_main:.2f} s host clock; peak device memory "
          f"{peak_gb:.2f} GB")
    for label, tr in (("coded-gd run", res.objective),
                      ("coded-gd run_batched", bat.objective),
                      ("coded-prox run", prox.objective),
                      ("coded-lbfgs run", lb.objective),
                      ("coded-lbfgs run_batched", lbb.objective),
                      ("coded-bcd run", bcd.objective),
                      ("async run", asy.objective)):
        tr = np.asarray(tr)
        require(np.isfinite(tr).all(), f"{label}: non-finite objective")
        require((tr[..., -1] < tr[..., 0]).all(),
                f"{label}: objective did not fall")
        print(f"{label}: objective {np.ravel(tr[..., 0])[0]:.6g} -> "
              f"{np.ravel(tr[..., -1]).tolist()}")
    # realization 0 of the batch replays run()'s schedule on the same
    # encode: its strided trace equals run()'s, bit for bit
    require(np.array_equal(bat.objective[0], res.objective[9::10]),
            "run_batched realization 0 != run at the same steps")
    require(np.array_equal(lbb.objective[0], lb.objective),
            "coded-lbfgs run_batched realization 0 != run")
    print(f"coded-bcd: lifted blocks (m, n, N/m) = ({m}, {n}, "
          f"{bcd.w.shape[-1]}); async: {asy.meta['updates']} updates, "
          f"max staleness {asy.meta['max_staleness']}, dropped "
          f"{asy.meta['dropped']}")
    dec_rel = float((D - cfg.beta * Xy).norm() / (cfg.beta * Xy).norm())
    blk_rel = float((B5 - E[5 * r:6 * r]).norm() / E[5 * r:6 * r].norm())
    require(dec_rel <= 1e-5, f"decode_t(encode(x)) != beta x: {dec_rel:.2e}")
    require(blk_rel <= 1e-5, f"worker_block(5) != encode rows: {blk_rel:.2e}")
    print(f"decode_t(encode(x)) vs beta x: rel {dec_rel:.2e} (tol 1e-5); "
          f"Kronecker worker_block(5) vs encode rows: rel {blk_rel:.2e}")

    # the same encoded problem and schedule through the port on the CPU
    prob = make_encoded_problem(spec.X, spec.y,
                                FastHadamardEncoder(n, cfg.beta, seed=0), m,
                                lam=spec.lam, device=dev)
    cpu = EncodedProblem(SX=prob.SX.cpu(), Sy=prob.Sy.cpu(), X=prob.X.cpu(),
                         y=prob.y.cpu(), lam=prob.lam, beta=prob.beta,
                         n=prob.n)
    _, tr_cpu = scan_gd(cpu, res.schedule.masks, step, torch.zeros(p))
    tr_cpu = tr_cpu.numpy()
    dev_rel = float(np.max(np.abs(res.objective - tr_cpu) / np.abs(tr_cpu)))
    # f32 sums in another order on each side; GD damps the differences
    require(dev_rel <= 1e-4, f"card trace vs CPU trace: rel {dev_rel:.2e}")
    print(f"card trace vs the port's CPU run: max rel diff {dev_rel:.2e} "
          f"(tol 1e-4)")
    # the first 20 L-BFGS steps through the port on the CPU, same masks
    lb_cmp = 20
    _, lb_cpu = run_encoded_lbfgs(cpu, lb.schedule.masks[:lb_cmp], memory=10)
    lb_cpu = lb_cpu.numpy()
    lb_rel = float(np.max(np.abs(lb.objective[:lb_cmp] - lb_cpu) /
                          np.abs(lb_cpu)))
    # f32 sums in another order, magnified by the two-loop recursion's and
    # the line search's divisions by inner products of differences
    require(lb_rel <= 1e-3, f"coded-lbfgs card trace vs CPU trace: rel "
                            f"{lb_rel:.2e}")
    print(f"coded-lbfgs card trace vs the port's CPU run ({lb_cmp} steps): "
          f"max rel diff {lb_rel:.2e} (tol 1e-3)")

    # the workloads ------------------------------------------------------
    workloads_phase(dev, smi, drive)
    # the experiment harness and its CLIs ---------------------------------
    harness_phase(cfg, smi, drive)
    print(f"launches by path: {json.dumps(by_path)}")

    # 5. times ---------------------------------------------------------------
    masks_run = torch.as_tensor(res.schedule.masks, device=dev)
    masks_bat = torch.as_tensor(bat.schedules.masks, device=dev)
    w0 = torch.zeros(p, device=dev)
    W0 = w0[None].repeat(trials, 1)
    step1 = [t / steps for t in samples_ms(
        lambda: scan_gd(prob, masks_run, step, w0), 5)]
    step4 = [t / steps for t in samples_ms(
        lambda: batched_scan_gd(prob, masks_bat, step, W0, eval_every=10),
        5)]
    encode_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_encoded_problem(spec.X, spec.y,
                             FastHadamardEncoder(n, cfg.beta, seed=0), m,
                             lam=spec.lam, device=dev)
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t0)
    print(f"step R=1 (objective every step): {spread(step1, 'ms')}  [{smi}]")
    print(f"step R=4 (objective every 10 steps): {spread(step4, 'ms')}  "
          f"[{smi}]")
    print(f"encode (make_encoded_problem, host prep included, host clock): "
          f"{spread(encode_s, 's')}  [{smi}]")
    device_breakdown(lambda: scan_gd(prob, masks_run[:20], step, w0),
                     "20 steps R=1")
    device_breakdown(lambda: batched_scan_gd(
        prob, masks_bat[:, :20], step, w0[None].repeat(trials, 1),
        eval_every=10), "20 steps R=4")
    masks_lb = lb.schedule.masks
    step_lb = [t / lb_steps for t in samples_ms(
        lambda: run_encoded_lbfgs(prob, masks_lb, memory=10), 5)]
    print(f"coded-lbfgs step (memory 10, objective every step): "
          f"{spread(step_lb, 'ms')}  [{smi}]")
    device_breakdown(lambda: run_encoded_lbfgs(prob, masks_lb[:20],
                                               memory=10),
                     "20 coded-lbfgs steps")
    # coded-bcd and async on the problems their strategies built (the same
    # encoders and seeds, rebuilt here), with their runs' masks and events
    lifted = make_lifted_problem(spec.X, FastHadamardEncoder(p, cfg.beta,
                                                             seed=0), m,
                                 *phi_quadratic(spec.y, device=dev),
                                 device=dev)
    v0 = torch.zeros((m, lifted.XS.shape[-1]), device=dev)
    masks_bcd = bcd.schedule.masks
    step_bcd = [t / bcd_steps for t in samples_ms(
        lambda: scan_bcd(lifted, masks_bcd, bcd.meta["step_size"], v0), 5)]
    print(f"coded-bcd step (objective every step): "
          f"{spread(step_bcd, 'ms')}  [{smi}]")
    device_breakdown(lambda: scan_bcd(lifted, masks_bcd, bcd.meta["step_size"],
                                      v0), f"{bcd_steps} coded-bcd steps")
    del lifted
    aprob = make_encoded_problem(spec.X, spec.y,
                                 make_encoder("uncoded", n, beta=1.0), m,
                                 lam=spec.lam, device=dev)
    ev = asy.schedule
    bound = asy.meta["staleness_bound"]
    upd = [t / ev.updates for t in samples_ms(
        lambda: scan_async(aprob, ev.workers, ev.staleness,
                           asy.meta["step_size"], w0,
                           buffer_size=bound + 1), 5)]
    print(f"async update (objective every update): {spread(upd, 'ms')}  "
          f"[{smi}]")
    device_breakdown(lambda: scan_async(aprob, ev.workers[:64],
                                        ev.staleness[:64],
                                        asy.meta["step_size"], w0,
                                        buffer_size=bound + 1),
                     "64 async updates")
    del aprob

    # FWHT: one read and one write of the (p + 1, N) frame; the library
    # yardstick is the dense product with the Sylvester matrix
    H = torch.as_tensor(hadamard_matrix(N), dtype=torch.float32, device=dev)
    fw = table["fwht"]
    fw["ms"] = time_ms(lambda: fwht_kernel_call(x), 20)
    fw["plain_ms"] = time_ms(lambda: fwht_plain(x), 5)
    fw["library_ms"] = time_ms(lambda: torch.matmul(x, H), 3)
    fw["bound_ms"], fw["bound_by"] = bound_ms(
        2 * x.numel() * 4, x.numel() * math.log2(N))
    del H

    # SRHT full frame: read the (p + 1, n) data and (cols, signs), write the
    # (p + 1, N) frame; the yardstick is the product with the dense S
    S = torch.as_tensor(hadamard_matrix(N)[:, cols] * signs[None, :] /
                        math.sqrt(n), dtype=torch.float32, device=dev)
    se = table["srht_encode"]
    kw = dict(N=N, lo=0, hi=N, scale=scale)
    se["ms"] = time_ms(lambda: srht_encode_call(xt, cols_t, signs_t, **kw),
                       20)
    se["plain_ms"] = time_ms(
        lambda: srht_encode_plain(xt, cols_t, signs_t, **kw), 5)
    se["library_ms"] = time_ms(lambda: torch.matmul(S, X), 3)
    se["bound_ms"], se["bound_by"] = bound_ms(
        (xt.numel() + (p + 1) * N) * 4 + n * 8, (p + 1) * N * math.log2(N))
    del S

    # fused gradient, single (the run() step): the active workers' blocks
    # are what this mask needs read; 2 flops an element in each of 2 passes
    fu = table["fused_masked_gradient"]
    act = int(mask.sum())
    fu["ms"] = time_ms(lambda: fused_masked_gradient(SX, Sy, w, mask, **fkw),
                       50)
    fu["plain_ms"] = time_ms(lambda: fused_masked_gradient_plain(
        SX, Sy, w[None], mask[None], **fkw), 10)
    fu["library_ms"] = time_ms(lambda: fused_masked_gradient_ref(
        SX, Sy, w, mask, **fkw), 10)
    fu["bound_ms"], fu["bound_by"] = bound_ms(
        (act * r * (p + 1) + 2 * p + m) * 4, 4 * act * r * p)
    # batched: each realization reads only its own active workers' rows,
    # so the union of active workers is read once at best; the flops are
    # counted per realization.  The library yardstick is the dense einsum
    # oracle once a realization.
    for R, (Wr, mr) in ((4, (W4, masks4)), (16, edge[16])):
        act = int((mr.sum(0) > 0).sum())
        b_ms = time_ms(lambda: fused_masked_gradient(SX, Sy, Wr, mr, **fkw),
                       20)
        b_bound, b_by = bound_ms((act * r * (p + 1) + 2 * R * p + R * m) * 4,
                                 4 * int(mr.sum()) * r * p)
        b_lib = time_ms(lambda: [fused_masked_gradient_ref(
            SX, Sy, Wr[q], mr[q], **fkw) for q in range(R)], 3)
        b_plain = time_ms(lambda: fused_masked_gradient_plain(
            SX, Sy, Wr, mr, **fkw), 3)
        fu[f"batched_r{R}_ms"] = b_ms
        fu[f"batched_r{R}_bound_ms"] = b_bound
        fu[f"batched_r{R}_plain_ms"] = b_plain
        fu[f"batched_r{R}_library_ms"] = b_lib
        print(f"fused batched R={R}: {b_ms:.4f} ms, bound {b_bound:.4f} ms "
              f"({b_by}; {act} workers active in some realization); plain "
              f"{b_plain:.4f} ms; library {b_lib:.4f} ms  [{smi}]")

    # coded combine at the L-BFGS step's (m, p) (the gradient block it
    # combines was just written, so it is found in L2, as on the main
    # path) and at the coded-SGD flat gradient's (32, 4194304) (512 MB,
    # from device memory): read g and c once, write out once; the
    # yardstick is one torch.matmul(c, g)
    co = table["coded_combine"]
    for cp in (p, 4194304):
        g = torch.randn((m, cp), device=dev, generator=gen)
        c = torch.rand(m, device=dev, generator=gen)
        reps = 200 if cp == p else 20
        row = {"ms": time_ms(lambda: coded_combine_call(g, c), reps),
               "plain_ms": time_ms(lambda: coded_combine_ref(g, c), reps),
               "library_ms": time_ms(lambda: torch.matmul(c, g), reps)}
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * cp + m + cp) * 4, 2 * m * cp)
        if cp == p:
            co.update(row)
            dev_us = [1e3 * device_ms(f, 50) for f in (
                lambda: coded_combine_call(g, c),
                lambda: coded_combine_ref(g, c),
                lambda: torch.matmul(c, g))]
            co["device_ms"], co["library_device_ms"] = (dev_us[0] / 1e3,
                                                        dev_us[2] / 1e3)
            print(f"coded_combine (32, {cp}) device time a call (profiler, "
                  f"host gaps excluded): kernel {dev_us[0]:.2f} us, plain "
                  f"{dev_us[1]:.2f} us, library {dev_us[2]:.2f} us  [{smi}]")
        else:
            co.update({f"wide_{key}": v for key, v in row.items()
                       if key != "bound_by"})
            print(f"coded_combine (32, {cp}): {row['ms']:.4f} ms; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); plain "
                  f"{row['plain_ms']:.4f} ms; library {row['library_ms']:.4f}"
                  f" ms  [{smi}]")
        del g

    meta = {
        "coded_combine": ("src/repro_torch/kernels/csrc/coded_reduce.cu",
                          "src/repro/kernels/coded_reduce.py:47"),
        "fwht": ("src/repro_torch/kernels/csrc/fwht.cu",
                 "src/repro/kernels/fwht.py:62"),
        "srht_encode": ("src/repro_torch/kernels/csrc/srht.cu",
                        "src/repro/kernels/encode.py:36"),
        "fused_masked_gradient": ("src/repro_torch/kernels/csrc/"
                                  "fused_step.cu",
                                  "src/repro/kernels/fused_step.py:65"),
    }
    kernels = []
    for kname in ("fused_masked_gradient", "srht_encode", "fwht",
                  "coded_combine"):
        row = table[kname]
        print(f"time {kname}: {row['ms']:.4f} ms; bound {row['bound_ms']:.4f}"
              f" ms ({row['bound_by']}); plain {row['plain_ms']:.4f} ms; "
              f"library {row['library_ms']:.4f} ms  [{smi}]")
        kernels.append({"name": kname, "route": "cuda",
                        "source": meta[kname][0], "replaces": meta[kname][1],
                        "launches": counts[kname], **row})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
