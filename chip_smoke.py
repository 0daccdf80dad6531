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
             frame and one worker window of the (4096, 6001) data; the
             Hadamard routes past one pass, one launch each, route printed:
             FWHT over a thread-block cluster at 2^16, 2^17 and 2^18 and
             by the strided passes at 2^19, in float32 and bfloat16, SRHT
             at N = 8192, 65 536 and 262 144, full frame, an aligned
             window (worker 5's at 8192 and 65 536), a misaligned one and
             one straddling N / 2, and by the passes at 2^19, full frame
             and a window too wide to prune; a row of a batched call == a
             one-row call bit for bit; the timed SRHT calls take a signed
             slot map built once, as an encoder's caller does; fused
             gradient at (32, 256, 6000), single, batched R = 4, all
             masked, and batched row r == single call r bit for bit, also
             at R = 4 and R = 16 with one worker masked out in every
             realization and one realization all-masked; coded combine at
             (32, 6000) in float32 and bfloat16 and at the odd width
             (8, 6001), (m,) and (m, 1) weights bit for bit, all masked;
             the kernels' realization tile and row groups and the fused
             gradient's column-split plan equal the wrappers' Python
             choices);
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
   train   - coded SGD over the dense LM (``repro_torch.train``), each
             entry driven with the launch counts cleared just before and
             read just after: (1) ``get_strategy("coded-sgd").run`` at the
             ``100m`` preset (deepseek-7b's block at 12 x 768, vocab 16384,
             97 536 768 parameters, float32; m = 8, k = 6, seq 128), 30
             FRC steps (beta 2) and 10 cyclic steps, exactly one combine
             launch a step and no other kernel, the loss finite and
             falling; (2) the first 2 of those steps again on the card and
             on the CPU from the same port-initialized parameters, losses
             to rel 1e-4 and step 1's combined gradient to rel 1e-5 in
             norm; (3) the FRC update under masks 11110000 and 00001111
             equal bit for bit; the step's time (five samples) and its
             profiler breakdown (workers' forward and backward, flatten,
             combine, AdamW, idle share); (4) deepseek-7b at its published
             width with one layer of 30 (bfloat16, 621 817 856 parameters)
             through ``CodedTrainer``, 3 steps, 3 combines at (8,
             621 817 856), peak device memory; (5) ``experiments.run
             --train deepseek-7b`` (coded-sgd and uncoded, 10 steps) on the
             card and with ``--device cpu``, final losses to rel 1e-4; (6)
             the combine at (8, 97 536 768) and (8, 621 817 856) beside its
             bound, its plain version and ``torch.matmul(c, g)``;
   wide    - coded-prox at LASSO §5.4's published width (the ``paper``
             preset's p = 100 000, m = 128, k = 80, lam = 0.6, sparsity
             7695, noise 40, multimodal delays, seed 0; fast-Hadamard,
             beta 2) with n cut from 130 000 to 32 768 (20 000 where the
             host has under 70 GB free), so N = 65 536 (one cluster launch)
             and S X (128, 512, 100 000) float32 is 26.2 GB; 20 steps, the
             step size 1 / (1.3 L + lam) with L from a power iteration on
             the card (the workload's build, its eigvalsh and FISTA ground
             truth, left out): ``get_strategy("coded-prox").run`` with
             exactly one SRHT and 20 fused launches, the objective finite
             and falling and within rel 1e-4 of the same call under
             REPRO_FUSED=0 (the combine kernel); decode_t(encode(x)) =
             beta x at N for 8 columns (rel 1e-5); make_encoded_problem's
             peak device memory at most 2.1 |S X|; each kernel against its
             plain version at the wide shapes (FWHT (8, 65 536) and
             (2, 262 144); SRHT of 64 columns into N = 65 536, full frame
             and worker 5's window; the fused gradient on the encoded data
             at p = 16 385 and 100 000, 8 workers, batched R = 4 rows equal
             to single calls bit for bit, its column-split route printed),
             and their times beside bound, plain version and library call,
             with the fused step at the path's (128, 512, 100 000) and the
             path's full SRHT encode; the 5-step profile must name the
             cluster route's kernel and not the two-read form's;
             the Hadamard rows also print their route, the card's own time
             a call (CUDA graph replay) and the launch floor (an empty
             kernel through the same ctypes path), and worker 5's window
             against torch.matmul with the dense window; the fused step at
             the path's shape also beside its library form, two torch.bmm
             calls (the masked residual of every worker's rows, then
             (S X)^T times it), held to the kernel's output (rel 1e-4),
             with its route, the bytes it reads (each active row once)
             and the rate it reached;
   serve   - the model zoo's serve path (``repro_torch.models``' prefill
             and decode_step, ``repro_torch.serve``), which runs no kernel
             of the port: the launch counters are cleared before the
             phase and must read 0 after it.  (1) every architecture at
             its smoke variant: prefill (batch 2, 64 tokens, cache 72) and
             8 teacher-forced decode steps on the card and on the CPU from
             the same port-initialized float32 parameters (TF32 off),
             logits to rel 1e-4 of the largest |logit|, cache trees of
             equal structure and shapes; (2) gemma2-27b at its published
             width (arXiv:2408.00118) with one period of 2 layers of 46
             (the local layer, window 4096, and the global one; a
             ``reduced:`` line), 2 312 151 552 parameters in bfloat16:
             batch 4, prompt 8192 (the local ring keeps the last 4096
             keys), 32 greedy decode steps; prefill ms and decode ms a
             token (CUDA events, five samples after the warm-up, every
             sample), tokens/s, peak device memory, profiler breakdowns
             of the prefill and of one decode step with the idle share;
             then in float32 at batch 1 prefill's last logits and the
             first decode step's against ``forward`` over 8193 tokens,
             within 1e-3 of the largest |logit|; (3) phi3.5-moe-42b-a6.6b
             at its published width (hf:microsoft/Phi-3.5-MoE-instruct),
             1 layer of 32, 1 431 646 208 parameters in bfloat16, batch 2,
             prompt 4096, 16 decode steps, the same times and the
             assignments the prefill drops for capacity; (4) xlstm-350m
             whole (arXiv:2405.04517), 393 131 104 parameters, batch 2,
             prompt 1024, 16 decode steps, the same times; (5)
             ``python -m repro_torch.serve --arch gemma2-27b`` through
             ``main(argv)`` on the card, in-process; the phase's host
             seconds;
   launch  - the launchers (``repro_torch.launch``, ``repro_torch.sharding``),
             each entry driven with the launch counts cleared just before
             and read just after: (1) ``python -m repro_torch.launch.train
             --arch deepseek-7b --smoke --steps 10`` through ``main(argv)``,
             in-process, on the card (one combine launch a coded step) and
             with ``--device cpu`` (none), losses to rel 1e-4 and simulated
             times bit for bit; (2) the CLI's body (``launch.train.train``)
             at deepseek-7b's published width with one layer of 30 (a
             ``reduced:`` line; 621 817 856 parameters, bfloat16), its
             default flags, 4 steps: the step time by CUDA events between
             steps 2-4 (median and every sample; the first step carries
             the warm-up and is printed apart), the combine's time inside
             those steps by CUDA events around its call and its share of
             the step, peak device memory, finite losses and one combine a
             step at (8, 621 817 856); (3)
             ``grad_specs`` from ``make_shardings`` on a one-card
             ``make_local_mesh()`` (NCCL): one ``build_train_step`` step
             with it equal bit for bit to the step without it (parameters,
             optimizer state, loss); (4) ``python -m
             repro_torch.launch.dryrun`` in three processes started
             together (deepseek-7b train_4k on both meshes, phi3.5-moe
             decode_32k, jamba-1.5-large long_500k), each record's roofline
             terms, argument bytes a device and host seconds; any failed
             combination fails the phase;
   sharded - the realization axis over cards: ``torch.cuda.device_count()``
             printed; at PAPER_RIDGE's width with R = 8, coded-gd (100
             steps) and coded-prox (50) through ``run_batched`` with
             ``placement="sharded"`` and ``"vmap"``, ``placement_devices``
             the card count where it divides R (1 on one card) and w,
             traces and times bit for bit equal; then
             ``runners._sharded_run`` over two shards of card 0 (and over
             every card where there are more than one), w and traces bit
             for bit equal to the batched run, one fused launch a step on
             each shard; a step's time of the two dispatch designs (one
             thread enqueuing the shards' steps in turn, the one kept; a
             host thread a shard) beside the batched run's, in turns;
             with more than one card also Fig. 7 at R = 32 through
             ``workloads.run --placement sharded``, equal to the vmap run
             bit for bit;
5. times   - each kernel (CUDA events, after warm-up) beside its bound, its
             plain version and, where one exists, one PyTorch call for the
             same function (the SRHT also at worker 5's window beside
             torch.matmul with the dense window; the fused gradient also
             batched at R = 4 and
             R = 16, there also beside cuBLAS's two products, S X W^T
             then (S X)^T (C * resid); the combine also by the profiler's
             device time and,
             beside torch.matmul(c, g), by CUDA graph replay, and at
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
import shutil
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


def graph_ms(fn, reps: int = 20, calls: int = 10) -> float:
    """Device time of one call of ``fn`` with the host taken out: ``calls``
    calls captured in a CUDA graph, the graph replayed ``reps`` times
    between CUDA events.  For a call that the host's launch path paces,
    this is the card's share and ``time_ms`` the caller's."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * calls)


def launch_floor_ms() -> tuple[float, float]:
    """Event time a call of an empty kernel launched through the kernels'
    own ctypes path (``_build.launch``: the operands' card made current,
    its stream read): the floor under every small shape's time; and the
    same call without the device guard."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.load_library()
    probe = torch.zeros(1, device="cuda")
    return (time_ms(lambda: _build.launch("empty", lib.repro_empty,
                                          (probe,)), 200),
            time_ms(lambda: lib.repro_empty(_build.stream_of(probe)), 200))


def route_of(kname: str, **shape) -> str:
    """The route a FWHT (n), SRHT (n, N, lo, hi) or column-split fused
    gradient (p, itemsize) call takes, as printed."""
    from repro_torch.kernels.encode import srht_plan
    from repro_torch.kernels.fused_step import wide_plan
    from repro_torch.kernels.fwht import fwht_plan
    if kname == "fused":
        plan = wide_plan(**shape)
        return (f"route {plan.route}" + (
            f", C {plan.C}, {plan.slice_cols} columns a CTA, NV "
            f"{plan.vectors}, RT {plan.tile}, {plan.slots} slots a CTA"
            if plan.route == "cluster" else ""))
    plan = fwht_plan(**shape) if kname == "fwht" else srht_plan(**shape)
    extra = (f", C {plan.C}, {plan.slots} slots a CTA" if plan.C > 1 else
             f", r' {plan.rp}, b {plan.b}" if plan.route == "pruned" else
             f", staged {plan.stage}" if kname == "srht" and
             plan.route == "one-pass" else "")
    return f"route {plan.route}{extra}"


def hadamard_routes(dev, gen, table: dict) -> None:
    """The FWHT and SRHT routes past one pass against their plain versions
    on the card: FWHT over a cluster at 2^16, 2^17 and 2^18 and by the
    strided passes at 2^19, in float32 and bfloat16; SRHT at PAPER_RIDGE's
    N = 8192 (full, worker 5's rows [1280, 1536)), at 65 536 and at
    262 144 (full frame, an aligned window, a misaligned one and one
    straddling N / 2) and by the passes at 2^19 (full frame, a window too
    wide to prune).  Each must take its expected route in one launch; its
    route is printed."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.encode import (srht_encode_call,
                                            srht_encode_plain, srht_plan)
    from repro_torch.kernels.fwht import (fwht_kernel_call, fwht_plain,
                                          fwht_plan)
    for nf in (1 << 16, 1 << 17, 1 << 18, 1 << 19):
        want = "cluster" if nf <= 1 << 18 else "passes"
        require(fwht_plan(nf).route == want, f"fwht {nf}: "
                f"{route_of('fwht', n=nf)}, expected {want}")
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
            x = torch.randn((4, nf), device=dev, generator=gen).to(dt)
            _build.launches.clear()
            out = fwht_kernel_call(x)
            torch.cuda.synchronize()
            require(_build.launches["fwht"] == 1, f"fwht ({4}, {nf}): "
                    f"{_build.launches['fwht']} launches")
            err, rel = rel_err(out, fwht_plain(x))
            # f32 butterflies in another stage order; bf16 one output ulp
            require(rel <= tol, f"fwht (4, {nf}) {dt}: rel {rel:.2e}")
            require(torch.equal(fwht_kernel_call(x[1:2].contiguous())[0],
                                out[1]),
                    f"fwht (4, {nf}) {dt}: row 1 != a one-row call")
            print(f"check fwht (4, {nf}) {str(dt)[6:]}, "
                  f"{route_of('fwht', n=nf)}, one launch: max|d| {err:.3e} "
                  f"({rel:.2e} of max|ref|, tol {tol:.1e}); row 1 == a "
                  f"one-row call bitwise")
            if dt == torch.float32:
                table["fwht"]["max_abs_err"] = max(
                    table["fwht"]["max_abs_err"], err)
    rng = np.random.default_rng(19)
    for n, N, windows in ((4096, 8192, ((0, 8192), (1280, 1536),
                                        (1000, 1300), (4000, 4200))),
                          (32768, 65536, ((0, 65536), (2560, 3072),
                                          (2561, 3001), (32000, 33000))),
                          (100000, 262144, ((0, 262144), (10240, 12288),
                                            (10000, 10600),
                                            (131000, 131500))),
                          (300000, 1 << 19, ((0, 1 << 19),
                                             (100000, 200000)))):
        cols = torch.as_tensor(rng.choice(N, n, replace=False).astype(
            np.int32), device=dev)
        signs = torch.as_tensor(rng.choice([-1.0, 1.0], n).astype(
            np.float32), device=dev)
        xt = torch.randn((8, n), device=dev, generator=gen)
        for lo, hi in windows:
            if N > 1 << 18:
                require(srht_plan(n, N, lo, hi).route == "passes",
                        f"srht N {N} [{lo}, {hi}): "
                        f"{route_of('srht', n=n, N=N, lo=lo, hi=hi)}, "
                        f"expected passes")
            kw = dict(N=N, lo=lo, hi=hi, scale=1.0 / math.sqrt(n))
            _build.launches.clear()
            out = srht_encode_call(xt, cols, signs, **kw)
            torch.cuda.synchronize()
            require(_build.launches["srht_encode"] == 1, f"srht N {N} "
                    f"[{lo}, {hi}): {_build.launches['srht_encode']} launches")
            err, rel = rel_err(out, srht_encode_plain(xt, cols, signs, **kw))
            require(rel <= 1e-5, f"srht N {N} [{lo}, {hi}): rel {rel:.2e}")
            require(torch.equal(srht_encode_call(
                xt[5:6].contiguous(), cols, signs, **kw)[0], out[5]),
                f"srht N {N} [{lo}, {hi}): column 5 != a one-column call")
            print(f"check srht (8, {n}) -> [{lo}, {hi}) of {N}, "
                  f"{route_of('srht', n=n, N=N, lo=lo, hi=hi)}, one launch: "
                  f"max|d| {err:.3e} ({rel:.2e} of max|ref|, tol 1e-5); "
                  f"column 5 == a one-column call bitwise")
            table["srht_encode"]["max_abs_err"] = max(
                table["srht_encode"]["max_abs_err"], err)


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


def device_breakdown(fn, label: str) -> list:
    """Print where the device time of ``fn`` goes, kernel by kernel, from
    ``torch.profiler``, and the device's idle share of the wall time;
    return the rows (device us, count, kernel name), largest first."""
    wall_us, rows = profile_device(fn)
    if not rows:
        print(f"profile {label}: the profiler recorded no device time")
        return rows
    busy = sum(r[0] for r in rows)
    print(f"profile {label}: wall {wall_us:.0f} us, device busy {busy:.0f} us"
          f" (idle share {max(0.0, 1 - busy / wall_us):.2f})")
    for us, count, key in rows[:8]:
        print(f"  {us:10.1f} us {count:5d}x  {key[:90]}")
    return rows


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
          f"on the card: memory alone keeps it off one card (the wide phase "
          f"runs it at n = 32768)")
    ps = get_workload("logistic").preset("paper")
    n, p = ps.dims["n"], ps.dims["p"]
    n_train = n - int(round(n * ps.dims["test_frac"]))
    N = hadamard_ensemble(p, 2.0, 0)[0]
    print(f"logistic paper (n, p) = ({n}, {p}): X float32 "
          f"{n * p * 4 / 1e9:.1f} GB, lifted blocks X S^T ({n_train}, {N}) "
          f"float32 {n_train * N * 4 / 1e9:.1f} GB on the card: memory alone "
          f"keeps it off one card")
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


def train_phase(smi: str, drive, co: dict) -> None:
    """Coded SGD over the dense LM (module docstring, phase "train");
    ``drive`` runs one entry with the launch counts cleared just before and
    read just after, and requires its kernels; ``co`` is the combine's row
    of the kernel table, which gains the coded-SGD widths' times."""
    import shutil

    import numpy as np
    import torch
    import repro_torch.train.coded as coded
    from repro_torch.configs import get_config
    from repro_torch.core import bimodal_delays, make_code
    from repro_torch.experiments.run import main as exp_main
    from repro_torch.kernels.coded_reduce import (coded_combine_call,
                                                  coded_combine_ref)
    from repro_torch.models import count_params
    from repro_torch.runtime import ClusterEngine, FastestK, get_strategy
    from repro_torch.train import CodedTrainer, TrainerConfig, TrainProblem
    from repro_torch.tree import tree_leaves, tree_map

    comb = "coded_combine"
    t_phase = time.perf_counter()
    m, k, steps = 8, 6, 30
    engine = lambda: ClusterEngine(bimodal_delays(), m, seed=0)  # noqa: E731
    spec = TrainProblem(arch="deepseek-7b", preset="100m", seq_len=128)
    cfg = spec.build_cfg()
    p100 = int(count_params(cfg))
    require(p100 == 97_536_768, f"100m preset has {p100} parameters")

    # (1) coded SGD at the 100m preset through the strategy entry point
    t0 = time.perf_counter()
    res = drive("coded-sgd 100m frc", lambda: get_strategy("coded-sgd").run(
        spec, engine(), steps=steps, k=k, code="frc", beta=2),
        {comb: steps})
    t_run = time.perf_counter() - t0
    loss = np.asarray(res.objective)
    require(np.isfinite(loss).all(), "coded-sgd 100m: non-finite loss")
    require(loss[-5:].mean() < loss[0], f"coded-sgd 100m: loss did not "
            f"fall ({loss[0]:.4f} -> last 5 {loss[-5:].mean():.4f})")
    print(f"coded-sgd 100m frc (deepseek-7b block, 12 x 768, P_total "
          f"{p100}, m {m}, k {k}, beta 2, seq 128, {steps} steps): loss "
          f"{loss[0]:.4f} -> mean of last 5 {loss[-5:].mean():.4f}; "
          f"exact_fraction {res.meta['exact_fraction']:.3f}, mean_active "
          f"{res.meta['mean_active']:.3f}; {t_run:.2f} s host clock "
          f"[{smi}]")
    cyc = drive("coded-sgd 100m cyclic", lambda: get_strategy(
        "coded-sgd").run(spec, engine(), steps=10, k=k, code="cyclic",
                         beta=2), {comb: 10})
    closs = np.asarray(cyc.objective)
    require(np.isfinite(closs).all(), "coded-sgd 100m cyclic: non-finite")
    ccode = make_code("cyclic", m, beta=2)
    print(f"coded-sgd 100m cyclic (num_groups {ccode.num_groups}, "
          f"{ccode.worker_groups.shape[1]} slots a worker, 10 steps): loss "
          f"{closs[0]:.4f} -> {closs[-1]:.4f}; exact_fraction "
          f"{cyc.meta['exact_fraction']:.3f}, mean_active "
          f"{cyc.meta['mean_active']:.3f}")

    # (2) the first 2 steps of (1) on the card and on the CPU, from the
    # same port-initialized parameters, masks and batches
    tcfg = TrainerConfig(m_workers=m, beta=2, wait_k=k, seq_len=128,
                         steps=steps, lr=3e-3, warmup=6, seed=0,
                         log_every=0, code="frc")
    card = CodedTrainer(cfg, tcfg, engine(), policy=FastestK(k))
    host = CodedTrainer(cfg, tcfg, engine(), policy=FastestK(k),
                        device="cpu")
    params, opt = card.init_state()
    masks = engine().sample_schedule(steps, FastestK(k)).masks
    combined: list = []
    plain_call = coded.coded_combine_call

    def keep(g, c):
        combined.append(plain_call(g, c))
        return combined[-1]

    def first_steps(tr, p, o, n=2):
        out = []
        for t in range(n):
            toks, labels, coeff = tr.batcher.next_batch(tr.code.at_step(t))
            d = np.asarray(tr.code.decode_weights(np.asarray(masks[t])),
                           np.float32)
            p, o, met = tr._step(p, o, *(tr._on_device(a) for a in
                                         (toks, labels, coeff, d)))
            out.append(float(met["loss"]))
        return out

    coded.coded_combine_call = keep
    try:
        card_loss = drive("coded-sgd 100m 2 steps on the card",
                          lambda: first_steps(card, params, opt), {comb: 2})
        cpu_loss = drive("coded-sgd 100m 2 steps on the CPU",
                         lambda: first_steps(
                             host, tree_map(lambda t: t.cpu(), params),
                             tree_map(lambda t: t.cpu(), opt)), {})
    finally:
        coded.coded_combine_call = plain_call
    loss_rel = rel_max(card_loss, cpu_loss)
    g_card, g_cpu = combined[0].cpu(), combined[2]
    g_rel = float((g_card - g_cpu).norm() / g_cpu.norm())
    del combined
    require(loss_rel <= 1e-4, f"100m card vs CPU loss rel {loss_rel:.2e}")
    require(g_rel <= 1e-5, f"100m card vs CPU combined gradient rel "
                           f"{g_rel:.2e}")
    print(f"coded-sgd 100m card vs CPU, 2 steps: losses {card_loss} vs "
          f"{cpu_loss}, max rel {loss_rel:.2e} (tol 1e-4); step 1 combined "
          f"gradient rel {g_rel:.2e} in norm (tol 1e-5); card steps equal "
          f"the strategy run's first 2 losses bit for bit: "
          f"{card_loss == loss[:2].tolist()}")

    # (3) FRC invariance: one replica of every cluster survives either way
    batch = [card._on_device(a) for a in card.batcher.next_batch()]

    def both_masks():
        outs = []
        for mask in ([1, 1, 1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 1, 1, 1, 1]):
            d = card.code.decode_weights(np.asarray(mask, np.float64))
            outs.append(card._step(params, opt, *batch, card._on_device(
                np.asarray(d, np.float32))))
        return outs

    a, b = drive("coded-sgd 100m FRC invariance", both_masks, {comb: 2})
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a[:2]),
                                                 tree_leaves(b[:2])))
    require(same and torch.equal(a[2]["loss"], b[2]["loss"]),
            "FRC update depends on which replica survived")
    print(f"coded-sgd 100m FRC invariance: masks 11110000 and 00001111 give "
          f"parameters, optimizer state and loss ({float(a[2]['loss']):.6f})"
          f" equal bit for bit")
    del a, b

    # the 100m step's time (the step is functional: each sample starts from
    # the same parameters) and its profiler breakdown
    d = card._on_device(np.asarray(card.code.decode_weights(
        np.asarray(masks[0])), np.float32))
    step_fn = lambda: card._step(params, opt, *batch, d)  # noqa: E731
    step_ms = samples_ms(step_fn, 5)
    print(f"coded-sgd 100m step (m {m}, seq 128, one combine): "
          f"{spread(step_ms, 'ms')}  [{smi}]")
    train_breakdown(step_fn, smi, sorted(step_ms)[len(step_ms) // 2])
    del params, opt, card, host, step_fn, batch
    torch.cuda.empty_cache()

    # (4) deepseek-7b at its published width, one layer of 30
    cfg7 = get_config("deepseek-7b").with_overrides(n_layers=1)
    p7 = int(count_params(cfg7))
    require(p7 == 621_817_856, f"deepseek-7b 1 layer has {p7} parameters")
    print(f"reduced: n_layers {get_config('deepseek-7b').n_layers} -> 1 "
          f"(deepseek-7b: d_model {cfg7.d_model}, {cfg7.n_heads} heads, "
          f"d_ff {cfg7.d_ff}, vocab {cfg7.vocab}, {cfg7.param_dtype}; "
          f"P_total {p7})")
    trainer = CodedTrainer(cfg7, TrainerConfig(
        m_workers=m, beta=2, wait_k=k, seq_len=128, steps=3, lr=3e-3,
        warmup=1, log_every=0), engine(), policy=FastestK(k))
    shapes: list = []

    def watch(g, c):
        shapes.append(tuple(g.shape))
        return plain_call(g, c)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    coded.coded_combine_call = watch
    try:
        _, _, hist = drive("coded-sgd deepseek-7b 1 layer",
                           lambda: trainer.run(), {comb: 3})
    finally:
        coded.coded_combine_call = plain_call
    peak7 = torch.cuda.max_memory_allocated() / 1e9
    l7 = [h["loss"] for h in hist]
    require(np.isfinite(l7).all(), "deepseek-7b 1 layer: non-finite loss")
    require(shapes == [(m, p7)] * 3, f"deepseek-7b combines at {shapes}")
    print(f"coded-sgd deepseek-7b 1 layer (m {m}, FRC beta 2, k {k}, seq "
          f"128, 3 steps): losses {[round(x, 4) for x in l7]}; 3 combine "
          f"launches at ({m}, {p7}); step host s "
          f"{[round(h['execute_s'], 3) for h in hist]}; peak device memory "
          f"{peak7:.2f} GB  [{smi}]")
    del trainer, hist
    torch.cuda.empty_cache()

    # (5) a train-kind cell through the harness, on the card and the CPU
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    argv = ["--train", "deepseek-7b", "--preset", "smoke", "--strategies",
            "coded-sgd,uncoded", "--delays", "bimodal", "--code", "frc",
            "--steps", "10", "--formats", "json"]
    with env_var("REPRO_RUNSTORE", str(tmp / "store")):
        gpu, _ = drive("experiments.run --train card", lambda: quiet(
            exp_main, argv + ["--out", str(tmp / "card")]), {comb: 20})
        cpu, _ = drive("experiments.run --train --device cpu", lambda: quiet(
            exp_main, argv + ["--out", str(tmp / "cpu"), "--device",
                              "cpu"]), {})
    finals = []
    for g, c in zip(gpu.records, cpu.records):
        require(g["times"] == c["times"], f"{g['strategy']}: times differ")
        rel = abs(g["final_metric"] - c["final_metric"]) / \
            abs(c["final_metric"])
        require(rel <= 1e-4, f"train cell {g['strategy']}: card final loss "
                             f"vs CPU rel {rel:.2e}")
        finals.append(f"{g['strategy']} ({g['meta']['code']}) "
                      f"{g['final_metric']:.6f} vs {c['final_metric']:.6f}, "
                      f"rel {rel:.2e}")
    shutil.rmtree(tmp)
    print(f"experiments.run --train deepseek-7b smoke, 10 steps, card vs "
          f"CPU final loss (tol 1e-4): {'; '.join(finals)}")

    # (6) the combine at the coded-SGD widths: read (m, P) and c once,
    # write P once; the yardstick is one torch.matmul(c, g)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for tag, cp, reps in (("sgd100m", p100, 20), ("sgd7b", p7, 5)):
        g = torch.empty((m, cp), device="cuda")
        g.normal_(generator=gen)
        c = torch.rand(m, device="cuda", generator=gen)
        out = coded_combine_call(g, c)
        err, rel = rel_err(out, coded_combine_ref(g, c))
        require(rel <= 1e-5, f"combine ({m}, {cp}): rel {rel:.2e}")
        del out
        row = {"ms": time_ms(lambda: coded_combine_call(g, c), reps),
               "plain_ms": time_ms(lambda: coded_combine_ref(g, c), reps),
               "library_ms": time_ms(lambda: torch.matmul(c, g), reps)}
        row["bound_ms"], by = bound_ms((m * cp + m + cp) * 4, 2 * m * cp)
        co.update({f"{tag}_{key}": v for key, v in row.items()})
        print(f"coded_combine ({m}, {cp}): {row['ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({by}; {row['bound_ms'] / row['ms']:.1%}"
              f" of it); plain {row['plain_ms']:.4f} ms; library "
              f"{row['library_ms']:.4f} ms; max|d| {err:.2e} ({rel:.2e} of "
              f"max|ref|)  [{smi}]")
        del g
        torch.cuda.empty_cache()
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s host clock")


def train_breakdown(step_fn, smi: str, step_ms: float) -> None:
    """Where one coded train step's device time goes: the combine kernel
    (by name), the kernels under the step's ``coded:flatten`` and
    ``coded:adamw`` ranges, and the workers' forward and backward as the
    rest (the backward runs on autograd's own thread, outside the ranges;
    the forward alone is ``coded:worker_grad``'s); the span the workers'
    ranges cover on the device's timeline, the largest kernels, and the
    device's idle share of the profiled wall and of ``step_ms`` (the
    step's unprofiled time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, ranges, spans, kernels = 0.0, {}, {}, []
    for ev in prof.key_averages():
        named = ev.key.startswith("coded:")
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0.0)
            if named:          # the range's span on the device timeline
                spans[ev.key[6:]] = us
            else:
                busy += us
                kernels.append((us, ev.count, ev.key))
        elif named:
            ranges[ev.key[6:]] = getattr(ev, "device_time_total",
                                         getattr(ev, "cuda_time_total", 0.0))
    if busy <= 0:
        print("profile coded-sgd 100m step: the profiler recorded no device "
              "time (breakdown not measured)")
        return
    comb = sum(us for us, _, key in kernels if "combine_kernel" in key)
    flat, adamw = ranges.get("flatten", 0.0), ranges.get("adamw", 0.0)
    workers = busy - comb - flat - adamw
    span = spans.get("worker_grad", 0.0)
    fwd = ranges.get("worker_grad", 0.0)
    print(f"profile coded-sgd 100m step: wall {wall_us:.0f} us, device busy "
          f"{busy:.0f} us (idle share {max(0.0, 1 - busy / wall_us):.2f} of "
          f"the profiled wall, {max(0.0, 1 - busy / (step_ms * 1e3)):.2f} of "
          f"the {step_ms:.1f} ms step); workers' forward and backward "
          f"{workers:.0f} us (forward alone {fwd:.0f} us; the workers' "
          f"ranges span {span:.0f} us of the "
          f"device's timeline), flatten {flat:.0f} us, combine {comb:.0f} "
          f"us, AdamW {adamw:.0f} us  [{smi}]")
    for us, count, key in sorted(kernels, reverse=True)[:8]:
        print(f"  {us:10.1f} us {count:5d}x  {key[:100]}")


def host_available_bytes() -> int:
    """MemAvailable of /proc/meminfo in bytes (0 where it cannot be
    read)."""
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def lipschitz_on_card(X, n: int, iters: int = 60) -> float:
    """max eig of X^T X / n by power iteration on the card (X a float32
    (n, p) tensor there): the LASSO workload's own rule takes it from a
    host ``eigvalsh`` of the p x p matrix, which at p = 100 000 is 80 GB of
    float64."""
    import torch
    g = torch.Generator(device=X.device).manual_seed(0)
    v = torch.randn(X.shape[1], device=X.device, generator=g)
    v /= v.norm()
    for _ in range(iters):
        u = X.T @ (X @ v) / n
        v = u / u.norm()
    return float(v @ (X.T @ (X @ v)) / n)


def wide_phase(smi: str, drive, table: dict) -> None:
    """coded-prox at LASSO §5.4's published width (module docstring, phase
    "wide"); ``drive`` runs one entry with the launch counts cleared just
    before and read just after, and requires its kernels; ``table`` is the
    kernel table, whose rows gain the wide shapes' times under "wide"."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from repro_torch.core import (FastHadamardEncoder, hadamard_ensemble,
                                  hadamard_matrix, make_encoded_problem)
    from repro_torch.data.pipeline import lsq_rows
    from repro_torch.kernels.encode import (srht_encode_call,
                                            srht_encode_plain,
                                            srht_signed_slot_map)
    from repro_torch.kernels.fused_step import (MAX_COLS,
                                                fused_masked_gradient,
                                                fused_masked_gradient_plain,
                                                fused_wide_scratch_bytes)
    from repro_torch.kernels.fwht import fwht_kernel_call, fwht_plain
    from repro_torch.kernels.ref import fused_masked_gradient_ref
    from repro_torch.runtime import (FastestK, ProblemSpec, get_strategy,
                                     scan_prox)
    from repro_torch.workloads import get_workload

    fused, srht, fwht, comb = ("fused_masked_gradient", "srht_encode",
                               "fwht", "coded_combine")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    wl = get_workload("lasso")
    ps = wl.preset("paper")
    p, m, k, lam, beta, steps = ps.dims["p"], ps.m, ps.k, ps.lam, 2.0, 20
    n_pub = ps.dims["n"]
    N_pub = hadamard_ensemble(n_pub, beta, 0)[0]
    # the float64 data, a chunk in flight a thread, and the float32 casts
    # of make_encoded_problem need about 65 GB of host memory at n = 32768
    avail = host_available_bytes()
    n = 32768 if avail >= 70e9 else 20000
    N = hadamard_ensemble(n, beta, 0)[0]
    r = N // m
    print(f"reduced: n {n_pub} -> {n} (S X at the published n is ({N_pub}, "
          f"{p}) float32, {N_pub * p * 4 / 1e9:.1f} GB, more than one card"
          f"{'' if n == 32768 else '; host fallback: ' + str(avail // 10**9) + ' GB available'}"
          f"); steps {ps.steps} -> {steps}; the workload's build (its "
          f"FISTA ground truth and the eigvalsh of the p x p matrix, 80 GB "
          f"of float64) left out: the step size 1 / (1.3 L + lam) takes L "
          f"from a power iteration on the card.  Kept: p {p}, m {m}, k {k}, "
          f"lam {lam}, sparsity {ps.dims['sparse']}, noise "
          f"{ps.dims['noise']}, {ps.delay} delays, seed {ps.seed}, "
          f"fast-Hadamard encoder, beta {beta}: N {N} (FWHT "
          f"{route_of('fwht', n=N)}), r {r} rows a worker, S X ({m}, {r}, "
          f"{p}) float32 "
          f"{m * r * p * 4 / 1e9:.1f} GB")

    # the data: the port's chunk-deterministic generator (the LASSO
    # preset's distribution: Gaussian X, a 7695-sparse w, sigma 40), a
    # 4096-row chunk a thread
    t0 = time.perf_counter()
    X, y, chunk = np.empty((n, p)), np.empty(n), 4096

    def fill(c):
        lo, hi = c * chunk, min(n, (c + 1) * chunk)
        X[lo:hi], y[lo:hi], _ = lsq_rows(lo, hi, p, noise=ps.dims["noise"],
                                         sparse=ps.dims["sparse"],
                                         seed=ps.seed)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(fill, range(-(-n // chunk))))
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xd = torch.empty((n, p), device=dev)
    for r0 in range(0, n, 1024):
        Xd[r0:r0 + 1024] = torch.from_numpy(X[r0:r0 + 1024]).to(
            dev, torch.float32)
    L = lipschitz_on_card(Xd, n)
    del Xd
    step = 1.0 / (1.3 * L + lam)
    t_L = time.perf_counter() - t0
    print(f"wide data ({n}, {p}) float64 {n * p * 8 / 1e9:.1f} GB on the "
          f"host: {t_data:.1f} s host clock; L {L:.6g} (power iteration on "
          f"the card, {t_L:.1f} s), step {step:.6g}")

    # (1) coded-prox through the strategy entry point, and the same call
    # under REPRO_FUSED=0 (the combine kernel) as its oracle
    spec = ProblemSpec(X=X, y=y, lam=lam, h="l1")
    engine = wl.default_engine(ps)
    kw = dict(policy=FastestK(k), encoder="fast-hadamard", beta=beta,
              step_size=step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = drive("wide coded-prox run", lambda: get_strategy(
        "coded-prox").run(spec, engine, steps=steps, **kw),
        {fused: steps, srht: 1})
    t_run = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    with env_var("REPRO_FUSED", "0"):
        ora = drive("wide coded-prox run REPRO_FUSED=0", lambda: get_strategy(
            "coded-prox").run(spec, engine, steps=steps, **kw),
            {comb: steps, srht: 1})
    t_ora = time.perf_counter() - t0
    tr, tr_o = np.asarray(res.objective), np.asarray(ora.objective)
    require(np.isfinite(tr).all(), "wide coded-prox: non-finite objective")
    require(tr[-1] < tr[0], f"wide coded-prox: objective did not fall "
            f"({tr[0]:.6g} -> {tr[-1]:.6g})")
    # f32 sums in another order on each side (the fused kernel's chunked
    # dot products against the einsum and the combine)
    d_rel = float(np.max(np.abs(tr - tr_o) / np.abs(tr_o)))
    require(d_rel <= 1e-4, f"wide coded-prox vs REPRO_FUSED=0: rel "
                           f"{d_rel:.2e}")
    print(f"wide coded-prox run (p {p}, m {m}, k {k}, {steps} steps): "
          f"objective {tr[0]:.6g} -> {tr[-1]:.6g}, support "
          f"{int((res.w != 0).sum())}; {t_run:.1f} s host clock (encode "
          f"included); peak device memory {run_peak / 1e9:.2f} GB; trace vs "
          f"REPRO_FUSED=0 (combine, {t_ora:.1f} s): max rel diff "
          f"{d_rel:.2e} (tol 1e-4)  [{smi}]")

    # (2) decode_t(encode(x)) = beta x at N, 8 columns
    gen = torch.Generator(device=dev).manual_seed(1)
    enc = FastHadamardEncoder(n, beta, seed=0).with_workers(m)
    x8 = torch.randn((n, 8), device=dev, generator=gen)
    E = drive("wide encode", lambda: enc.encode(x8), {srht: 1})
    D = drive("wide decode_t", lambda: enc.decode_t(E), {fwht: 1})
    dec_rel = float((D - enc.beta * x8).norm() / (enc.beta * x8).norm())
    require(dec_rel <= 1e-5, f"wide decode_t(encode(x)) != beta x: "
                             f"{dec_rel:.2e}")
    print(f"wide decode_t(encode(x)) vs beta x at N {N}, 8 columns: rel "
          f"{dec_rel:.2e} (tol 1e-5)")
    del E, D

    # (3) the encode alone: peak device memory against |S X|, host clock
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prob = make_encoded_problem(X, y, FastHadamardEncoder(n, beta, seed=0),
                                m, lam=lam, device=dev)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc_peak = torch.cuda.max_memory_allocated() - base
    sx_bytes = prob.SX.numel() * prob.SX.element_size()
    require(enc_peak <= 2.1 * sx_bytes, f"encode peak {enc_peak / 1e9:.2f} "
            f"GB > 2.1 |S X| = {2.1 * sx_bytes / 1e9:.2f} GB")
    require(run_peak <= 2.1 * sx_bytes, f"run peak {run_peak / 1e9:.2f} GB "
            f"> 2.1 |S X|")
    print(f"wide encode (make_encoded_problem): {t_enc:.1f} s host clock; "
          f"peak device memory {enc_peak / 1e9:.2f} GB = "
          f"{enc_peak / sx_bytes:.3f} |S X| (|S X| {sx_bytes / 1e9:.2f} GB; "
          f"limit 2.1); X on the card {prob.X.numel() * 4 / 1e9:.2f} GB")
    # where a step's device time goes: the column-split form's cluster
    # kernel (the route p = 100 000 takes) and its second stage, and the
    # objective on the original data; the two-read form's kernels must not
    # appear
    masks5 = torch.as_tensor(res.schedule.masks[:5], device=dev)
    prof = device_breakdown(lambda: scan_prox(prob, masks5, step,
                                              torch.zeros(p, device=dev)),
                            "5 wide coded-prox steps")
    names = [key for _, _, key in prof]
    require(not prof or any("fused_wide_cluster" in k for k in names),
            "wide coded-prox profile: no fused_wide_cluster kernel")
    require(not any("wide_residual" in k or "wide_gradient" in k
                    for k in names),
            "wide coded-prox profile: the two-read form ran")
    SX, Sy = prob.SX, prob.Sy
    del prob, spec, X, y

    # (4) each kernel against its plain version at the wide shapes
    wide = {kn: [] for kn in (fused, srht, fwht)}

    def row(kname, shape, fn, plain, lib, nbytes, flops, reps, route=None):
        out = {"shape": shape, "ms": time_ms(fn, reps),
               "plain_ms": time_ms(plain, 3) if plain else None,
               "library_ms": time_ms(lib, 3) if lib else None}
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
        extra = ""
        if route:
            # the Hadamard rows: the route, and where the host's launch
            # path paces the call, the card's own share
            out["plan"] = route
            extra = f"; {route}"
            if reps >= 20:
                out["device_ms"] = graph_ms(fn)
                extra += (f"; device {out['device_ms']:.4f} ms a call "
                          f"(CUDA graph replay)")
        wide[kname].append(out)
        plain_s = f"{out['plain_ms']:.4f} ms" if plain else "not measured"
        lib_s = f"{out['library_ms']:.4f} ms" if lib else "none"
        print(f"time {kname} {shape}: {out['ms']:.4f} ms; bound "
              f"{out['bound_ms']:.4f} ms ({out['bound_by']}); plain "
              f"{plain_s}; library {lib_s}{extra}  [{smi}]")
        return out

    # the fused gradient on the encoded data: p = MAX_COLS + 1 and p, 8
    # workers, batched R = 4 rows equal to single calls bit for bit
    fkw = dict(n=n, beta=beta)
    rng = np.random.default_rng(0)
    masks4 = torch.as_tensor((rng.random((4, 8)) < 0.7).astype(np.float32),
                             device=dev)
    masks4[:, 0] = 1.0
    for pw in (MAX_COLS + 1, p):
        SX8 = SX[:8, :, :pw].contiguous() if pw < p else SX[:8]
        Sy8 = Sy[:8].contiguous()
        W4 = torch.randn((4, pw), device=dev, generator=gen) * 0.01
        g4 = fused_masked_gradient(SX8, Sy8, W4, masks4, **fkw)
        err, rel = rel_err(g4, fused_masked_gradient_plain(SX8, Sy8, W4,
                                                           masks4, **fkw))
        # f32 dot products of pw terms in chunks, rows of r terms
        require(rel <= 1e-4, f"fused p={pw}: rel err {rel:.2e}")
        for q in range(4):
            require(torch.equal(g4[q], fused_masked_gradient(
                SX8, Sy8, W4[q], masks4[q], **fkw)),
                f"fused p={pw}: batched row {q} != single call")
        print(f"check fused (8, {r}, {pw}) batched R=4, "
              f"{route_of('fused', p=pw, itemsize=4)}: max|d| {err:.3e} "
              f"({rel:.2e} of max|ref|, tol 1e-4); batched[q] == single(q) "
              f"bitwise; scratch a realization "
              f"{fused_wide_scratch_bytes(8, r, pw) / 1e6:.1f} MB")
        table[fused]["max_abs_err"] = max(table[fused]["max_abs_err"], err)
    act = int(masks4[0].sum())
    row(fused, f"(8, {r}, {p}) single, {act} active",
        lambda: fused_masked_gradient(SX8, Sy8, W4[0], masks4[0], **fkw),
        lambda: fused_masked_gradient_plain(SX8, Sy8, W4[:1], masks4[:1],
                                            **fkw),
        lambda: fused_masked_gradient_ref(SX8, Sy8, W4[0], masks4[0], **fkw),
        (act * r * (p + 1) + 2 * p + 8) * 4, 4 * act * r * p, 20)
    act = int((masks4.sum(0) > 0).sum())
    row(fused, f"(8, {r}, {p}) batched R=4, {act} active in some "
        f"realization", lambda: fused_masked_gradient(SX8, Sy8, W4, masks4,
                                                      **fkw),
        lambda: fused_masked_gradient_plain(SX8, Sy8, W4, masks4, **fkw),
        lambda: [fused_masked_gradient_ref(SX8, Sy8, W4[q], masks4[q], **fkw)
                 for q in range(4)],
        (act * r * (p + 1) + 2 * 4 * p + 4 * 8) * 4,
        4 * int(masks4.sum()) * r * p, 20)
    mask = torch.as_tensor(res.schedule.masks[0], device=dev)
    act = int(mask.sum())
    w = torch.randn(p, device=dev, generator=gen) * 0.01
    active_bytes = act * r * p * 4
    scratch = fused_wide_scratch_bytes(m, r, p)
    require(scratch <= active_bytes / 16, f"fused scratch {scratch} > 1/16 "
            f"of the active S X bytes {active_bytes}")
    print(f"fused scratch a realization at ({m}, {r}, {p}): "
          f"{scratch / 1e9:.3f} GB = 1/{active_bytes / scratch:.1f} of the "
          f"{act} active workers' S X ({active_bytes / 1e9:.2f} GB)")
    # the library yardstick at the path's shape: two torch.bmm calls, the
    # masked residual of every worker's rows, then (S X)^T times it summed
    # over the workers; each reads all of S X once, and neither copies it
    cw = mask * (m / act) / (n * beta)

    def fused_library():
        u = torch.bmm(SX, w.view(1, p, 1).expand(m, p, 1)) - Sy[..., None]
        u = u * cw[:, None, None]
        return torch.bmm(SX.view(1, m * r, p).transpose(1, 2),
                         u.view(1, m * r, 1)).view(p)

    err, rel = rel_err(fused_library(), fused_masked_gradient(SX, Sy, w,
                                                              mask, **fkw))
    # f32 dot products of p and m r terms in other orders
    require(rel <= 1e-4, f"fused library form at the path's shape: rel "
                         f"{rel:.2e}")
    print(f"fused library form (two torch.bmm) at ({m}, {r}, {p}) vs the "
          f"kernel: max|d| {err:.3e} ({rel:.2e} of max|ref|, tol 1e-4)")
    # the bytes the cluster route reads (each active row of S X and Sy
    # once, w, the masks) and writes (G)
    path_bytes = (act * r * (p + 1) + 2 * p + m) * 4
    got = row(fused, f"({m}, {r}, {p}) single, {act} active (the path's "
              f"step)", lambda: fused_masked_gradient(SX, Sy, w, mask, **fkw),
              None, fused_library, path_bytes, 4 * act * r * p, 10)
    got["plan"] = route_of("fused", p=p, itemsize=4)
    got["source"] = "src/repro_torch/kernels/csrc/fused_wide.cu"
    got["bytes_per_s"] = path_bytes / (got["ms"] * 1e-3)
    print(f"fused at the path's ({m}, {r}, {p}), {act} active, "
          f"{got['plan']}: kernel {got['ms']:.4f} ms, {path_bytes / 1e9:.3f} "
          f"GB (each active row once) at {got['bytes_per_s'] / 1e12:.2f} "
          f"TB/s; two torch.bmm {got['library_ms']:.4f} ms; bound "
          f"{got['bound_ms']:.4f} ms: the kernel is "
          f"{got['library_ms'] / got['ms']:.2f}x the library's speed, "
          f"{got['bound_ms'] / got['ms']:.2f} of its bound  [{smi}]")
    del SX, Sy, SX8, Sy8

    # FWHT at decode_t's (8, N) and LASSO paper's N; the library yardstick
    # is the dense product with the Sylvester matrix where it fits the card
    floor, unguarded = launch_floor_ms()
    print(f"launch floor: an empty kernel through the kernels' ctypes path "
          f"takes {floor:.4f} ms a call (CUDA events, back to back; "
          f"{unguarded:.4f} ms without the device guard)  [{smi}]")
    for kname in (srht, fwht):
        table[kname]["launch_floor_ms"] = floor
    H256 = torch.as_tensor(hadamard_matrix(256), dtype=torch.float32,
                           device=dev)
    H = torch.kron(H256, H256) if N == 65536 else None
    for rows, nf in ((8, N), (2, N_pub)):
        x = torch.randn((rows, nf), device=dev, generator=gen)
        err, rel = rel_err(fwht_kernel_call(x), fwht_plain(x))
        # f32 butterflies of log2(n) stages summed in another stage order
        require(rel <= 1e-5, f"fwht ({rows}, {nf}): rel {rel:.2e}")
        print(f"check fwht ({rows}, {nf}), {route_of('fwht', n=nf)}: "
              f"max|d| {err:.3e} ({rel:.2e} of max|ref|, tol 1e-5)")
        table[fwht]["max_abs_err"] = max(table[fwht]["max_abs_err"], err)
        row(fwht, f"({rows}, {nf})", lambda: fwht_kernel_call(x),
            lambda: fwht_plain(x),
            (lambda: torch.matmul(x, H)) if nf == N and H is not None
            else None, 2 * x.numel() * 4, x.numel() * math.log2(nf), 20,
            route_of("fwht", n=nf))

    # SRHT of 64 data columns: full frame and worker 5's window; the
    # yardstick is the product with the dense S = H[:, cols] D / sqrt(n)
    _, cols, signs = hadamard_ensemble(n, beta, 0)
    cols_t = torch.as_tensor(cols.astype(np.int32), device=dev)
    signs_t = torch.as_tensor(signs.astype(np.float32), device=dev)
    smap_t = srht_signed_slot_map(cols_t, signs_t, N)
    xt = torch.randn((64, n), device=dev, generator=gen)
    S = (H[:, cols_t.long()] * signs_t / math.sqrt(n)) if H is not None \
        else None
    del H
    for lo, hi in ((0, N), (5 * r, 6 * r)):
        skw = dict(N=N, lo=lo, hi=hi, scale=1.0 / math.sqrt(n))
        err, rel = rel_err(srht_encode_call(xt, cols_t, signs_t, **skw),
                           srht_encode_plain(xt, cols_t, signs_t, **skw))
        require(rel <= 1e-5, f"srht [{lo}, {hi}): rel {rel:.2e}")
        print(f"check srht (64, {n}) -> N {N} window [{lo}, {hi}): max|d| "
              f"{err:.3e} ({rel:.2e} of max|ref|, tol 1e-5)")
        table[srht]["max_abs_err"] = max(table[srht]["max_abs_err"], err)
        Sw = S[lo:hi] if S is not None else None
        got = row(srht, f"(64, {n}) -> [{lo}, {hi}) of {N}",
                  lambda: srht_encode_call(xt, cols_t, signs_t,
                                           smap=smap_t, **skw),
                  lambda: srht_encode_plain(xt, cols_t, signs_t, **skw),
                  (lambda: torch.matmul(Sw, xt.T)) if Sw is not None
                  else None, (64 * n + 64 * (hi - lo)) * 4 + n * 8,
                  64 * N * math.log2(N), 20,
                  route_of("srht", n=n, N=N, lo=lo, hi=hi))
        if got["library_ms"] is not None:
            print(f"srht (64, {n}) -> [{lo}, {hi}) of {N}: the kernel "
                  f"{got['ms']:.4f} ms vs torch.matmul with the dense "
                  f"window {got['library_ms']:.4f} ms: the kernel is "
                  f"{'faster' if got['ms'] < got['library_ms'] else 'slower'}"
                  f"  [{smi}]")
    del S, Sw, xt
    # the path's encode: the (p + 1)-column frame
    xt = torch.randn((p + 1, n), device=dev, generator=gen)
    skw = dict(N=N, lo=0, hi=N, scale=1.0 / math.sqrt(n))
    row(srht, f"({p + 1}, {n}) -> {N} (the path's encode)",
        lambda: srht_encode_call(xt, cols_t, signs_t, smap=smap_t, **skw),
        None, None, ((p + 1) * (n + N)) * 4 + n * 8,
        (p + 1) * N * math.log2(N), 3,
        route_of("srht", n=n, N=N, lo=0, hi=N))
    del xt
    for kname, rows_ in wide.items():
        table[kname]["wide"] = rows_
    print(f"wide phase: {time.perf_counter() - t_phase:.1f} s host clock "
          f"(data {t_data:.1f}, L {t_L:.1f}, fused run {t_run:.1f}, "
          f"REPRO_FUSED=0 run {t_ora:.1f}, encode {t_enc:.1f})")


def tree_layout(tree):
    """A cache tree's nesting, NamedTuple class names and leaf shapes and
    dtypes, for comparing two trees' structure."""
    if isinstance(tree, tuple):
        return (type(tree).__name__, tuple(tree_layout(t) for t in tree))
    return (tuple(tree.shape), str(tree.dtype))


def serve_at_width(label: str, cfg, B: int, S: int, new: int, smi: str,
                   dev, count_drops: bool = False) -> dict:
    """One architecture served on the card at ``cfg``'s width through the
    port's entry points (``init_params``, ``prefill``, ``decode_step``):
    parameters from seed 0, a batch of B random prompts of S tokens, a
    greedy continuation of ``new`` tokens (the result), then the times:
    prefill ms and decode ms a token (CUDA events; five samples after the
    warm-up that the greedy run is, every sample printed), tokens/s and
    peak device memory (this model's own: what was allocated before its
    parameters is not counted).  With ``count_drops`` the MoE layers'
    capacity drops in the prefill are counted in one more, untimed
    prefill, which must reach every MoE layer.
    Returns the parameters, the prompts, the greedy tokens and the
    prefill as a function."""
    import numpy as np
    import torch
    from repro_torch.models import count_params, decode_step, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import prefill
    from repro_torch.models import transformer as T

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                              dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def pre():
        return prefill(params, cfg, prompts, cache_len=S + new)

    def greedy(lg, caches):
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        out = [tok]
        for i in range(new):
            lg, caches = decode_step(params, cfg, tok, caches, S + i)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1), lg

    with torch.no_grad():
        t0 = time.perf_counter()
        lg0, caches = pre()
        toks, lg_last = greedy(lg0, caches)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        require(bool(torch.isfinite(lg0).all()) and
                bool(torch.isfinite(lg_last).all()),
                f"{label}: non-finite logits")
        pre_ms = samples_ms(pre, 5, warmup=0)
        lg1, caches = pre()
        dec_ms = [t / new for t in samples_ms(lambda: greedy(lg1, caches), 5,
                                              warmup=0)]
        drops = None
        if count_drops:
            seen = []
            apply = T.moe_apply

            def counting(p, x, c):
                seen.append(int(moe_mod.capacity_drops(p, x, c)))
                return apply(p, x, c)
            T.moe_apply = counting
            try:
                pre()
            finally:
                T.moe_apply = apply
            n_moe = sum(spec.moe for spec in cfg.period) * cfg.n_periods
            require(len(seen) == n_moe, f"{label}: the drop count reached "
                    f"{len(seen)} of {n_moe} MoE layers")
            drops = sum(seen)
    peak = torch.cuda.max_memory_allocated() - base
    med_dec = sorted(dec_ms)[2]
    n_params = int(count_params(cfg))
    print(f"serve {label}: {n_params} parameters ({cfg.param_dtype}), "
          f"batch {B}, prompt {S}, {new} greedy tokens; init {t_init:.1f} s,"
          f" first prefill + decode {t_first:.2f} s host clock  [{smi}]")
    print(f"serve {label} prefill {B}x{S}: {spread(pre_ms, 'ms')}  [{smi}]")
    print(f"serve {label} decode a token (batch {B}): {spread(dec_ms, 'ms')};"
          f" {B * 1e3 / med_dec:.1f} tokens/s; peak device memory "
          f"{(peak + base - before) / 1e9:.2f} GB ({peak / 1e9:.2f} GB above"
          f" the parameters)  [{smi}]")
    if drops is not None:
        C = moe_mod.moe_capacity(cfg, S)
        print(f"serve {label}: {drops} of {B * S * cfg.top_k * n_moe}"
              f" assignments dropped for capacity in the prefill (capacity "
              f"{C} a row and expert, factor {cfg.capacity_factor})")
    print(f"serve {label}: continuation of prompt 0: "
          f"{toks[0, :12].tolist()}")
    del caches
    return {"params": params, "prompts": prompts, "tokens": toks,
            "prefill": pre}


def serve_consistency(g: dict, cfg, S: int) -> None:
    """prefill's last logits and the first decode step's against
    ``forward`` over S + 1 tokens, in float32 at batch 1, from
    ``serve_at_width``'s parameters (cast), prompt 0 and its first greedy
    token: both within 1e-3 of the largest |logit|, the reference's own
    tolerance (tests/test_decode_consistency.py)."""
    import torch
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.common import cast

    p32 = cast(g["params"], torch.float32)
    f32 = cfg.with_overrides(dtype="float32", param_dtype="float32")
    seq = torch.cat([g["prompts"][:1], g["tokens"][:1, :1].int()], dim=1)
    g.clear()          # the bfloat16 parameters and closures go
    torch.cuda.empty_cache()
    with torch.no_grad():
        full = forward(p32, f32, seq)[0][:, S - 1:].clone()
        torch.cuda.empty_cache()
        lp, caches = prefill(p32, f32, seq[:, :S], cache_len=S + 8)
        ld, _ = decode_step(p32, f32, seq[:, S:], caches, S)
    scale = float(full.abs().max())
    e_pre = float((lp[:, 0] - full[:, 0]).abs().max()) / scale
    e_dec = float((ld[:, 0] - full[:, 1]).abs().max()) / scale
    require(e_pre <= 1e-3 and e_dec <= 1e-3,
            f"{cfg.name} float32 consistency: prefill {e_pre:.2e}, decode "
            f"{e_dec:.2e} of max|logit| > 1e-3")
    print(f"{cfg.name} float32 consistency (batch 1, {S} + 1 tokens): "
          f"prefill's last logits vs forward at {S - 1}: {e_pre:.2e}, the "
          f"first decode step vs forward at {S}: {e_dec:.2e} of max|logit| "
          f"{scale:.3f} (tol 1e-3)")


def serve_phase(smi: str) -> None:
    """The model zoo's serve path on the card (module docstring, phase
    "serve"): no kernel of the port runs here, and the launch counters,
    cleared at the start, must read zero at the end."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.models import (count_params, decode_step, init_params,
                                    prefill)
    from repro_torch.serve import main as serve_main
    from repro_torch.serve import serve_inputs
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _build.launches.clear()
    dev, cpu = torch.device("cuda"), torch.device("cpu")

    # (1) every architecture at its smoke variant, card against CPU, from
    # the same port-initialized float32 parameters (TF32 off: main())
    B, S, new = 2, 64, 8
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].smoke_variant()
        host = init_params(cfg, 0, device="cpu")
        runs = {}
        for d in (dev, cpu):
            params = tree_map(lambda t: t.to(d), host)
            rng = np.random.default_rng(0)
            prompts, kw = serve_inputs(cfg, B, S, rng, d)
            forced = torch.as_tensor(rng.integers(0, cfg.vocab, (B, new)),
                                     device=d)
            with torch.no_grad():
                lg, caches = prefill(params, cfg, prompts, cache_len=S + new,
                                     **kw)
                logits = [lg]
                for i in range(new):         # teacher-forced: no argmax
                    lg, caches = decode_step(params, cfg,
                                             forced[:, i:i + 1], caches,
                                             S + i)
                    logits.append(lg)
            runs[d.type] = (torch.cat(logits, dim=1).cpu(), caches)
        (lc, cc), (lh, ch) = runs["cuda"], runs["cpu"]
        err, rel = rel_err(lc, lh)
        # float32 sums in another order on the card (cuBLAS, reductions)
        require(rel <= 1e-4, f"serve {arch}: card vs CPU logits rel "
                             f"{rel:.2e} > 1e-4")
        require(tree_layout(cc) == tree_layout(ch),
                f"serve {arch}: cache trees differ card vs CPU")
        print(f"serve {arch} smoke: prefill {B}x{S} + {new} decode steps, "
              f"card vs CPU logits max|d| {err:.3e} ({rel:.2e} of max|ref|, "
              f"tol 1e-4); caches: {len(tree_leaves(cc))} leaves, structure "
              f"and shapes equal")
    del runs, host, params, caches

    # (2) gemma2-27b at its published width, depth cut to one period
    gcfg = ARCHS["gemma2-27b"].with_overrides(n_layers=2)
    n_g = int(count_params(gcfg))
    require(n_g == 2312151552, f"gemma2-27b 2 layers: {n_g} parameters")
    print(f"reduced: gemma2-27b (arXiv:2408.00118) layers 46 -> 2 (one "
          f"period: the local layer, window 4096, and the global one); kept: "
          f"d_model 4608, 32 heads (16 KV) of 128, d_ff 36864, vocab 256000, "
          f"soft-caps 50 / 30, bfloat16; {n_g} parameters")
    g = serve_at_width("gemma2-27b", gcfg, 4, 8192, 32, smi, dev)
    with torch.no_grad():
        lg, caches = g["prefill"]()
        device_breakdown(g["prefill"], "gemma2-27b prefill 4x8192")
        tok = g["tokens"][:, :1]
        device_breakdown(lambda: decode_step(g["params"], gcfg, tok, caches,
                                             8192),
                         "gemma2-27b decode step (batch 4)")
    del lg, caches
    # the consistency check in float32 at B = 1 on the same width and depth
    serve_consistency(g, gcfg, 8192)
    del g
    torch.cuda.empty_cache()

    # (3) phi3.5-moe at its published width, one layer
    pcfg = ARCHS["phi3.5-moe-42b-a6.6b"].with_overrides(n_layers=1)
    n_p = int(count_params(pcfg))
    require(n_p == 1431646208, f"phi3.5-moe 1 layer: {n_p} parameters")
    print(f"reduced: phi3.5-moe-42b-a6.6b (hf:microsoft/Phi-3.5-MoE-instruct)"
          f" layers 32 -> 1; kept: d_model 4096, 32 heads (8 KV), 16 experts "
          f"top-2 of d_ff 6400, vocab 32064, capacity factor 1.25, bfloat16;"
          f" {n_p} parameters")
    serve_at_width("phi3.5-moe", pcfg, 2, 4096, 16, smi, dev,
                   count_drops=True)
    torch.cuda.empty_cache()

    # (4) xlstm-350m whole
    xcfg = ARCHS["xlstm-350m"]
    n_x = int(count_params(xcfg))
    require(n_x == 393131104, f"xlstm-350m: {n_x} parameters")
    print(f"xlstm-350m (arXiv:2405.04517) whole: 24 layers (12 mLSTM, 12 "
          f"sLSTM), d_model 1024, bfloat16, {n_x} parameters; the sLSTM "
          f"layers run a Python loop of one step a token (host-paced)")
    serve_at_width("xlstm-350m", xcfg, 2, 1024, 16, smi, dev)
    torch.cuda.empty_cache()

    # (5) the serve CLI, in-process, on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(["--arch", "gemma2-27b"])
    lines = buf.getvalue().splitlines()
    require(rc == 0 and len(lines) == 3 and lines[0].startswith("prefill:")
            and lines[1].startswith("decoded "),
            f"python -m repro_torch.serve: rc {rc}, output {lines}")
    for line in lines:
        print(f"python -m repro_torch.serve --arch gemma2-27b: {line}")

    got = {k: v for k, v in _build.launches.items() if v}
    require(not got, f"serve phase launched kernels of the port: {got}")
    print(f"serve phase: {time.perf_counter() - t_phase:.1f} s host clock; "
          f"no kernel of the port launched (counters read 0)  [{smi}]")


def launch_phase(smi: str, drive) -> None:
    """The launchers (module docstring, phase "launch"): the coded training
    CLI at smoke width on the card and the CPU, its body at deepseek-7b's
    published width, ``grad_specs`` on a one-card mesh, and the meta-device
    dry run in a process of its own.  ``drive`` runs one entry with the
    launch counts cleared just before and read just after, and requires
    its kernels."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import repro_torch.train.coded as coded
    from repro_torch.configs import get_config
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import parser, train
    from repro_torch.models import count_params, init_params, param_axes
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.sharding import make_shardings
    from repro_torch.train.steps import build_train_step
    from repro_torch.tree import tree_leaves

    comb = "coded_combine"
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_launch_"))

    # (1) python -m repro_torch.launch.train at the smoke variant, in-process,
    # on the card and with --device cpu
    argv = ["--arch", "deepseek-7b", "--smoke", "--steps", "10"]
    hists = {}
    for label, extra, want in (("card", [], {comb: 10}),
                               ("cpu", ["--device", "cpu"], {})):
        out = tmp / f"{label}.json"
        t0 = time.perf_counter()
        rc, text = drive(f"launch.train --smoke {label}", lambda: quiet(
            train_main, argv + extra + ["--history-out", str(out)]), want)
        require(rc == 0, f"launch.train {label}: exit code {rc}")
        hists[label] = json.loads(out.read_text())
        print(f"python -m repro_torch.launch.train {' '.join(argv + extra)}: "
              f"{text.strip().splitlines()[-1]}; {time.perf_counter() - t0:.1f}"
              f" s host clock")
    lc = np.asarray([h["loss"] for h in hists["card"]])
    lh = np.asarray([h["loss"] for h in hists["cpu"]])
    rel = float(np.max(np.abs(lc - lh) / np.abs(lh)))
    require(np.isfinite(lc).all() and rel <= 1e-4,
            f"launch.train card vs CPU losses: rel {rel:.2e}")
    require([h["sim_time_s"] for h in hists["card"]]
            == [h["sim_time_s"] for h in hists["cpu"]],
            "launch.train card vs CPU: simulated times differ")
    print(f"launch.train --smoke card vs CPU, 10 steps: losses max rel "
          f"{rel:.2e} (tol 1e-4), simulated times bit for bit; 10 combine "
          f"launches on the card, one a coded step")

    # (2) the CLI's body at deepseek-7b's published width, one layer of 30
    base = get_config("deepseek-7b")
    cfg7 = base.with_overrides(n_layers=1)
    p7 = int(count_params(cfg7))
    print(f"reduced: n_layers {base.n_layers} -> 1 (deepseek-7b, "
          f"arXiv:2401.02954: d_model {cfg7.d_model}, {cfg7.n_heads} heads, "
          f"d_ff {cfg7.d_ff}, vocab {cfg7.vocab}, {cfg7.param_dtype}; "
          f"{p7} parameters)")
    # four steps: the first carries the warm-up and is not timed
    args = parser().parse_args(["--arch", "deepseek-7b", "--steps", "4"])
    shapes: list = []
    comb_ev: list = []
    plain_call = coded.coded_combine_call

    def watch(g, c):
        shapes.append(tuple(g.shape))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = plain_call(g, c)
        ev[1].record()
        comb_ev.append(ev)
        return out

    marks = []

    def tick(rec):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg7, 0)       # the trainer's own seeded draw
    coded.coded_combine_call = watch
    try:
        tick(None)
        _, _, hist = drive("launch.train body deepseek-7b 1 layer",
                           lambda: train(cfg7, args, params, callback=tick),
                           {comb: 4})
    finally:
        coded.coded_combine_call = plain_call
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    comb_ms = [a.elapsed_time(b) for a, b in comb_ev]
    losses = [h["loss"] for h in hist]
    require(np.isfinite(losses).all(), "launch.train deepseek-7b 1 layer: "
                                       "non-finite loss")
    require(shapes == [(args.m_workers, p7)] * 4,
            f"launch.train deepseek-7b combines at {shapes}")
    share = sum(comb_ms[1:]) / sum(step_ms[1:])
    print(f"launch.train body, deepseek-7b 1 layer (m {args.m_workers}, "
          f"k {args.wait_k}, beta {args.beta}, {args.rows_per_worker} rows a "
          f"group, seq {args.seq_len}, 4 steps): losses "
          f"{[round(x, 4) for x in losses]}; warm-up step "
          f"{step_ms[0]:.2f} ms; steps 2-4 (CUDA events between steps) "
          f"{spread(step_ms[1:], 'ms', 2)}; the combine inside them (CUDA "
          f"events around its call) {spread(comb_ms[1:], 'ms', 4)}, "
          f"{share:.2%} of the step; 4 combine launches at "
          f"({args.m_workers}, {p7}); peak device memory {peak:.2f} GB  "
          f"[{smi}]")
    del hist, params
    torch.cuda.empty_cache()

    # (3) grad_specs on a one-card mesh: bit for bit the step without it
    mesh = make_local_mesh()
    try:
        params = init_params(cfg7, 0)
        opt = adamw_init(params)
        rng = np.random.default_rng(0)
        tok = torch.as_tensor(rng.integers(0, cfg7.vocab, (2, 128)),
                              dtype=torch.int32, device="cuda")
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1),
                 "weights": torch.ones(2, device="cuda")}
        sh = make_shardings(mesh, params, param_axes(cfg7))
        lr = cosine_schedule(3e-3, 2, 10)
        a = build_train_step(cfg7, lr)(params, opt, batch)
        b = build_train_step(cfg7, lr, grad_specs=sh)(params, opt, batch)
        same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a[:2]),
                                                     tree_leaves(b[:2])))
        require(same and torch.equal(a[2]["loss"], b[2]["loss"]),
                "grad_specs on a 1 x 1 mesh changed the step")
        print(f"grad_specs on a 1 x 1 mesh ({mesh.device_type}, "
              f"{dist.get_backend()}): deepseek-7b 1 layer, batch 2 x 128, "
              f"parameters, optimizer state and loss "
              f"({float(a[2]['loss']):.6f}) equal bit for bit to the step "
              f"without it")
        del a, b, params, opt
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (4) the meta-device dry run, in processes of its own (their fake
    # 512-rank groups never meet this process's groups), the three started
    # together
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = []
    for arch, shape, mesh_flag in (
            ("deepseek-7b", "train_4k", "both"),
            ("phi3.5-moe-42b-a6.6b", "decode_32k", "single"),
            ("jamba-1.5-large-398b", "long_500k", "single")):
        out = tmp / f"dry_{arch}_{shape}"
        runs.append((arch, shape, mesh_flag, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh_flag, "--quiet",
             "--out", str(out)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)))
    t0 = time.perf_counter()
    try:
        done = [(run, run[4].communicate(timeout=600)) for run in runs]
    finally:
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for (arch, shape, mesh_flag, out, proc), (so, se) in done:
        require(proc.returncode == 0, f"dryrun {arch} {shape}: exit code "
                f"{proc.returncode}\n{so[-2000:]}\n{se[-2000:]}")
        recs = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
        require(len(recs) == (2 if mesh_flag == "both" else 1),
                f"dryrun {arch} {shape}: {len(recs)} records")
        for rec in recs:
            require("error" not in rec, f"dryrun {arch} {shape}: {rec}")
            rl = rec["roofline"]
            print(f"dryrun {arch} {shape} {rec['mesh']} ({rec['n_chips']} "
                  f"chips, {rec['kind']}): argument bytes a device "
                  f"{rec['memory']['argument_bytes_per_device']}, output "
                  f"{rec['memory']['output_bytes_per_device']}; roofline "
                  f"compute {rl['compute_s']:.6g} s, memory "
                  f"{rl['memory_s']:.6g} s, collective "
                  f"{rl['collective_s']:.6g} s -> {rl['bottleneck']}; flops "
                  f"a device {rl['hlo_flops_per_device']:.6g}, useful ratio "
                  f"{rl['useful_ratio']:.4f}; trace {rec['lower_s']} s host "
                  f"clock")
    print(f"dryrun (3 processes at once, H100 terms traced on meta): "
          f"{wall:.1f} s host clock until the last ended")
    shutil.rmtree(tmp)
    print(f"launch phase: {time.perf_counter() - t_phase:.1f} s host clock"
          f"  [{smi}]")


def threaded_run(devices, prob, masks, step, W0, **kw):
    """The dispatch design ``_sharded_run`` does not take, timed beside it:
    a host thread a shard, each running its own step loop
    (``runners._run``) with its card current."""
    import threading
    import torch
    from repro_torch.runtime import runners
    c = len(masks) // len(devices)
    outs = [None] * len(devices)

    def shard(j):
        with torch.cuda.device(devices[j]):
            outs[j] = runners._run(prob.to(devices[j]),
                                   masks[j * c:(j + 1) * c], step,
                                   W0[j * c:(j + 1) * c], **kw)

    threads = [threading.Thread(target=shard, args=(j,))
               for j in range(len(devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return (torch.cat([w.to(prob.device) for w, _ in outs]),
            torch.cat([tr.to(prob.device) for _, tr in outs]))


def sharded_phase(cfg, step: float, smi: str, drive) -> None:
    """The realization axis over cards at PAPER_RIDGE's width, R = 8:
    ``run_batched(placement="sharded")`` for coded-gd (100 steps) and
    coded-prox (50) beside ``placement="vmap"``, the split, the launches
    and the gather over two shards of card 0, and over every card where
    there are more than one (then Fig. 7 at R = 32 too)."""
    import numpy as np
    import torch
    from repro_torch.core import (FastHadamardEncoder, bimodal_delays,
                                  make_encoded_problem)
    from repro_torch.runtime import (ClusterEngine, FastestK, ProblemSpec,
                                     get_strategy, runners)
    from repro_torch.workloads import get_workload
    from repro_torch.workloads.runner import main as workloads_main
    t_phase = time.perf_counter()
    ndev = torch.cuda.device_count()
    print(f"sharded: torch.cuda.device_count() = {ndev}")
    dev = torch.device("cuda", 0)
    n, p, m, k = cfg.n, cfg.p, cfg.m, cfg.k[1]
    R = 8
    spec = ProblemSpec.synthetic(n, p, noise=0.5, lam=cfg.lam, seed=0)
    l1spec = ProblemSpec(X=spec.X, y=spec.y, lam=cfg.lam, h="l1")
    engine = ClusterEngine(bimodal_delays(), m, seed=0)
    kw = dict(policy=FastestK(k), encoder="fast-hadamard", step_size=step)
    fused, srht = "fused_masked_gradient", "srht_encode"
    split = runners.trials_device_count(R)
    require(split == (ndev if ndev > 1 and R % ndev == 0 else 1),
            f"sharded: trials_device_count({R}) = {split} on {ndev} cards")
    schedules = {}
    for name, sp, T in (("coded-gd", spec, 100), ("coded-prox", l1spec, 50)):
        out = {}
        for placement in ("sharded", "vmap"):
            out[placement] = drive(
                f"{name} run_batched R={R} {placement}",
                lambda: get_strategy(name).run_batched(
                    sp, engine, steps=T, trials=R, placement=placement,
                    **kw),
                {fused: T * (split if placement == "sharded" else 1),
                 srht: 1})
        sh, vm = out["sharded"], out["vmap"]
        require(sh.meta["placement_devices"] == split,
                f"sharded {name}: placement_devices "
                f"{sh.meta['placement_devices']} != {split}")
        require(np.array_equal(sh.objective, vm.objective) and
                np.array_equal(sh.w, vm.w) and
                np.array_equal(sh.times, vm.times),
                f"sharded {name}: placement sharded != vmap")
        print(f"sharded {name} run_batched R={R}, {T} steps: "
              f"placement_devices {split}; w, trace and times == vmap bit "
              f"for bit; {split * T} fused launches")
        schedules[name] = (T, vm.schedules.masks)

    # the split, the per-card launches and the gather over two shards of
    # card 0, then over every card
    prob = make_encoded_problem(spec.X, spec.y,
                                FastHadamardEncoder(n, cfg.beta, seed=0), m,
                                lam=spec.lam, device=dev)
    layouts = [("2 shards on cuda:0", [dev, dev])]
    if ndev > 1:
        layouts.append((f"{ndev} cards",
                        [torch.device("cuda", i) for i in range(ndev)]))
    for label, devices in layouts:
        RS = math.lcm(R, len(devices))
        for name, (T, masks) in schedules.items():
            kind = "prox" if name == "coded-prox" else "gd"
            if RS != R:
                masks = engine.sample_schedules(T, FastestK(k), RS).masks
            masks = torch.as_tensor(masks, device=dev)
            W0 = torch.zeros((RS, p), device=dev)
            rkw = dict(h="l1" if kind == "prox" else "l2", eval_every=1,
                       degrade=None)
            batched = (runners.batched_scan_prox if kind == "prox"
                       else runners.batched_scan_gd)
            ws, ts = drive(f"{name} _sharded_run {label}",
                           lambda: runners._sharded_run(
                               devices, kind, prob, masks, step, W0, **rkw),
                           {fused: len(devices) * T})
            wi, ti = threaded_run(devices, prob, masks, step, W0,
                                  kind=kind, **rkw)
            wb, tb = batched(prob, masks, step, W0, eval_every=1)
            require(torch.equal(ws, wb) and torch.equal(ts, tb),
                    f"{name} {label}: sharded != batched")
            require(torch.equal(wi, wb) and torch.equal(ti, tb),
                    f"{name} {label}: threads != batched")
            # one sample a design in turns (interleaved, threads,
            # batched, batched, threads, interleaved), three rounds
            runs = {"interleaved": lambda: runners._sharded_run(
                        devices, kind, prob, masks, step, W0, **rkw),
                    "threads": lambda: threaded_run(
                        devices, prob, masks, step, W0, kind=kind, **rkw),
                    "batched": lambda: batched(prob, masks, step, W0,
                                               eval_every=1)}
            got = {key: [] for key in runs}
            order = list(runs) + list(runs)[::-1]
            for _ in range(3):
                for key in order:
                    got[key] += [t / T for t in samples_ms(runs[key], 1)]
            print(f"sharded {name} {label}, R={RS}, {T} steps: w and trace "
                  f"== batched bit for bit (interleaved and threads); "
                  f"{len(devices) * T} fused launches; a step: interleaved "
                  f"(kept) {spread(got['interleaved'], 'ms')}, threads "
                  f"{spread(got['threads'], 'ms')}, batched "
                  f"{spread(got['batched'], 'ms')}  [{smi}]")
    del prob
    if ndev > 1:
        RF = 32
        T = get_workload("ridge").preset("paper").steps
        split = runners.trials_device_count(RF)
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
        recs = {}
        for placement in ("sharded", "vmap"):
            argv = ["--workload", "ridge", "--preset", "paper",
                    "--strategies", "coded,replication,uncoded", "--trials",
                    str(RF), "--placement", placement, "--out",
                    str(tmp / placement), "--formats", "json"]
            got, _ = drive(f"fig7 {placement} R={RF}",
                           lambda: quiet(workloads_main, argv),
                           {"coded_combine": RF * T,
                            fused: 2 * T * (split if placement == "sharded"
                                            else 1)})
            recs[placement] = {r["strategy"]: r for r in got}
        shutil.rmtree(tmp, ignore_errors=True)
        # the workload records keep no placement field: the fused launches
        # (one a step on each card, for replication and uncoded) show the
        # split; coded-lbfgs runs its realizations in turn on one card
        for name, rec in recs["sharded"].items():
            require(rec["metric"] == recs["vmap"][name]["metric"] and
                    rec["times"] == recs["vmap"][name]["times"],
                    f"fig7 sharded {name} != vmap")
        print(f"fig7 sharded over {split} cards (R = {RF}): gaps and times "
              f"== vmap bit for bit; {2 * T * split} fused launches")
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s host "
          f"clock  [{smi}]")


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
    from repro_torch.kernels.encode import (srht_encode_call,
                                            srht_encode_plain,
                                            srht_signed_slot_map)
    from repro_torch.kernels.fused_step import (
        MAX_COLS, fused_masked_gradient, fused_masked_gradient_plain,
        pick_fused_realization_tile, wide_plan)
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
    print(f"check fwht {tuple(x.shape)}, {route_of('fwht', n=N)}: max|d| "
          f"{err:.3e} ({rel:.2e} of max|ref|, tol 1e-5)")
    table["fwht"] = {"max_abs_err": err}

    # SRHT of the (n, p + 1) data: full frame and worker 5's window
    X = torch.randn((n, p + 1), device=dev, generator=gen)
    xt = X.t().contiguous()
    cols_t = torch.as_tensor(cols.astype(np.int32), device=dev)
    signs_t = torch.as_tensor(signs.astype(np.float32), device=dev)
    # the signed slot map, built once as an encoder's caller does: the
    # timed calls below are then one launch each
    smap_t = srht_signed_slot_map(cols_t, signs_t, N)
    scale = 1.0 / math.sqrt(n)
    srht_err = 0.0
    for lo, hi in ((0, N), (5 * r, 6 * r)):
        kw = dict(N=N, lo=lo, hi=hi, scale=scale)
        err, rel = rel_err(srht_encode_call(xt, cols_t, signs_t, **kw),
                           srht_encode_plain(xt, cols_t, signs_t, **kw))
        require(rel <= 1e-5, f"srht [{lo},{hi}): max|d| {err:.3e} = "
                             f"{rel:.2e} max|ref|")
        print(f"check srht window [{lo}, {hi}), "
              f"{route_of('srht', n=n, N=N, lo=lo, hi=hi)}: max|d| "
              f"{err:.3e} ({rel:.2e} of max|ref|, tol 1e-5)")
        srht_err = max(srht_err, err)
    table["srht_encode"] = {"max_abs_err": srht_err}
    hadamard_routes(dev, gen, table)

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
    # the column-split form's plan, field by field, at every 61st width
    # past MAX_COLS to 2^20 in both dtypes
    bad_wide = []
    for q in range(MAX_COLS + 1, (1 << 20) + 1, 61):
        for itemsize in (4, 2):
            pl = wide_plan(q, itemsize)
            want = [int(pl.route == "cluster"), pl.C, pl.slice_cols,
                    pl.threads, pl.vectors, pl.tile, pl.slots]
            if [lib.repro_fused_wide_plan(q, itemsize, fld)
                    for fld in range(7)] != want:
                bad_wide.append((q, itemsize))
    require(not bad_rt and not bad_g and not bad_wide, f"kernel and wrapper "
            f"disagree: tile at p {bad_rt[:5]}, row groups at m {bad_g[:5]}, "
            f"wide plan at (p, itemsize) {bad_wide[:5]}")
    print(f"check shape choices: realization tile at p = {p}: "
          f"{pick_fused_realization_tile(p)} (kernel == wrapper for every "
          f"p <= {MAX_COLS}); combine row groups at m = {m}: "
          f"{combine_row_groups(m)} (kernel == wrapper for m <= 256); the "
          f"column-split plan kernel == wrapper at every 61st p to 2^20, "
          f"float32 and bfloat16")

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
    # coded SGD over the dense LM ------------------------------------------
    train_phase(smi, drive, table["coded_combine"])
    # coded-prox at LASSO §5.4's published width ---------------------------
    wide_phase(smi, drive, table)
    # the model zoo's serve path ----------------------------------------------
    serve_phase(smi)
    # the launchers: the coded training CLI, grad_specs, the dry run ----------
    launch_phase(smi, drive)
    # the realization axis over cards (placement="sharded") ----------------
    sharded_phase(cfg, step, smi, drive)
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
    fw["plan"] = route_of("fwht", n=N)
    del H

    # SRHT full frame: read the (p + 1, n) data and (cols, signs), write the
    # (p + 1, N) frame; the yardstick is the product with the dense S
    S = torch.as_tensor(hadamard_matrix(N)[:, cols] * signs[None, :] /
                        math.sqrt(n), dtype=torch.float32, device=dev)
    se = table["srht_encode"]
    kw = dict(N=N, lo=0, hi=N, scale=scale)
    se["ms"] = time_ms(lambda: srht_encode_call(xt, cols_t, signs_t,
                                                smap=smap_t, **kw), 20)
    se["plain_ms"] = time_ms(
        lambda: srht_encode_plain(xt, cols_t, signs_t, **kw), 5)
    se["library_ms"] = time_ms(lambda: torch.matmul(S, X), 3)
    se["bound_ms"], se["bound_by"] = bound_ms(
        (xt.numel() + (p + 1) * N) * 4 + n * 8, (p + 1) * N * math.log2(N))
    se["plan"] = route_of("srht", n=n, N=N, lo=0, hi=N)
    # worker 5's window of the same data: read the (p + 1, n) data and
    # (cols, signs), write r rows; the yardstick is the product with the
    # dense window of S
    lo, hi = 5 * r, 6 * r
    kw = dict(N=N, lo=lo, hi=hi, scale=scale)
    Sw = S[lo:hi].contiguous()
    win = {"shape": f"({p + 1}, {n}) -> [{lo}, {hi}) of {N}",
           "plan": route_of("srht", n=n, N=N, lo=lo, hi=hi),
           "ms": time_ms(lambda: srht_encode_call(xt, cols_t, signs_t,
                                                  smap=smap_t, **kw), 20),
           "plain_ms": time_ms(lambda: srht_encode_plain(
               xt, cols_t, signs_t, **kw), 5),
           "library_ms": time_ms(lambda: torch.matmul(Sw, X), 20)}
    win["bound_ms"], win["bound_by"] = bound_ms(
        (xt.numel() + (p + 1) * r) * 4 + n * 8,
        (p + 1) * (N + r * math.log2(r)))
    win["device_ms"] = graph_ms(lambda: srht_encode_call(
        xt, cols_t, signs_t, smap=smap_t, **kw))
    se["window"] = win
    print(f"time srht_encode {win['shape']}: {win['ms']:.4f} ms; bound "
          f"{win['bound_ms']:.4f} ms ({win['bound_by']}); plain "
          f"{win['plain_ms']:.4f} ms; library (torch.matmul, dense window) "
          f"{win['library_ms']:.4f} ms; {win['plan']}; device "
          f"{win['device_ms']:.4f} ms a call (CUDA graph replay)  [{smi}]")
    del S, Sw

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

        def two_products(Wr=Wr, mr=mr):
            """cuBLAS's two products for the same (R, p): every worker's
            rows times the R iterates, then (S X)^T times the residuals
            weighted by each realization's decode weights."""
            c = mr * (m / mr.sum(-1, keepdim=True).clamp_min(1.0)) / (
                n * cfg.beta)
            U = torch.matmul(SX.view(m * r, p), Wr.t()) - Sy.view(m * r, 1)
            Cw = c.t().repeat_interleave(r, 0)            # (m r, R)
            return torch.matmul(SX.view(m * r, p).t(), U * Cw).t()
        b_err, b_rel = rel_err(two_products(), fused_masked_gradient(
            SX, Sy, Wr, mr, **fkw))
        require(b_rel <= 1e-4, f"fused R={R}: two products vs kernel rel "
                               f"{b_rel:.2e}")
        b_two = time_ms(two_products, 20)
        fu[f"batched_r{R}_ms"] = b_ms
        fu[f"batched_r{R}_bound_ms"] = b_bound
        fu[f"batched_r{R}_plain_ms"] = b_plain
        fu[f"batched_r{R}_library_ms"] = b_lib
        fu[f"batched_r{R}_two_products_ms"] = b_two
        print(f"fused batched R={R}: {b_ms:.4f} ms, bound {b_bound:.4f} ms "
              f"({b_by}; {act} workers active in some realization); plain "
              f"{b_plain:.4f} ms; library {b_lib:.4f} ms (einsum oracle a "
              f"realization); cuBLAS's two products (S X W^T, then "
              f"(S X)^T (C * resid)) {b_two:.4f} ms, to the kernel rel "
              f"{b_rel:.2e}  [{smi}]")

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
            # the card's own time a call by CUDA graph replay, the kernel
            # and torch.matmul(c, g) in turns (kernel, library, library,
            # kernel), so neither gains from the card's state
            gk, gl = [graph_ms(lambda: coded_combine_call(g, c))], []
            gl += [graph_ms(lambda: torch.matmul(c, g)) for _ in range(2)]
            gk.append(graph_ms(lambda: coded_combine_call(g, c)))
            co["graph_ms"], co["library_graph_ms"] = (sorted(gk)[0],
                                                      sorted(gl)[0])
            verdict = ("faster" if co["graph_ms"] < co["library_graph_ms"]
                       else "not faster")
            print(f"coded_combine (32, {cp}) device time a call (CUDA graph "
                  f"replay, kernel, library, library, kernel): kernel "
                  f"{gk[0]:.5f} / {gk[1]:.5f} ms, torch.matmul(c, g) "
                  f"{gl[0]:.5f} / {gl[1]:.5f} ms: the kernel is {verdict} "
                  f"on the card's own time  [{smi}]")
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
        # "plan" is the Hadamard kernels' route among their own forms;
        # "route" in the line below is the contract's: cuda or triton
        route = f"; {row['plan']}" if "plan" in row else ""
        print(f"time {kname}: {row['ms']:.4f} ms; bound {row['bound_ms']:.4f}"
              f" ms ({row['bound_by']}); plain {row['plain_ms']:.4f} ms; "
              f"library {row['library_ms']:.4f} ms{route}  [{smi}]")
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
