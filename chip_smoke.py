#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``--phase sharded`` runs the device probe, the build and the sharded
phase alone: on a host with several cards, the split over all of them;
``--phase serve`` the device probe and the serve phase alone; ``--phase
train`` the device probe, the build and the train and launch phases;
``--phase ranks`` the device probe and the launch phase's check (5),
the partitioned train step over every card, alone.)

Phases, each of which ends the run with a non-zero exit on failure:

1. device  - probe CUDA (exit 2 without a card), print the card's name and
             power limit;
2. build   - compile the CUDA kernels from src/repro_torch/kernels/csrc
             in a thread, while the serve phase (which launches no kernel
             of the port) runs on the card in a whole run: the build's
             host seconds (``kernels._build.build_seconds``) off the
             run's clock;
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
             realization and one realization all-masked, and with one-hot
             masks (an async update) at the async problem's (32, 128,
             6000): R = 1, R = 4 with four workers and with one worker four
             times, rows == single calls bit for bit, its device time a
             call (CUDA graph replay) beside the REPRO_FUSED=0 form's
             gather and two products; coded combine at
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
             and ``run_batched(trials=2)``, one coded-bcd run (60 steps) on
             the lifted (feature-encoded) problem and the async baseline
             (320 updates): ``run``, ``run_batched(trials=4,
             eval_every=10)``, whose realization 0 equals ``run`` bit for
             bit, and ``run`` again under REPRO_FUSED=0 (traces to rel
             1e-4).  Every runner captures its loop into a CUDA graph and
             replays it block by block (``runtime.runners``).
             Launch counts are cleared just before each of these paths and
             read just after, and each path must launch exactly its own
             kernels (one fused launch a GD / ISTA step and an async
             update, none under REPRO_FUSED=0, one combine an L-BFGS
             step); the objectives must be finite and fall, and the
             card's coded-gd trace and the first 20 steps of its coded-lbfgs
             trace must match the port's own CPU run on the same encoded
             problem and masks;
   graph   - the step loops captured against the same runs uncaptured
             (``runners._run`` / ``_scan_bcd`` / ``_batched_bcd`` with
             ``capture=False``; ``_batched_async``) at PAPER_RIDGE:
             coded-gd R = 1 (100 steps, and its schedule five times over,
             500), R = 4 with eval_every 10, coded-prox (50), GD under
             hold-mode ``degrade`` (every third step short of k),
             coded-bcd single and batched (R = 4, eval_every 5; 60
             steps), async R = 1 on the strategy's 320 updates and on
             3200, R = 4 with eval_every 10, and staleness 0 with a ring
             of 1 (one fused launch an update required): iterates and
             traces bit for bit, equal launch counts, one capture a
             captured run and none uncaptured; the capture's host time; a
             step's time of each (CUDA events, in turns, every sample) and
             the device's idle share of each (profiler); coded-gd R = 1's
             captured step at blocks of 5, 10 (the runners' length) and
             20 steps, and async R = 1's captured update at blocks of 10,
             20 and 40 updates, in turns;
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
             equal bit for bit; the eager step's profiler breakdown
             (workers' forward and backward, flatten, combine, AdamW, idle
             share); (4) ``CodedTrainer.run`` with its step captured once
             into a CUDA graph (``train.stepper.Stepper``: step 0 the
             warm-up, step 1 the capture, a replay a step from it) against
             the same run under ``graphs.capturing(False)``, from the same
             parameters, at ``100m`` (30 steps), deepseek-7b at its
             published width with one layer of 30 (bfloat16, 621 817 856
             parameters, 4 steps) and xlstm-350m whole (24 layers, 393 M
             parameters, 3 steps: the sLSTM and mLSTM loops' forward and
             backward recorded inside the graph): parameters, AdamW m, v
             and count, every loss and grad_norm bit for bit, one combine
             launch a step, the combine's shape checked at the warm-up and
             the capture, one capture, its host seconds and graph pool,
             the reserved peak; the step captured and eager in turns (CUDA
             events, five samples each; at deepseek-7b the graph's pool is
             freed before each eager step and recaptured after it: the two
             do not fit the card together) and the idle share and the
             combine's device time of one profiled replay; (5) ``experiments.run
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
             and the rate it reached; 40 ISTA steps at the path's shape
             captured (block 1 of 10 steps captured and replayed, the
             cluster launches inside the graph) equal to the same steps
             uncaptured bit for bit, with equal launches;
   serve   - (run beside the build, before the kernels phase) the model
             zoo's serve path (``repro_torch.models``' prefill,
             decode_step and ``Decoder``, ``repro_torch.serve``), which
             runs no kernel of the port: the launch counters are cleared
             before the phase and must read 0 after it.  (1) every
             architecture at its smoke variant: prefill (batch 2, 64
             tokens, cache 72) and 8 teacher-forced decode steps on the
             card and on the CPU from the same port-initialized float32
             parameters (TF32 off), logits to rel 1e-4 of the largest
             |logit|, cache trees of equal structure and shapes; (2)
             gemma2-27b at its published width (arXiv:2408.00118) with one
             period of 2 layers of 46 (the local layer, window 4096, and
             the global one; a ``reduced:`` line), 2 312 151 552
             parameters in bfloat16: batch 4, prompt 8192 (the local ring
             keeps the last 4096 keys), 32 greedy tokens through
             ``models.Decoder`` (the decode step captured once into a CUDA
             graph with its position in a device buffer, a replay a token;
             the local ring's KV chunk loop recorded inline) held bit for
             bit (tokens, last logits, every cache leaf) to the eager
             ``decode_step`` loop from the same prefill; prefill ms and
             decode ms a token captured and eager in turns (CUDA events,
             five samples each, every sample), tokens/s, the capture's host
             seconds and the decoder's graph pool, peak device memory,
             profiler breakdowns with the idle share of one captured and
             one eager decode step; the prefill with its KV chunk loop
             captured (``graphs.scan``: a graph for the local layer and one
             for the global, equal shapes but other masks) against the
             same blocks eager, bit for bit, timed in turns, each graph's
             pool, the loop's share and the prefill's profiler breakdown;
             then in float32 at batch 1 prefill's last logits and the
             first decode step's against ``forward`` over 8193 tokens,
             within 1e-3 of the largest |logit|; (3) phi3.5-moe-42b-a6.6b
             at its published width (hf:microsoft/Phi-3.5-MoE-instruct),
             1 layer of 32, 1 431 646 208 parameters in bfloat16, batch 2,
             prompt 4096, 16 decode steps, the same decoder checks and
             times and the assignments the prefill drops for capacity;
             (4) xlstm-350m whole (arXiv:2405.04517), 393 131 104
             parameters, batch 2, prompt 1024, 16 decode steps, the same
             decoder checks and times; its sLSTM
             token loop and mLSTM chunk loop run as blocks captured once
             a block shape into CUDA graphs (``repro_torch.graphs.scan``)
             and replayed: the captures printed (one a loop shape across
             the layers and the calls), the prefill captured equal to the
             same blocks run eagerly (``graphs.capturing(False)``) bit for
             bit in the logits and every cache leaf, both timed in turns
             (CUDA events, medians of five, every sample), the loops'
             share of a captured prefill (CUDA events around each scan),
             its profiler breakdown and idle share, and the captured
             prefill with sLSTM blocks of 16, 32, 64 and 128 tokens;
             (5) jamba-1.5-large-398b at its published width
             (arXiv:2403.19887), depth cut to the first three blocks of
             its period (attention, Mamba with MoE, Mamba dense; a
             ``reduced:`` line), 12 400 353 280 parameters in bfloat16,
             batch 1, prompt 8192, 16 decode steps: the decoder checks and
             times of (2), the capacity drops, then (4)'s
             captured-against-eager checks and times for its Mamba chunk
             loop and its attention's KV chunk loop (no float32 consistency
             check: 49.6 GB of float32 parameters and 64 heads' 17 GB of
             float32 scores over 8193 tokens do not fit one card);
             ``graphs.clear()`` between the models, so
             one model's graph pools do not count in the next one's peak
             memory; (6) ``python -m repro_torch.serve --arch
             gemma2-27b`` through ``main(argv)`` on the card,
             in-process, its decode loop a ``Decoder`` (one capture); the
             phase's host seconds;
   launch  - the launchers (``repro_torch.launch``, ``repro_torch.sharding``),
             each entry driven with the launch counts cleared just before
             and read just after: (1) ``python -m repro_torch.launch.train
             --arch deepseek-7b --smoke --steps 10`` through ``main(argv)``,
             in-process, on the card (one combine launch a coded step) and
             with ``--device cpu`` (none), losses to rel 1e-4 and simulated
             times bit for bit; (2) the CLI's body (``launch.train.train``)
             at deepseek-7b's published width with one layer of 30 (a
             ``reduced:`` line; 621 817 856 parameters, bfloat16), its
             default flags, 6 steps: the step time by CUDA events between
             steps 3-6, the replays (median and every sample; the warm-up
             step and the capture step printed apart), the combine's
             device time inside step 6 from the profiler by kernel name and
             its share of the step, the reserved peak, finite losses, one
             combine launch a step and its shape (8, 621 817 856) at the
             warm-up and the capture; (3)
             ``grad_specs`` from ``make_shardings`` on a one-card
             ``make_local_mesh()`` (NCCL), the parameters and moments
             placed as ``DTensor`` shards (``place_train_state``): one
             ``build_train_step`` step with it writes into them and,
             gathered, equals bit for bit the step without it
             (parameters, optimizer state, loss); (3b) the dry run's
             live-bytes tracker (``roofline.LiveBytes``) over the same
             step again, its peak within 15 % of
             ``torch.cuda.max_memory_allocated()`` above what was
             allocated at the step's start; (5) with two cards or more,
             the partitioned step over every card (``ranks_check``: one
             process a card, NCCL, deepseek-7b's published width with 1
             layer, 3 steps, the ranks of a model group on one batch) on
             the (data, model) meshes (n, 1) in float32 and bfloat16,
             (1, n) and (2, n / 2) in float32, (1, n) in bfloat16 and
             at (1, n) in float32 phi3.5-moe (1 layer), jamba-1.5-large
             (its dense Mamba block) and xlstm-350m (one period: mLSTM,
             sLSTM), against the
             one-rank step on the data groups' batches together and a
             witness, the one-rank step on the same rows in the reverse
             order (on a model axis on the model mirrored too: heads, ff,
             vocabulary, experts and Mamba channels reversed):
             ``grad_norm`` every step, the moments every step and
             the parameters after step 3 within 10 times the witness's
             distance plus the dtype's eps (to each leaf's largest
             entry), at (n, 1) in float32 also ``grad_norm`` and step
             1's moments to rel 1e-5, the last update AdamW's of the
             gathered moments bit for bit, each rank's parameters and
             moments 1/n of the one-rank's bytes within 1 % (at (1, n)
             within 0.001 of 1/n), held bytes, peak allocated and step
             times (CUDA events) a rank printed per mesh, each rank's
             progress logged before every collective; then
             gemma2-27b (2 layers, batch 4), jamba-1.5-large (attention
             and the dense Mamba block, batch 1) and xlstm-350m (whole,
             batch 2), prompt 1024, 8 eager decode steps, each
             served over (1, n) against the one-card eager path,
             in float32 every logit within 1e-3 of max|logit|, in
             bfloat16 within 10 times the one-card path's own distance
             from its float32 run; on one card it
             prints that it needs two; (4) ``python -m
             repro_torch.launch.dryrun`` in three processes started
             together (deepseek-7b train_4k on both
             meshes, phi3.5-moe decode_32k, jamba-1.5-large long_500k),
             each record's roofline terms, argument, output, temp and
             alias bytes a device (all numbers) and host seconds; any
             failed combination fails the phase;
   sharded - the realization axis over cards: ``torch.cuda.device_count()``
             printed; at PAPER_RIDGE's width with R = 8, coded-gd (100
             steps), coded-prox (50) and async (320 updates) through
             ``run_batched`` with
             ``placement="sharded"`` and ``"vmap"``, ``placement_devices``
             the card count where it divides R (1 on one card) and w,
             traces and times bit for bit equal; then
             ``runners._sharded_run`` over two shards of card 0 (and over
             every card where there are more than one), w and traces bit
             for bit equal to the batched run, one fused launch a step on
             each shard, each shard capturing its own graph; a step's time
             of the shards (a replay a shard every block, one host thread)
             beside the batched run's, each captured and uncaptured, in
             turns; the same for async on the uncoded problem (320
             updates, one fused launch an update on each shard);
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
             times (CUDA events around a 100-step GD loop and the 60-step
             BCD loop, both captured as users run them, a 50-step L-BFGS
             loop and the 320-update async loop, captured, five
             repetitions after a
             warm-up, every sample printed) and encode times (host clock,
             three repetitions); the profiler's breakdown of each run;
             peak device memory.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
                "async": {fused: 40 * 16}}     # an update: steps x m

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
    on_device = lambda a, dev: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dev)
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
            p, o, met = tr._step(p, o, *(on_device(a, tr.device) for a in
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
    batch = [on_device(a, card.device) for a in card.batcher.next_batch()]

    def both_masks():
        outs = []
        for mask in ([1, 1, 1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 1, 1, 1, 1]):
            d = card.code.decode_weights(np.asarray(mask, np.float64))
            outs.append(card._step(params, opt, *batch, on_device(
                np.asarray(d, np.float32), card.device)))
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

    # the eager step's profiler breakdown (the functional step: each call
    # starts from the same parameters); its time comes from (4)
    d = on_device(np.asarray(card.code.decode_weights(
        np.asarray(masks[0])), np.float32), card.device)
    step_fn = lambda: card._step(params, opt, *batch, d)  # noqa: E731
    del host
    torch.cuda.empty_cache()

    # (4) the trainer's captured step against the same run eager: 100m (30
    # steps), deepseek-7b at its published width with one layer of 30 (4
    # steps; the captured and the eager step do not fit the card together,
    # so its turns free the graph's pool before each eager step) and
    # xlstm-350m whole (3 steps: the sLSTM and mLSTM loops' forward and
    # backward inside the graph)
    ab = train_ab("100m", cfg, steps, smi, drive)
    train_breakdown(step_fn, smi, ab["eager_ms"])
    del params, opt, card, step_fn, batch
    torch.cuda.empty_cache()
    cfg7 = get_config("deepseek-7b").with_overrides(n_layers=1)
    p7 = int(count_params(cfg7))
    require(p7 == 621_817_856, f"deepseek-7b 1 layer has {p7} parameters")
    print(f"reduced: n_layers {get_config('deepseek-7b').n_layers} -> 1 "
          f"(deepseek-7b: d_model {cfg7.d_model}, {cfg7.n_heads} heads, "
          f"d_ff {cfg7.d_ff}, vocab {cfg7.vocab}, {cfg7.param_dtype}; "
          f"P_total {p7})")
    train_ab("deepseek-7b 1 layer", cfg7, 4, smi, drive, release=True)
    cfgx = get_config("xlstm-350m")
    px = int(count_params(cfgx))
    print(f"xlstm-350m whole ({cfgx.source}: {cfgx.n_layers} layers, "
          f"d_model {cfgx.d_model}, vocab {cfgx.vocab}, "
          f"{cfgx.param_dtype}; P_total {px})")
    train_ab("xlstm-350m", cfgx, 3, smi, drive)

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


def train_ab(label: str, cfg, steps: int, smi: str, drive, *,
             release: bool = False) -> dict:
    """``CodedTrainer.run`` over ``steps`` steps with the step captured (a
    ``train.stepper.Stepper``: step 0 the warm-up, step 1 the capture, a
    replay a step from it) against the same run under
    ``graphs.capturing(False)``, from the same parameters (m 8, k 6, FRC
    beta 2, seq 128): parameters, AdamW m, v and count, every loss and
    grad_norm bit for bit, one combine launch a step each, the combine's
    shape checked in the Python wrapper (the eager run's every step, the
    captured run's warm-up and capture; a replay runs no Python); one
    capture, its host seconds and graph pool, the reserved peak.  Then the
    step time of one stepper, captured and eager in turns (CUDA events
    around a step, five samples each); with ``release`` every eager turn
    follows ``graphs.clear()`` (the graph's pool and an eager step's
    temporaries do not fit the card together) and every captured turn
    follows an untimed recapture.  Last, one profiled captured step: the
    device's busy and idle share and the combine's device time, by kernel
    name.  Returns the medians."""
    import numpy as np
    import torch
    import repro_torch.train.coded as coded
    from repro_torch import graphs
    from repro_torch.core import bimodal_delays
    from repro_torch.models import count_params
    from repro_torch.runtime import ClusterEngine, FastestK
    from repro_torch.train import CodedTrainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    m, k, comb = 8, 6, "coded_combine"
    P = int(count_params(cfg))
    tcfg = TrainerConfig(m_workers=m, beta=2, wait_k=k, seq_len=128,
                         steps=steps, lr=3e-3, warmup=min(6, steps), seed=0,
                         log_every=0, code="frc")

    def trainer():
        return CodedTrainer(cfg, tcfg, ClusterEngine(bimodal_delays(), m,
                                                     seed=0),
                            policy=FastestK(k))

    shapes: list = []
    plain_call = coded.coded_combine_call

    def watch(g, c):
        shapes.append(tuple(g.shape))
        return plain_call(g, c)

    def run(tr, params, opt, mode):
        shapes.clear()
        coded.coded_combine_call = watch
        t0 = time.perf_counter()
        try:
            with (graphs.capturing(False) if mode == "eager"
                  else contextlib.nullcontext()):
                out = drive(f"train {label} {mode}",
                            lambda: tr.run(params, opt), {comb: steps})
        finally:
            coded.coded_combine_call = plain_call
        want = steps if mode == "eager" else 2
        require(shapes == [(m, P)] * want,
                f"train {label} {mode}: combines at {shapes}")
        return out, time.perf_counter() - t0

    t_ab = time.perf_counter()
    graphs.clear()
    tr = trainer()
    params, opt = tr.init_state()
    (pe, oe, he), eager_s = run(tr, params, opt, "eager")
    require(tr.stepper.captures == 0, f"train {label}: the eager run "
                                      f"captured")
    want = [t.cpu() for t in tree_leaves((pe, oe))]
    del tr, pe, oe
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = trainer()
    (pc, oc, hc), captured_s = run(tr, params, opt, "captured")
    peak = torch.cuda.max_memory_reserved() / 1e9
    alloc = torch.cuda.max_memory_allocated() / 1e9
    st = tr.stepper
    got = tree_leaves((pc, oc))
    same = len(got) == len(want) and all(
        torch.equal(a.cpu(), b) for a, b in zip(got, want))
    key = lambda h: [(r["loss"], r["grad_norm"]) for r in h]  # noqa: E731
    losses = [r["loss"] for r in hc]
    require(np.isfinite(losses).all(), f"train {label}: non-finite loss")
    require(same and key(hc) == key(he), f"train {label}: captured != "
            f"eager (state equal {same}; losses {losses} vs "
            f"{[r['loss'] for r in he]})")
    require(st.captures == 1 and int(oc.count) == steps,
            f"train {label}: {st.captures} captures, count {int(oc.count)}")
    print(f"train {label} (P_total {P}, m {m}, k {k}, FRC beta 2, seq 128, "
          f"{steps} steps): captured == eager (graphs.capturing(False)) bit "
          f"for bit in parameters, AdamW m, v and count, every loss and "
          f"grad_norm; losses {[round(x, 4) for x in losses]}; {steps} "
          f"combine launches each at ({m}, {P}); one capture, "
          f"{st.capture_s:.3f} s of host time, graph pool "
          f"{st.pool_bytes / 1e9:.3f} GB; captured run's reserved peak "
          f"{peak:.2f} GB (allocated {alloc:.2f}); host s a run captured "
          f"{captured_s:.2f}, eager {eager_s:.2f}  [{smi}]")
    del pc, oc, got, want, params, opt

    t_turns = time.perf_counter()
    toks, labels, coeff = tr.batcher.next_batch(tr.code.at_step(0))
    batch = (toks, labels, coeff, np.asarray(
        tr.code.decode_weights(np.ones(m)), np.float32))
    times: dict = {"captured": [], "eager": []}
    recaptures = 0
    for i in range(5):
        for mode in (("captured", "eager") if i % 2 == 0
                     else ("eager", "captured")):
            if release and mode == "eager":
                graphs.clear()
            if release and mode == "captured" and st._graph is None:
                st.step(*batch)
                recaptures += 1
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            with (graphs.capturing(False) if mode == "eager"
                  else contextlib.nullcontext()):
                a.record()
                st.step(*batch)
                b.record()
            torch.cuda.synchronize()
            times[mode].append(a.elapsed_time(b))
    med = {mode: sorted(v)[2] for mode, v in times.items()}
    print(f"train {label} step (CUDA events around a step, in turns"
          f"{'; the pool freed before each eager step, ' + str(recaptures) + ' recaptures' if release else ''}"
          f"): captured {spread(times['captured'], 'ms', 2)}; eager "
          f"{spread(times['eager'], 'ms', 2)}; eager / captured "
          f"{med['eager'] / med['captured']:.2f}x  [{smi}]")
    if st._graph is None:               # the last turn freed the pool
        st.step(*batch)
    t_prof = time.perf_counter()
    wall_us, rows = profile_device(lambda: st.step(*batch))
    busy = sum(r[0] for r in rows)
    comb_us = sum(us for us, _, name in rows if "combine_kernel" in name)
    if busy > 0:
        print(f"profile train {label} captured step (one replay): wall "
              f"{wall_us:.0f} us, device busy {busy:.0f} us (idle share "
              f"{max(0.0, 1 - busy / wall_us):.3f} of the profiled wall, "
              f"{max(0.0, 1 - busy / (med['captured'] * 1e3)):.3f} of the "
              f"{med['captured']:.2f} ms step); the combine {comb_us:.0f} "
              f"us ({comb_us / busy:.2%} of busy); {sum(r[1] for r in rows)}"
              f" kernels and copies  [{smi}]")
    else:
        print(f"profile train {label} captured step: the profiler recorded "
              f"no device time (idle share not measured)")
    print(f"train {label}: host s {t_turns - t_ab:.1f} the two runs, "
          f"{t_prof - t_turns:.1f} the turns, {time.perf_counter() - t_prof:.1f}"
          f" the profiled replay")
    del tr, st
    graphs.clear()
    return {"captured_ms": med["captured"], "eager_ms": med["eager"]}


def train_breakdown(step_fn, smi: str, step_ms: float) -> None:
    """Where one eager coded train step's device time goes (a replay of the
    captured step carries no ``coded:`` ranges): the combine kernel
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
        print("profile coded-sgd 100m eager step: the profiler recorded no "
              "device time (breakdown not measured)")
        return
    comb = sum(us for us, _, key in kernels if "combine_kernel" in key)
    flat, adamw = ranges.get("flatten", 0.0), ranges.get("adamw", 0.0)
    workers = busy - comb - flat - adamw
    span = spans.get("worker_grad", 0.0)
    fwd = ranges.get("worker_grad", 0.0)
    print(f"profile coded-sgd 100m eager step: wall {wall_us:.0f} us, "
          f"device busy "
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
    from repro_torch.kernels import _build
    from repro_torch.kernels.fwht import fwht_kernel_call, fwht_plain
    from repro_torch.kernels.ref import fused_masked_gradient_ref
    from repro_torch.runtime import (FastestK, ProblemSpec, get_strategy,
                                     runners, scan_prox)
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
    # 40 ISTA steps at the path's shape: block 1 (steps 10-19) captured,
    # the cluster launches inside the graph, and replayed; bit for bit the
    # same steps uncaptured, with the same launches
    masks40 = engine.sample_schedule(40, FastestK(k)).masks[None]
    w0 = torch.zeros((1, p), device=dev)
    got = {}
    for cap in (True, False):
        n0 = _build.captures
        t0 = time.perf_counter()
        label = "captured" if cap else "uncaptured"
        got[cap] = (drive(f"wide 40 ISTA steps {label}",
                          lambda: runners._run(prob, masks40, step, w0,
                                               kind="prox", h="l1",
                                               eval_every=1, degrade=None,
                                               capture=cap),
                          {fused: 40}),
                    _build.captures - n0, time.perf_counter() - t0)
    (wc, tc), nc, sc = got[True]
    (we, te), ne, se = got[False]
    require((nc, ne) == (1, 0), f"wide ISTA: {nc} / {ne} captures")
    require(torch.equal(wc, we) and torch.equal(tc, te),
            "wide ISTA: the captured block != the uncaptured steps")
    print(f"graph wide ISTA ({m}, {r}, {p}), 40 steps, "
          f"{route_of('fused', p=p, itemsize=4)}: captured == uncaptured "
          f"bit for bit (iterate and trace), 40 fused launches each; host "
          f"clock {sc:.3f} s captured, {se:.3f} s uncaptured  [{smi}]")
    del wc, tc, we, te
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
                   dev, count_drops: bool = False, host=None) -> dict:
    """One architecture served on the card at ``cfg``'s width through the
    port's entry points (``init_params``, ``prefill``, ``models.Decoder``):
    parameters from seed 0, a batch of B random prompts of S tokens, a
    greedy continuation of ``new`` tokens through the decoder (the step
    captured once into a CUDA graph, a replay a token: the result), held
    bit for bit (tokens, last logits, every cache leaf) to the eager
    ``decode_step`` loop from the same prefill; then the times: prefill ms
    (CUDA events; five samples after the warm-up, every sample printed),
    decode ms a token captured and eager in turns (medians of five, every
    sample), tokens/s, the capture's host seconds, the decoder's graph
    pool, the profiler breakdown and idle share of one captured and one
    eager step, and peak device memory (this model's own: what was
    allocated before its parameters is not counted).  With
    ``count_drops`` the MoE layers' capacity drops in the prefill are
    counted in one more, untimed prefill, which must reach every MoE
    layer.  ``host``: a future of ``init_params(cfg, 0, device="cpu")``
    drawn in a thread while earlier models ran (the same parameters, moved
    to the card).  Returns the parameters, the prompts, the greedy tokens
    and the prefill as a function."""
    import numpy as np
    import torch
    from repro_torch.models import (Decoder, count_params, decode_step,
                                    init_params)
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import prefill
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if host is None:
        params = init_params(cfg, 0, device=dev)
    else:
        params = tree_map(lambda t: t.to(dev), host.result())
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                              dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()

    def pre():
        return prefill(params, cfg, prompts, cache_len=S + new)

    def greedy(tok, caches):
        """The eager loop: ``decode_step`` with Python-int positions."""
        out = []
        for i in range(new):
            lg, caches = decode_step(params, cfg, tok, caches, S + i)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).int(), lg

    with torch.no_grad():
        t0 = time.perf_counter()
        lg0, caches = pre()
        tok0 = torch.argmax(lg0[:, -1], dim=-1)[:, None].int()
        dec = Decoder(params, cfg, B, S + new)
        dec.load(caches, S)
        got = dec.generate(new, token=tok0)      # warm-up, capture, replays
        t_first = time.perf_counter() - t0
        toks = torch.cat([tok0, got], dim=1)
        want, lg_last = greedy(tok0, caches)     # in place, from the prefill
        a, b = tree_leaves(dec.caches), tree_leaves(caches)
        require(torch.equal(got, want) and torch.equal(dec.logits, lg_last)
                and len(a) == len(b)
                and all(torch.equal(x, y) for x, y in zip(a, b)),
                f"{label}: the captured decoder differs from the eager "
                f"decode_step loop")
        require(dec.captures == 1, f"{label}: {dec.captures} decode "
                                   f"captures, expected 1")
        require(bool(torch.isfinite(lg0).all()) and
                bool(torch.isfinite(lg_last).all()),
                f"{label}: non-finite logits")
        n_leaves = len(a)
        del a, b
        pre_ms = samples_ms(pre, 5, warmup=0)
        dec_ms = {"captured": [], "eager": []}
        for mode in ["captured", "eager", "eager", "captured"] * 2 + [
                "captured", "eager"]:
            if mode == "captured":
                dec.load(caches, S)
                fn = functools.partial(dec.generate, new, token=tok0)
            else:
                fn = functools.partial(greedy, tok0, caches)
            dec_ms[mode] += [t / new for t in samples_ms(fn, 1, warmup=0)]
        require(dec.captures == 1, f"{label}: new decode captures while "
                                   f"timing")
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
    peak_reserved = torch.cuda.max_memory_reserved() - base_reserved
    med = {k: sorted(v)[2] for k, v in dec_ms.items()}
    n_params = int(count_params(cfg))
    print(f"serve {label}: {n_params} parameters ({cfg.param_dtype}), "
          f"batch {B}, prompt {S}, {new} greedy tokens; init {t_init:.1f} s"
          f"{' (drawn on the host in a thread meanwhile; the wait and the copy)' if host is not None else ''},"
          f" first prefill + decode {t_first:.2f} s host clock  [{smi}]")
    print(f"serve {label} prefill {B}x{S}: {spread(pre_ms, 'ms')}  [{smi}]")
    print(f"serve {label} decode a token (batch {B}), captured (the "
          f"decoder): {spread(dec_ms['captured'], 'ms')}; eager "
          f"(decode_step): {spread(dec_ms['eager'], 'ms')}; eager / captured"
          f" {med['eager'] / med['captured']:.2f}; "
          f"{B * 1e3 / med['captured']:.1f} tokens/s captured; peak device "
          f"memory {(peak + base - before) / 1e9:.2f} GB ({peak / 1e9:.2f} GB"
          f" above the parameters; reserved, graph pools included, "
          f"{peak_reserved / 1e9:.2f} GB above)  [{smi}]")
    print(f"serve {label} decoder: captured == eager bit for bit ({new} "
          f"greedy tokens, the last logits, {n_leaves} cache leaves); 1 "
          f"capture, {dec.capture_s:.3f} s host clock; graph pool "
          f"{dec.pool_bytes / 1e9:.3f} GB  [{smi}]")
    with torch.no_grad():
        steps = {
            "captured": (med["captured"], dec.step),
            "eager": (med["eager"], lambda: decode_step(
                params, cfg, toks[:, :1], caches, S))}
        for mode, (ms, fn) in steps.items():
            rows = device_breakdown(fn, f"{label} decode step {mode} "
                                        f"(batch {B})")
            busy = sum(r[0] for r in rows) / 1e3
            print(f"serve {label} decode step {mode}: device busy "
                  f"{busy:.4f} ms of {ms:.4f} ms a token by events (idle "
                  f"share {max(0.0, 1 - busy / ms):.2f}; the profiler's "
                  f"wall above holds its own host work)  [{smi}]")
    dec.release()
    del dec
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


def scan_events(fn) -> tuple[float, dict]:
    """(ms of one call of ``fn``, {loop name: ms inside its
    ``graphs.scan`` calls}) by CUDA events around the call and around each
    scan in it: the recurrences' share of a prefill."""
    import torch
    from repro_torch import graphs
    inner, marks = graphs.scan, []

    def timed_scan(name, *args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(name, *args, **kwargs)
        b.record()
        marks.append((name, a, b))
        return out
    graphs.scan = timed_scan
    try:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
    finally:
        graphs.scan = inner
    by: dict[str, float] = {}
    for name, x, y in marks:
        by[name] = by.get(name, 0.0) + x.elapsed_time(y)
    return a.elapsed_time(b), by


def scan_ab(label: str, g: dict, loops: list, smi: str) -> None:
    """``serve_at_width``'s prefill with its loops (the model zoo's
    recurrences, the attention's KV chunk loop) captured (``graphs.scan``,
    as users run it) against the same blocks run eagerly
    (``graphs.capturing(False)``): the captures (one a loop shape and its
    constants, across the layers and every call so far; ``loops`` lists
    their names) with each graph's memory pool, logits and every cache
    leaf bit for bit, the prefill's time both ways in turns (medians of
    five, every sample), the loops' share of a captured prefill and its
    profiler breakdown with the device's idle share."""
    import torch
    from repro_torch import graphs
    from repro_torch.tree import tree_leaves
    pre = g["prefill"]
    keys = graphs.cached()
    names = sorted(k[0] for k in keys)
    require(names == sorted(loops), f"{label}: captured block shapes "
            f"{names}, expected {sorted(loops)}")
    pools = graphs.pool_bytes()
    print(f"serve {label}: captures {len(keys)} (one a loop shape and its "
          f"constants, every layer and call so far): " + "; ".join(
              f"{k[0]} block of {k[2]} ({len(k[3])} consts, inputs "
              f"{[list(s) for s, _ in k[4]]}, static {k[-1]}; graph pool "
              f"{pools[k] / 1e9:.3f} GB)" for k in keys) + f"  [{smi}]")
    with torch.no_grad():
        lc, cc = pre()
        with graphs.capturing(False):
            le, ce = pre()
        a, b = tree_leaves(cc), tree_leaves(ce)
        same = torch.equal(lc, le) and len(a) == len(b) and all(
            torch.equal(x, y) for x, y in zip(a, b))
        require(same, f"{label}: captured prefill differs from the eager "
                      f"blocks")
        n_leaves = len(a)
        del lc, cc, le, ce, a, b
        t = {"captured": [], "eager": []}
        for mode in ["captured", "eager", "eager", "captured"] * 2 + [
                "captured", "eager"]:
            with (contextlib.nullcontext() if mode == "captured"
                  else graphs.capturing(False)):
                t[mode] += samples_ms(pre, 1, warmup=0)
        total, by = scan_events(pre)
    require(graphs.cached() == keys, f"{label}: new captures while timing")
    med = {k: sorted(v)[2] for k, v in t.items()}
    print(f"serve {label} prefill captured == eager bit for bit (logits and "
          f"{len(tree_leaves(g['prefill']()[1]))} cache leaves); captured "
          f"{spread(t['captured'], 'ms')}; eager {spread(t['eager'], 'ms')};"
          f" eager / captured {med['eager'] / med['captured']:.2f}  [{smi}]")
    print(f"serve {label} captured prefill {total:.2f} ms, inside the loops "
          + ", ".join(f"{k} {v:.2f} ms ({v / total:.2f})"
                      for k, v in sorted(by.items())) + f"  [{smi}]")
    with torch.no_grad():
        device_breakdown(pre, f"{label} prefill captured")


def slstm_block_sweep(pre, smi: str) -> None:
    """xlstm-350m's captured prefill with the sLSTM loop in blocks of 16,
    32, 64 and 128 tokens (``models.xlstm._SLSTM_BLOCK``), two warm-up
    calls each (the capture), then three samples each in turns."""
    import torch
    from repro_torch.models import xlstm as xl
    kept = xl._SLSTM_BLOCK
    times = {c: [] for c in (16, 32, 64, 128)}
    try:
        with torch.no_grad():
            for c in times:
                xl._SLSTM_BLOCK = c
                pre()
                pre()
            for _ in range(3):
                for c in times:
                    xl._SLSTM_BLOCK = c
                    times[c] += samples_ms(pre, 1, warmup=0)
    finally:
        xl._SLSTM_BLOCK = kept
    best = min(times, key=lambda c: sorted(times[c])[1])
    print("serve xlstm-350m prefill by sLSTM block (tokens a replay): "
          + "; ".join(f"{c}: {spread(v, 'ms')}" for c, v in times.items())
          + f"; fastest {best}, the port keeps {kept}  [{smi}]")


def serve_phase(smi: str) -> None:
    """The model zoo's serve path on the card (module docstring, phase
    "serve"): no kernel of the port runs here, and the launch counters,
    cleared at the start, must read zero at the end."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _build.launches.clear()
    # jamba-1.5-large's 12.4 B parameters take about two minutes to draw on
    # the host (init_params draws every leaf there): a thread draws them
    # while the other models run
    jcfg = ARCHS["jamba-1.5-large-398b"]
    jcfg = jcfg.with_overrides(n_layers=3, period=jcfg.period[:3])
    drawer = ThreadPoolExecutor(1)
    jamba_host = drawer.submit(init_params, jcfg, 0, device="cpu")
    try:
        _serve_models(smi, jcfg, jamba_host)
    finally:
        jamba_host.cancel()
        drawer.shutdown(wait=True)
    del jamba_host
    require(not {k: v for k, v in _build.launches.items() if v},
            "serve phase launched kernels of the port")
    print(f"serve phase: {time.perf_counter() - t_phase:.1f} s host clock; "
          f"no kernel of the port launched (counters read 0)  [{smi}]")


def _serve_models(smi: str, jcfg, jamba_host) -> None:
    """The serve phase's models (``serve_phase``); ``jamba_host`` is the
    future of jamba-1.5-large's parameters on the host."""
    import numpy as np
    import torch
    from repro_torch import graphs
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build
    from repro_torch.models import (count_params, decode_step, init_params,
                                    prefill)
    from repro_torch.models import xlstm as xl
    from repro_torch.serve import main as serve_main
    from repro_torch.serve import serve_inputs
    from repro_torch.tree import tree_leaves, tree_map

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
    graphs.clear()          # the smoke variants' loop graphs

    # (2) gemma2-27b at its published width, depth cut to one period
    gcfg = ARCHS["gemma2-27b"].with_overrides(n_layers=2)
    n_g = int(count_params(gcfg))
    require(n_g == 2312151552, f"gemma2-27b 2 layers: {n_g} parameters")
    print(f"reduced: gemma2-27b (arXiv:2408.00118) layers 46 -> 2 (one "
          f"period: the local layer, window 4096, and the global one); kept: "
          f"d_model 4608, 32 heads (16 KV) of 128, d_ff 36864, vocab 256000, "
          f"soft-caps 50 / 30, bfloat16; {n_g} parameters")
    g = serve_at_width("gemma2-27b", gcfg, 4, 8192, 32, smi, dev)
    # the KV chunk loop: the local and the global layer's prefill graphs
    # (equal shapes, other masks) and the local ring's at decode (the
    # eager decode_step loop; inside the decoder's graph it runs inline)
    scan_ab("gemma2-27b", g, ["attention"] * 3, smi)
    graphs.clear()
    # the consistency check in float32 at B = 1 on the same width and depth
    serve_consistency(g, gcfg, 8192)
    graphs.clear()
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
    graphs.clear()
    xcfg = ARCHS["xlstm-350m"]
    n_x = int(count_params(xcfg))
    require(n_x == 393131104, f"xlstm-350m: {n_x} parameters")
    print(f"xlstm-350m (arXiv:2405.04517) whole: 24 layers (12 mLSTM, 12 "
          f"sLSTM), d_model 1024, bfloat16, {n_x} parameters; the sLSTM "
          f"token loop (blocks of {xl._SLSTM_BLOCK} tokens) and the mLSTM "
          f"chunk loop (a chunk of {xcfg.mamba_chunk} a block) captured "
          f"once a block shape into CUDA graphs and replayed")
    g = serve_at_width("xlstm-350m", xcfg, 2, 1024, 16, smi, dev)
    scan_ab("xlstm-350m", g, ["mlstm", "slstm"], smi)
    slstm_block_sweep(g["prefill"], smi)
    del g
    graphs.clear()

    # (5) jamba-1.5-large at its published width, depth cut to the first
    # three blocks of its period
    n_j = int(count_params(jcfg))
    require(n_j == 12400353280, f"jamba-1.5-large 3 layers: {n_j} "
                                f"parameters")
    print(f"reduced: jamba-1.5-large-398b (arXiv:2403.19887) layers 72 -> 3 "
          f"(the first three blocks of its period of 8: attention, Mamba "
          f"with MoE, Mamba dense); kept: d_model 8192, 64 heads (8 KV), "
          f"d_ff 24576, 16 experts top-2, Mamba d_state 16, expand 2, chunk "
          f"{jcfg.mamba_chunk}, vocab 65536, bfloat16; {n_j} parameters")
    g = serve_at_width("jamba-1.5-large", jcfg, 1, 8192, 16, smi, dev,
                       count_drops=True, host=jamba_host)
    scan_ab("jamba-1.5-large", g, ["attention", "mamba"], smi)
    del g
    graphs.clear()

    # (6) the serve CLI, in-process, on the card: its decode loop is a
    # Decoder, one capture
    buf = io.StringIO()
    n_cap = _build.captures
    with contextlib.redirect_stdout(buf):
        rc = serve_main(["--arch", "gemma2-27b"])
    lines = buf.getvalue().splitlines()
    require(rc == 0 and len(lines) == 3 and lines[0].startswith("prefill:")
            and lines[1].startswith("decoded "),
            f"python -m repro_torch.serve: rc {rc}, output {lines}")
    require(_build.captures == n_cap + 1, f"python -m repro_torch.serve: "
            f"{_build.captures - n_cap} captures, expected the decoder's 1")
    graphs.clear()
    for line in lines:
        print(f"python -m repro_torch.serve --arch gemma2-27b: {line}")



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
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.train.coded as coded
    from repro_torch import graphs
    from repro_torch.configs import get_config
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import parser, train
    from repro_torch.models import count_params, init_params, param_axes
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.launch.roofline import LiveBytes, held_bytes
    from repro_torch.sharding import make_shardings
    from repro_torch.train.steps import (build_train_step, gather,
                                         place_train_state)
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
    # six steps: step 1 is the warm-up (eager), step 2 the capture, steps
    # 3-6 replays; step 6 runs under the profiler, which times the combine
    # inside the replay by kernel name (a replay runs no Python, and no
    # CUDA event can be recorded inside a capture)
    args = parser().parse_args(["--arch", "deepseek-7b", "--steps", "6"])
    shapes: list = []
    plain_call = coded.coded_combine_call

    def watch(g, c):
        shapes.append(tuple(g.shape))
        return plain_call(g, c)

    marks = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def tick(rec):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        if rec is not None and rec["step"] == 4:
            prof.start()
        elif rec is not None and rec["step"] == 5:
            prof.stop()

    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg7, 0)       # the trainer's own seeded draw
    coded.coded_combine_call = watch
    try:
        tick(None)
        _, _, hist = drive("launch.train body deepseek-7b 1 layer",
                           lambda: train(cfg7, args, params, callback=tick),
                           {comb: 6})
    finally:
        coded.coded_combine_call = plain_call
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved() / 1e9
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    comb_us = [(ev.self_device_time_total, ev.count)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and "combine_kernel" in ev.key]
    losses = [h["loss"] for h in hist]
    require(np.isfinite(losses).all(), "launch.train deepseek-7b 1 layer: "
                                       "non-finite loss")
    require(shapes == [(args.m_workers, p7)] * 2,
            f"launch.train deepseek-7b combines at {shapes}")
    timed_ms = sorted(step_ms[2:])[len(step_ms[2:]) // 2]
    if comb_us and comb_us[0][1] == 1:
        cms = comb_us[0][0] / 1e3
        comb_text = (f"the combine inside step 6 (profiler, by kernel name) "
                     f"{cms:.4f} ms, {cms / timed_ms:.2%} of the median step")
    else:
        comb_text = (f"the combine's device time not measured (profiler rows"
                     f" {comb_us})")
    print(f"launch.train body, deepseek-7b 1 layer (m {args.m_workers}, "
          f"k {args.wait_k}, beta {args.beta}, {args.rows_per_worker} rows a "
          f"group, seq {args.seq_len}, 6 steps): losses "
          f"{[round(x, 4) for x in losses]}; warm-up step "
          f"{step_ms[0]:.2f} ms, capture step {step_ms[1]:.2f} ms; steps "
          f"3-6, replays (CUDA events between steps; step 6 profiled) "
          f"{spread(step_ms[2:], 'ms', 2)}; {comb_text}; 6 combine launches,"
          f" the shape ({args.m_workers}, {p7}) checked at the warm-up and "
          f"the capture; reserved peak {peak:.2f} GB  [{smi}]")
    del hist, params
    graphs.clear()

    # (3) grad_specs on a one-card mesh: the partitioned step (parameters
    # and moments as DTensor shards, written in place) bit for bit the
    # step without it
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
        lp, lo = place_train_state(params, opt, sh)
        del params, opt
        laid = build_train_step(cfg7, lr, grad_specs=sh)
        b = laid(lp, lo, batch)
        require(b[0] is lp and b[1] is lo,
                "grad_specs: the step did not write into its shards")
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a[:2]), tree_leaves(gather(b[:2]))))
        require(same and torch.equal(a[2]["loss"], b[2]["loss"]),
                "grad_specs on a 1 x 1 mesh changed the step")
        print(f"grad_specs on a 1 x 1 mesh ({mesh.device_type}, "
              f"{dist.get_backend()}): deepseek-7b 1 layer, batch 2 x 128, "
              f"parameters and moments as DTensor shards written in place; "
              f"gathered, they, the count and the loss "
              f"({float(a[2]['loss']):.6f}) equal bit for bit the step "
              f"without it")
        del a, b
        # (3b) the dry run's live-bytes tracker over the same step on the
        # card, beside the allocator's peak above what is live at its start
        args = held_bytes(lp) + held_bytes(lo) + held_bytes(batch)
        arg_bytes = sum(n for _, n in args)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        live = LiveBytes(known=[t for t, _ in args])
        t0 = time.perf_counter()
        with live:
            out = laid(lp, lo, batch)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        alloc = torch.cuda.max_memory_allocated() - before
        ratio = live.peak / alloc
        print(f"live-bytes tracker (roofline.LiveBytes, what the dry run's "
              f"temp_bytes_per_device reads) over the same step on the card:"
              f" {live.peak} bytes; torch.cuda.max_memory_allocated() less "
              f"what was allocated at the step's start ({before} bytes: the "
              f"arguments' {arg_bytes} and {before - arg_bytes} else) "
              f"{alloc} bytes; ratio {ratio:.4f} (tol 0.85-1.15); the step "
              f"under the tracker {host_s:.2f} s host clock  [{smi}, one "
              f"card]")
        require(abs(ratio - 1.0) <= 0.15,
                f"live-bytes tracker {live.peak} vs allocator {alloc}")
        del out, lp, lo, live
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()

    # (5) the partitioned step over every card, one process a card
    ranks_check(smi)

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
            require(all(isinstance(v, int) for v in rec["memory"].values()),
                    f"dryrun {arch} {shape}: memory {rec['memory']}")
            rl = rec["roofline"]
            mem = rec["memory"]
            print(f"dryrun {arch} {shape} {rec['mesh']} ({rec['n_chips']} "
                  f"chips, {rec['kind']}): bytes a device: argument "
                  f"{mem['argument_bytes_per_device']}, output "
                  f"{mem['output_bytes_per_device']}, temp "
                  f"{mem['temp_bytes_per_device']}, alias "
                  f"{mem['alias_bytes_per_device']}; roofline "
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


def _rank_batch(cfg, group: int, step: int, device):
    """Data group ``group``'s batch of 2 x 128 tokens at step ``step`` (the
    ranks of one model group take the same rows): every group's weights
    sum to 2, so the mean of the data groups' gradients is the gradient of
    their batches put together."""
    import numpy as np
    import torch
    rng = np.random.default_rng(1000 * step + group)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 128)),
                          dtype=torch.int32, device=device)
    return {"tokens": tok, "labels": torch.roll(tok, -1, 1),
            "weights": torch.ones(2, device=device)}


def _rank_cases(n: int) -> list:
    """The train meshes of ``ranks_check`` over n cards, (arch, data,
    model, float32): (n, 1) in float32 and bfloat16, then the model axis:
    (1, n) and (2, n / 2) in float32, (1, n) in bfloat16, phi3.5-moe,
    jamba-1.5-large and xlstm-350m at (1, n) in float32 (``_rank_cfg``'s
    cuts)."""
    cases = [("deepseek-7b", n, 1, True), ("deepseek-7b", n, 1, False),
             ("deepseek-7b", 1, n, True)]
    if n >= 4 and n % 2 == 0:
        cases.append(("deepseek-7b", 2, n // 2, True))
    return cases + [("deepseek-7b", 1, n, False),
                    ("phi3.5-moe-42b-a6.6b", 1, n, True),
                    ("jamba-1.5-large-398b", 1, n, True),
                    ("xlstm-350m", 1, n, True)]


def _rank_cfg(arch: str):
    """(the config a train mesh of ``ranks_check`` runs for ``arch`` at
    published width, its ``reduced:`` cut)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch.startswith("jamba"):
        # the period's dense Mamba block: Mamba (d_inner 16384, d_state 16)
        # and the dense MLP (d_ff 24576)
        return (cfg.with_overrides(n_layers=1, period=cfg.period[2:3]),
                f"{cfg.n_layers} -> 1 layer, the period's dense Mamba block "
                f"(period[2:3]: Mamba, dense MLP)")
    if arch == "xlstm-350m":
        return (cfg.with_overrides(n_layers=2),
                f"{cfg.n_layers} -> 2 layers, one period (mLSTM, sLSTM)")
    return (cfg.with_overrides(n_layers=1),
            f"{cfg.n_layers} -> 1 layer")


# the logical axes the model axis splits (``sharding.logical_rules``)
_SPLIT = ("heads", "kv", "ff", "vocab", "expert", "d_inner")


def _heads_flip(t, dim: int, H: int):
    """``t`` with its ``dim`` read as H blocks in a row: the blocks in the
    reverse order, each block's own order kept."""
    return t.unflatten(dim, (H, -1)).flip(dim).flatten(dim, dim + 1)


def _mirror_leaf(t, axes, key: str, kind, H: int):
    """One leaf of ``_mirror``: ``axes`` its logical axes, ``key`` its name,
    ``kind`` its block's kind (None outside the blocks)."""
    import torch

    last = t.dim() - 1
    if key == "router":                    # the experts' columns
        return t.flip(last)
    if kind == "mamba" and key == "in_proj":
        # each half's channels reversed: x and z stay apart
        j = axes.index("d_inner")
        return t.unflatten(j, (2, -1)).flip(j + 1).flatten(j, j + 1)
    if kind == "mlstm":
        # the x half's channels (wq/wk/wv/wi/wf's rows) reversed, the heads'
        # space (z, the hidden state, gn, down's rows) by whole heads
        if key == "up":
            xm, z = t.chunk(2, last)
            return torch.cat([xm.flip(last), _heads_flip(z, last, H)], last)
        if key in ("gn", "down"):
            return _heads_flip(t, axes.index("d_inner"), H)
        if key in ("wi", "wf"):            # (dp, heads)
            return t.flip([last - 1, last])
        if key in ("bi", "bf"):
            return t.flip(last)
    if kind == "slstm" and key in ("gn", "up", "gate"):
        # labelled embed, but indexing the hidden state: by whole heads
        j = axes.index("embed")
        t = _heads_flip(t, j, H)
        return t.flip(last) if key != "gn" else t
    dims = [d for d, a in enumerate(axes) if a in _SPLIT]
    return t.flip(dims) if dims else t


def _mirror(tree, axes, cfg):
    """``tree`` (the parameters or a moment of ``cfg``'s model; ``axes``
    its ``param_axes``) with every dim the model axis splits reversed: the
    heads, kv heads, ff columns, vocabulary rows and experts in the
    reverse order, the router's expert columns with them; the Mamba
    layer's d_inner channels reversed (within each half of ``in_proj``);
    the mLSTM's input channels reversed and its heads reversed as whole
    blocks wherever their space appears (the z half of ``up``, ``gn``,
    ``down``'s rows, the gates' head columns and biases), the sLSTM's
    heads likewise (its gates' weights and biases, and ``gn`` and the
    ``up`` / ``gate`` rows, labelled ``embed`` but indexing the hidden
    state).  The same model (on tokens ``vocab - 1 - t``), every sum the
    model axis splits taken in another order; its own inverse."""
    kinds = {str(i): s.kind for i, s in enumerate(cfg.period)}

    def walk(t, ax, path):
        if isinstance(t, dict):
            return {k: walk(v, ax[k], path + (k,)) for k, v in t.items()}
        kind = kinds.get(path[1]) if path[0] == "blocks" else None
        return _mirror_leaf(t, ax, path[-1], kind, cfg.n_heads)

    return walk(tree, axes, ())


def _rank_train(rank: int, dev, log, arch: str, data: int, model: int,
                f32: bool) -> dict | None:
    """One train mesh of ``_rank_worker``: 3 partitioned steps on this
    rank's card; rank 0 also runs the one-rank step on the data groups'
    batches put together, after each partitioned step, and after the
    mesh's last collective the witness (the same steps on those rows in
    the reverse order, on a model axis on the mirrored model), and
    returns the comparison; every rank returns its held bytes, peaks and
    step times for rank 0 to gather.  ``log(what)``
    prints a line of this rank's progress: one before each collective
    and around rank 0's own work."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_local_mesh
    from repro_torch.models import init_params, param_axes
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.sharding import make_shardings
    from repro_torch.train.steps import (build_train_step, gather,
                                         place_train_state)
    from repro_torch.tree import tree_leaves, tree_map

    cfg, _ = _rank_cfg(arch)
    if f32:
        cfg = cfg.with_overrides(dtype="float32", param_dtype="float32")
    log("makes the mesh (new groups)")
    mesh = make_local_mesh(data, model, device=dev)
    group = rank // model          # the rank's data group (row-major mesh)
    lr = cosine_schedule(3e-3, 2, 10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    params = init_params(cfg, 0, device=dev)
    opt = adamw_init(params)
    whole = sum(t.untyped_storage().nbytes() for t in tree_leaves(
        (params, opt.m, opt.v)))
    sh = make_shardings(mesh, params, param_axes(cfg))
    lp, lo = place_train_state(params, opt, sh)
    del params, opt
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - base
    step = build_train_step(cfg, lr, grad_specs=sh)

    def worst(a, b):
        """(max |a - b| over each leaf's largest |b|, elements that
        differ, elements off by more than both rel 1e-5 of their leaf's
        largest |b| and one unit in the last place of b's dtype at
        |b|)."""
        rel, diff, bad = 0.0, 0, 0
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            x, y = x.to(dev), y.to(dev)      # a leaf at a time on the card
            d = (x.float() - y.float()).abs()
            top = max(float(y.float().abs().max()), 1e-30)
            rel = max(rel, float(d.max()) / top)
            diff += int((d > 0).sum())
            bits = 1 - int(math.log2(torch.finfo(y.dtype).eps))
            _, e = torch.frexp(y.float())
            ulp = torch.ldexp(torch.ones_like(d), e - bits)
            bad += int((d > torch.clamp(ulp, min=1e-5 * top)).sum())
        return rel, diff, bad

    def timed(fn, times):
        ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
        ev[0].record()
        got = fn()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
        return got

    # the whole parameters, copied: a replicated leaf's gather is its shard
    # itself, which the step overwrites
    whole_copy = lambda: tree_map(torch.clone, gather(lp))  # noqa: E731
    # the whole leaves on the host, a leaf at a time (what rank 0 compares
    # after its one-rank steps: on the card they would not fit beside them
    # at phi3.5-moe's width in float32)
    host = lambda tree: tree_map(  # noqa: E731
        lambda t: gather(t).to("cpu", copy=True), tree)
    log("gathers the seeded parameters")
    seed = whole_copy()     # the seeded draw (a gather: every rank)
    # the witness: another order of the sums the mesh splits, the rows
    # reversed (the data axis) and, on a model axis, the model mirrored
    axes = param_axes(cfg)
    mirror = (lambda t: _mirror(t, axes, cfg)) if model > 1 else (  # noqa
        lambda t: t)

    def batches(t):
        """Step t's rows of every data group together, and the witness's:
        those rows in the reverse order (and mirrored tokens)."""
        bs = [_rank_batch(cfg, g, t, dev) for g in range(data)]
        both = {k: torch.cat([b[k] for b in bs]) for k in bs[0]}
        rev = {k: torch.flip(v, [0]) for k, v in both.items()}
        if model > 1:
            rev["tokens"] = cfg.vocab - 1 - rev["tokens"]
            rev["labels"] = cfg.vocab - 1 - rev["labels"]
        return both, rev

    if rank == 0:
        # the one-rank step runs in step with the mesh's; the witness after
        # the mesh's last collective, from its start kept on the host
        # (both steps' states and a step would not fit on the card at
        # jamba's width in float32), against the one-rank step's moments
        # kept on the host a step
        params = seed
        w_start = tree_map(lambda t: t.to("cpu", copy=True), mirror(seed))
        opt = adamw_init(params)
        plain = build_train_step(cfg, lr)
        ref_mv = []
    del seed
    norms, ms, peaks, ref_ms = [], [], [], []
    ref_norms, w_norms, mv, w_mv = [], [], [], []
    for t in range(3):
        if t == 2:                 # the parameters before the last step
            log(f"step {t + 1}: gathers the parameters before it")
            before = host(lp)
        batch = _rank_batch(cfg, group, t, dev)
        log(f"step {t + 1}: barrier")
        dist.barrier()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        log(f"step {t + 1}: the partitioned step")
        _, _, met = timed(lambda: step(lp, lo, batch), ms)
        # the rank's state and the step's peak above what it found
        peaks.append(torch.cuda.max_memory_allocated(dev) - start + held)
        norms.append(float(met["grad_norm"]))
        log(f"step {t + 1}: gathers the moments")
        got_m, got_v = host((lo.m, lo.v))
        if rank == 0:
            log(f"step {t + 1}: the one-rank step")
            params, opt, met = timed(
                lambda: plain(params, opt, batches(t)[0]), ref_ms)
            ref_norms.append(float(met["grad_norm"]))
            mv.append((worst(got_m, opt.m)[0], worst(got_v, opt.v)[0]))
            ref_mv.append(tree_map(lambda t: t.to("cpu", copy=True),
                                   (opt.m, opt.v)))
    log("gathers the parameters after step 3")
    got_p = gather(lp)
    mine = {"held": held, "ms": ms, "peak": peaks}
    ranks = [None] * dist.get_world_size()
    log("all_gather_object")
    dist.all_gather_object(ranks, mine)
    log("ends the mesh")
    if rank != 0:
        return None
    del lp, lo
    # the last step's parameters are AdamW's update of those before it
    # from the gathered moments, bit for bit
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1
    cf = torch.full((), 3.0, device=dev)
    c1, c2 = 1.0 - b1 ** cf, 1.0 - b2 ** cf
    lr2 = lr(torch.full((), 2, dtype=torch.int32, device=dev))
    exact = True
    for x, p0, m, v in zip(tree_leaves(got_p), tree_leaves(before),
                           tree_leaves(got_m), tree_leaves(got_v)):
        p0, m, v = (t.to(dev) for t in (p0, m, v))
        upd = lr2 * (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps)
        upd = upd + lr2 * wd * p0.float()
        exact &= bool(torch.equal(x, (p0.float() - upd).to(x.dtype)))
    out = {"arch": arch, "data": data, "model": model, "f32": f32,
           "norms": norms, "ref_norms": ref_norms, "w_norms": w_norms,
           "mv": mv, "w_mv": w_mv, "params": worst(got_p, params),
           "exact_last_update": exact,
           "elements": sum(t.numel() for t in tree_leaves(got_p)),
           "whole": whole, "ref_ms": ref_ms, "ranks": ranks,
           "param_dtype": str(tree_leaves(got_p)[0].dtype)}
    # the witness's steps on a card holding of the rest only the one-rank
    # step's last parameters
    del got_p, opt
    gc.collect()
    torch.cuda.empty_cache()
    log("the witness's steps")
    w_params = tree_map(lambda t: t.to(dev), w_start)
    w_opt = adamw_init(w_params)
    del w_start
    for t, (m, v) in enumerate(ref_mv):
        w_params, w_opt, w_met = plain(w_params, w_opt, batches(t)[1])
        w_norms.append(float(w_met["grad_norm"]))
        w_mv.append((worst(mirror(w_opt.m), m)[0],
                     worst(mirror(w_opt.v), v)[0]))
    out["w_params"] = worst(mirror(w_params), params)
    return out


# the serve checks over the model axis, a prompt of 1024 and 8 decode
# steps: (arch, batch) at published width, cut by ``_serve_cfg``
SERVES = (("gemma2-27b", 4), ("jamba-1.5-large-398b", 1), ("xlstm-350m", 2))
# context-parallel decode: these at batch 1 over (n, 1) and (2, n / 2),
# the attention caches' 1032 slots on the data ranks
CP_SERVES = ("gemma2-27b", "jamba-1.5-large-398b")
SERVE_PROMPT, SERVE_NEW = 1024, 8


def _serve_cases(n: int) -> list:
    """The serve checks of ``ranks_check`` over n cards, (arch, batch,
    data): ``SERVES`` over (1, n), then ``CP_SERVES`` at batch 1 over
    (n, 1) and, from four cards, (2, n / 2)."""
    datas = [n] + ([2] if n >= 4 and n % 2 == 0 else [])
    return ([(arch, B, 1) for arch, B in SERVES]
            + [(arch, 1, d) for d in datas for arch in CP_SERVES])


def _attn_cache_bytes(cfg, caches) -> int:
    """The bytes of a cache tree's attention caches (keys and values)."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size()
               for spec, c in zip(cfg.period, caches) if spec.kind == "attn"
               for t in tree_leaves(c))


def _serve_cfg(arch: str):
    """(the config a serve check of ``ranks_check`` runs for ``arch`` at
    published width, its ``reduced:`` cut)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch.startswith("jamba"):
        return (cfg.with_overrides(n_layers=2,
                                   period=(cfg.period[0], cfg.period[2])),
                f"{cfg.n_layers} -> 2 layers, attention and the dense Mamba "
                f"block (period[0], period[2]; dense MLPs)")
    if arch == "gemma2-27b":
        return cfg.with_overrides(n_layers=2), f"{cfg.n_layers} -> 2 layers"
    return cfg, f"whole ({cfg.n_layers} layers)"


def _rank_serve(rank: int, n: int, dev, log, arch: str, B: int, data: int,
                f32: bool, want32=None):
    """Prefill and SERVE_NEW eager decode steps (``build_prefill_step`` /
    ``build_decode_step`` given the parameters' shards on a (data, n /
    data) mesh, every ``graphs.scan`` eager: no capture) on the same
    tokens as rank 0's one-card eager path on the whole parameters, in
    float32 or as published (bfloat16).  At batch 1 on data ranks the
    attention caches' sequence is split over them (context-parallel
    decode).  Rank 0 returns the logits' distance, both paths' times,
    every rank's attention cache bytes after prefill beside one card's,
    and the one-card logits (``want``), and given the float32 run's
    one-card logits (``want32``) the one-card bfloat16 path's own
    distance from them.  ``log(what)`` prints a line of this rank's
    progress before each step's collectives."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import graphs
    from repro_torch.launch import make_local_mesh
    from repro_torch.models import init_params, param_axes
    from repro_torch.sharding import make_shardings
    from repro_torch.train.steps import (build_decode_step,
                                         build_prefill_step, place_params)

    cfg, _ = _serve_cfg(arch)
    if f32:
        cfg = cfg.with_overrides(dtype="float32", param_dtype="float32")
    log("makes the mesh (new groups)")
    mesh = make_local_mesh(data, n // data, device=dev)
    params = init_params(cfg, 0, device=dev)
    log("places the parameters")
    lp = place_params(params, make_shardings(mesh, params, param_axes(cfg)))
    if rank != 0:
        del params
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (
        B, SERVE_PROMPT + SERVE_NEW)), dtype=torch.int32, device=dev)
    L = SERVE_PROMPT + SERVE_NEW
    pre = build_prefill_step(cfg, cache_len=L, global_batch=B)
    dec = build_decode_step(cfg, cache_len=L, global_batch=B)

    def serve(p, say=lambda what: None):
        """(prefill's and every decode step's logits, prefill ms, decode
        ms a step by CUDA events, the attention caches' bytes after
        prefill)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        say("prefill")
        ev[0].record()
        logits, caches = pre(p, {"tokens": toks[:, :SERVE_PROMPT]})
        ev[1].record()
        held = _attn_cache_bytes(cfg, caches)
        out = [logits]
        for i in range(SERVE_NEW):
            t = SERVE_PROMPT + i
            say(f"decode step {i + 1}")
            logits, caches = dec(p, toks[:, t:t + 1], caches, t)
            out.append(logits)
        ev[2].record()
        torch.cuda.synchronize()
        return (out, ev[0].elapsed_time(ev[1]),
                ev[1].elapsed_time(ev[2]) / SERVE_NEW, held)

    def dist_(a, b):
        return [float((x.float() - y.float()).abs().max())
                / float(y.float().abs().max()) for x, y in zip(a, b)]

    with graphs.capturing(False):
        got, pre_ms, dec_ms, held = serve(lp, log)
        helds = [None] * dist.get_world_size()
        log("all_gather_object")
        dist.all_gather_object(helds, held)
        if rank != 0:
            return None
        want, ref_pre_ms, ref_dec_ms, whole = serve(params)
    return {"arch": arch, "batch": B, "data": data, "model": n // data,
            "dtype": str(cfg.dtype), "errs": dist_(got, want),
            "own": dist_(want, want32) if want32 is not None else None,
            "shape": list(got[-1].shape), "ms": [pre_ms, dec_ms],
            "ref_ms": [ref_pre_ms, ref_dec_ms], "want": want,
            "held": helds, "whole_cache": whole,
            # the ranks a cache's kv heads split over (``model`` where it
            # divides n_kv), beside the data ranks its sequence splits over
            "kv_ranks": n // data if cfg.n_kv % (n // data) == 0 else 1,
            "finite": all(bool(torch.isfinite(x).all()) for x in got)}


def _rank_worker(rank: int, n: int, port: int, out: str, cases) -> None:
    """One rank of ``ranks_check``: every train mesh of ``cases`` in turn
    (``_rank_train``), then the serve checks (``_serve_cases``), float32
    and bfloat16; rank 0 writes the results to ``out``.  A failure prints its
    traceback and ends the process at once (the spawn then fails the
    check): tearing the group down would wait on the other ranks' pending
    collectives.  A rank sent SIGTERM (the spawn ending the others after
    a failure, or a time limit) prints every thread's stack first."""
    sys.path.insert(0, str(ROOT / "src"))
    import faulthandler
    import signal
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=120), device_id=dev)

    def log(what):
        print(f"ranks: rank {rank} {what} at "
              f"{time.perf_counter() - t_start:.1f} s, "
              f"{torch.cuda.memory_allocated(dev)} bytes allocated",
              flush=True)

    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    t_start = time.perf_counter()
    try:
        res = {"train": [], "serve": []}
        for case in cases:
            t0 = time.perf_counter()
            log(f"starts {case}")
            got = _rank_train(rank, dev, lambda w, c=case: log(f"{c}: {w}"),
                              *case)
            gc.collect()
            torch.cuda.empty_cache()
            if got is not None:
                got["host_s"] = time.perf_counter() - t0
                res["train"].append(got)
        for arch, B, data in _serve_cases(n):
            case = f"serve {arch} batch {B} over ({data}, {n // data})"
            say = lambda w, c=case: log(f"{c}: {w}")  # noqa: E731
            log(f"starts {case}")
            sv32 = _rank_serve(rank, n, dev, say, arch, B, data, True)
            want32 = sv32.pop("want") if sv32 else None
            sv16 = _rank_serve(rank, n, dev, say, arch, B, data, False,
                               want32)
            gc.collect()
            torch.cuda.empty_cache()
            if rank == 0:
                sv16.pop("want")
                res["serve"] += [sv32, sv16]
        if rank == 0:
            Path(out).write_text(json.dumps(res))
        log("done")
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


# how far the n-rank step may lie from the one-rank step: within WITNESS_X
# times the witness's distance (the one-rank step on the same rows in the
# reverse order and, on a model axis, on the mirrored model: the same
# arithmetic, another order of the sums the mesh splits), plus the
# parameters' dtype's eps (float32 2^-23, bfloat16 2^-7: one unit in the
# last place is at most eps of the value)
WITNESS_X = 10.0
# the serve gate: prefill / decode logits within 1e-3 of max|logit|
SERVE_GATE = 1e-3


def ranks_check(smi: str) -> None:
    """The partitioned train step (``build_train_step(grad_specs=)``) over
    every card, one process a card (NCCL), at deepseek-7b's published
    width with 1 layer, 3 steps from the seeded parameters, on the meshes
    of ``_rank_cases``: the data axis alone (n, 1) in float32 and as
    published (bfloat16), then the model axis computed on shards
    (``sharding.tp``): (1, n) and (2, n / 2) in float32, (1, n) in
    bfloat16, and at (1, n) in float32 phi3.5-moe with 1 layer,
    jamba-1.5-large with the period's dense Mamba block and xlstm-350m
    with one period (mLSTM, sLSTM), each at published width
    (``_rank_cfg``).  The ranks of a model group take the same batch.  Against
    the one-rank step on the data groups' batches put together (rank 0),
    and against a witness of what another order of the sums the mesh
    splits does: the one-rank step on the same rows in the reverse order
    and, on a model axis, on the model mirrored (``_mirror``: the heads,
    ff columns, vocabulary rows and experts reversed, the tokens with
    them; the Mamba channels, the mLSTM's and sLSTM's heads likewise),
    its moments and parameters mirrored back.  Held on
    every mesh: ``grad_norm`` every step, the moments after every step
    (each leaf's largest entry the scale) and the parameters after step 3
    within ``WITNESS_X`` times the witness's distance from the one-rank
    step plus the dtype's eps; the last update AdamW's of the gathered
    moments bit for bit; each rank's allocated bytes for its parameters
    and moments 1/n of the one-rank's within 1 % (at (1, n) within 0.001
    of 1/n); at (n, 1) in float32 also ``grad_norm`` and step 1's moments
    to rel 1e-5.  Then serving (``_serve_cases``) over the model axis:
    gemma2-27b at published width with 2 layers (batch 4), jamba-1.5-large
    with attention and the dense Mamba block (batch 1) and xlstm-350m
    whole (batch 2) at (1, n); and context-parallel decode: gemma2-27b
    (its windowed layer and soft-caps) and jamba at batch 1 over (n, 1)
    and (2, n / 2), each rank holding 1/data of one card's attention
    caches, over the kv heads' model ranks too (within 1 %); each serve a prompt of 1024 and 8 eager decode
    steps against the one-card eager path, in float32
    every logit within ``SERVE_GATE`` of max|logit|, as published
    (bfloat16) within ``WITNESS_X`` times the one-card path's own
    distance from its float32 run (a bfloat16 sum split over the model
    axis rounds its partial sums: what bfloat16 itself costs is the
    yardstick).  Printed per mesh: a rank's held
    bytes against the one-rank state, the peak allocated a rank (its
    state and a step's peak above what the step found), step ms a rank
    (CUDA events, the median of steps 2-3).  Below two cards it says so
    and returns."""
    import socket

    import torch
    import torch.multiprocessing as mp

    n = torch.cuda.device_count()
    if n < 2:
        print(f"grad_specs over n ranks: this check needs two cards or "
              f"more; {n} here, not run")
        return
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    out = tmp / "ranks.json"
    t0 = time.perf_counter()
    try:
        mp.spawn(_rank_worker, args=(n, port, str(out), _rank_cases(n)),
                 nprocs=n, join=True)
        res = json.loads(out.read_text())
    finally:
        shutil.rmtree(tmp)
    print(f"ranks: {len(res['train'])} meshes and {len(res['serve'])} "
          f"serve checks over {n} cards in {time.perf_counter() - t0:.1f} s"
          f" host clock")
    for arch in dict.fromkeys(c[0] for c in _rank_cases(n)):
        print(f"reduced: {arch} train meshes: {_rank_cfg(arch)[1]}")
    for arch, B, data in _serve_cases(n):
        print(f"reduced: {arch} serve at batch {B} over ({data}, "
              f"{n // data}): {_serve_cfg(arch)[1]}")
    failed = [f for r in res["train"] for f in _ranks_report(r, n, smi)]
    for sv in res["serve"]:
        f32 = sv["own"] is None
        data = sv["data"]
        label = (f"serve over ({data}, {sv['model']}) ({sv['arch']}, "
                 f"{_serve_cfg(sv['arch'])[1]}, {sv['dtype']})")
        # (xlstm-350m has no attention cache)
        held = [h / max(sv["whole_cache"], 1) for h in sv["held"]]
        share = data * sv["kv_ranks"]     # a rank's share of the cache
        print(f"{label}: batch {sv['batch']}, prompt {SERVE_PROMPT}, "
              f"{SERVE_NEW} eager decode steps, NCCL, no capture, against "
              f"the one-card eager path: logits {sv['shape']}, max|diff| "
              f"/ max|logit| prefill {sv['errs'][0]:.3e}, decode steps "
              f"{[float(f'{e:.3e}') for e in sv['errs'][1:]]}"
              + (f" (gate {SERVE_GATE:g})" if f32 else
                 f" (the one-card path's own distance from its float32 "
                 f"run, prefill and decode: "
                 f"{[float(f'{e:.3e}') for e in sv['own']]}; held within "
                 f"{WITNESS_X:g} x it)")
              + f"; prefill {sv['ms'][0]:.2f} ms (one card "
              f"{sv['ref_ms'][0]:.2f}), decode {sv['ms'][1]:.3f} ms a step "
              f"(one card {sv['ref_ms'][1]:.3f}); attention cache held a "
              f"rank {sv['held']} bytes, {[round(h, 5) for h in held]} of "
              f"one card's {sv['whole_cache']} (1/{share}: the sequence "
              f"over {data} data ranks, the kv heads over "
              f"{sv['kv_ranks']})  [{smi}, {n} cards]")
        if sv["batch"] == 1 and sv["whole_cache"] and any(
                abs(h * share - 1.0) > 0.01 for h in held):
            failed.append(f"{label}: attention cache held a rank {held} of "
                          f"one card's, not 1/{share}")
        if not sv["finite"]:
            failed.append(f"{label}: logits not finite")
        if f32 and max(sv["errs"]) > SERVE_GATE:
            failed.append(f"{label}: logits {sv['errs']} of max|logit|")
        if not f32 and any(e > WITNESS_X * o for e, o in zip(sv["errs"],
                                                             sv["own"])):
            failed.append(f"{label}: logits {sv['errs']} of max|logit|, "
                          f"beyond {WITNESS_X:g} x the one-card path's own "
                          f"{sv['own']}")
    require(not failed, "ranks: " + "; ".join(failed))


def _ranks_report(res: dict, n: int, smi: str) -> list:
    """Print one train mesh of ``ranks_check``; return the rules it
    breaks (``ranks_check`` fails on them after printing every mesh)."""
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)

    f32, data, model = res["f32"], res["data"], res["model"]
    mesh = f"({data}, {model})"
    dt = res["param_dtype"]
    eps = 2.0 ** -23 if f32 else 2.0 ** -7
    rel = lambda got: [abs(a - b) / abs(b) for a, b in zip(  # noqa: E731
        got, res["ref_norms"])]
    norm_rel, w_norm_rel = rel(res["norms"]), rel(res["w_norms"])
    p_rel, p_diff, p_bad = res["params"]
    w_p_rel = res["w_params"][0]
    held = [r["held"] / res["whole"] for r in res["ranks"]]
    # (what, the n ranks' distance, the witness's)
    pairs = [(f"grad_norm step {t + 1}", a, b)
             for t, (a, b) in enumerate(zip(norm_rel, w_norm_rel))]
    for t, ((m, v), (wm, wv)) in enumerate(zip(res["mv"], res["w_mv"])):
        pairs += [(f"m step {t + 1}", m, wm), (f"v step {t + 1}", v, wv)]
    pairs.append(("parameters after step 3", p_rel, w_p_rel))
    label = (f"grad_specs over {mesh} ({res['arch']} "
             f"{_rank_cfg(res['arch'])[1]}, {dt})")
    print(f"{label}: 3 steps, 2 x 128 tokens a data group, against the "
          f"one-rank step on the data groups' batches together, rel to "
          f"each leaf's largest entry, the ranks' (the witness's: the "
          f"one-rank step on the rows in reverse order"
          + (", the model mirrored (heads, ff, vocabulary, experts, "
             "Mamba channels reversed)" if model > 1 else "") + "): "
          + "; ".join(f"{w} {a:.2e} ({b:.2e})" for w, a, b in pairs)
          + f"; grad_norm {res['norms']}, the one-rank step's "
          f"{res['ref_norms']}; parameters after step 3: {p_diff} of "
          f"{res['elements']} elements differ, {p_bad} by more than rel "
          f"1e-5 of their leaf's largest entry and one unit in their last "
          f"place (held: each within {WITNESS_X:g} x the witness's + "
          f"{eps:.2e}" + ("; grad_norm and step 1's moments within rel "
                          "1e-5" if f32 and model == 1 else "")
          + f"); last update AdamW's of the gathered moments bit for bit: "
          f"{res['exact_last_update']}; {res['host_s']:.1f} s host clock")
    per = [spread(r["ms"][1:], "ms", 2) for r in res["ranks"]]
    print(f"{label}: held a rank {[round(h, 5) for h in held]} of the "
          f"one-rank state's {res['whole']} bytes; peak allocated a rank "
          f"{[max(r['peak']) for r in res['ranks']]} bytes; a step (CUDA "
          f"events, steps 2-3) by rank {per}, median "
          f"{statistics.median(x for r in res['ranks'] for x in r['ms'][1:]):.2f}"
          f" ms; the one-rank step on card 0 "
          f"{spread(res['ref_ms'][1:], 'ms', 2)}  [{smi}, {n} cards]")
    check(res["exact_last_update"],
            f"{label}: the last update is not AdamW's of the gathered "
            f"moments")
    check(all(abs(h * n - 1.0) <= 0.01 for h in held),
            f"{label}: held {held} of the whole")
    if data == 1:
        check(all(abs(h - 1.0 / n) <= 0.001 for h in held),
                f"{label}: held {held} of the whole, not 1/{n} within "
                f"0.001")
    far = [(w, a, b) for w, a, b in pairs if a > WITNESS_X * b + eps]
    check(not far, f"{label}: beyond {WITNESS_X:g} x the witness: {far}")
    if f32 and model == 1:
        check(max(norm_rel) <= 1e-5, f"{label}: grad_norm rel {norm_rel}")
        check(max(res["mv"][0]) <= 1e-5,
                f"{label}: step 1's moments rel {res['mv'][0]}")
    return failed


def sharded_phase(cfg, step: float, smi: str, drive) -> None:
    """The realization axis over cards at PAPER_RIDGE's width, R = 8:
    ``run_batched(placement="sharded")`` for coded-gd (100 steps),
    coded-prox (50) and async (320 updates) beside ``placement="vmap"``,
    the split, the launches and the gather over two shards of card 0, and
    over every card where there are more than one (then Fig. 7 at R = 32
    too)."""
    import numpy as np
    import torch
    from repro_torch.core import (FastHadamardEncoder, bimodal_delays,
                                  make_encoded_problem, make_encoder)
    from repro_torch.kernels import _build
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
    # async: 10 steps' worth of updates, one fused launch an update a card
    AU, bound = 10 * m, 2 * m
    out = {}
    for placement in ("sharded", "vmap"):
        out[placement] = drive(
            f"async run_batched R={R} {placement}",
            lambda: get_strategy("async").run_batched(
                spec, engine, steps=10, trials=R, placement=placement,
                step_size=step),
            {fused: AU * (split if placement == "sharded" else 1)})
    sh, vm = out["sharded"], out["vmap"]
    require(sh.meta["placement_devices"] == split and
            np.array_equal(sh.objective, vm.objective) and
            np.array_equal(sh.w, vm.w) and np.array_equal(sh.times, vm.times),
            "sharded async: placement sharded != vmap")
    print(f"sharded async run_batched R={R}, {AU} updates: placement_devices "
          f"{split}; w, trace and times == vmap bit for bit; {split * AU} "
          f"fused launches")

    def in_turns(runs: dict, T: int) -> dict:
        """A sample a design in turns (each design, then the same in
        reverse), three rounds; times over T steps or updates."""
        got = {key: [] for key in runs}
        order = list(runs) + list(runs)[::-1]
        for _ in range(3):
            for key in order:
                got[key] += [t / T for t in samples_ms(runs[key], 1)]
        return got

    # the split, the per-card launches and the gather over two shards of
    # card 0, then over every card
    prob = make_encoded_problem(spec.X, spec.y,
                                FastHadamardEncoder(n, cfg.beta, seed=0), m,
                                lam=spec.lam, device=dev)
    aprob = make_encoded_problem(spec.X, spec.y,
                                 make_encoder("uncoded", n, beta=1.0), m,
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
            n0 = _build.captures
            ws, ts = drive(f"{name} _sharded_run {label}",
                           lambda: runners._sharded_run(
                               devices, kind, prob, masks, step, W0, **rkw),
                           {fused: len(devices) * T})
            require(_build.captures - n0 == len(devices),
                    f"{name} {label}: {_build.captures - n0} captures for "
                    f"{len(devices)} shards")
            wb, tb = batched(prob, masks, step, W0, eval_every=1)
            require(torch.equal(ws, wb) and torch.equal(ts, tb),
                    f"{name} {label}: sharded != batched")
            # captured as users run them, and uncaptured (every op of
            # every step enqueued from the host)
            got = in_turns({
                "sharded": lambda: runners._sharded_run(
                    devices, kind, prob, masks, step, W0, **rkw),
                "batched": lambda: runners._run(
                    prob, masks, step, W0, kind=kind, **rkw),
                "sharded uncaptured": lambda: runners._sharded_run(
                    devices, kind, prob, masks, step, W0, capture=False,
                    **rkw),
                "batched uncaptured": lambda: runners._run(
                    prob, masks, step, W0, kind=kind, capture=False,
                    **rkw)}, T)
            print(f"sharded {name} {label}, R={RS}, {T} steps: w and trace "
                  f"== batched bit for bit; {len(devices) * T} fused "
                  f"launches, a graph a shard; a step: "
                  + "; ".join(f"{key} {spread(v, 'ms')}"
                              for key, v in got.items()) + f"  [{smi}]")
        # async on the uncoded problem, the event streams split with their
        # realizations
        aev = engine.sample_asyncs(AU, bound, RS)
        args = (aev.workers, aev.staleness, step / m,
                torch.zeros((RS, p), device=dev), bound + 1, "l2", 1)
        n0 = _build.captures
        ws, ts = drive(f"async _sharded_run {label}",
                       lambda: runners._sharded_run(devices, "async", aprob,
                                                    *args),
                       {fused: len(devices) * AU})
        require(_build.captures - n0 == len(devices),
                f"async {label}: {_build.captures - n0} captures for "
                f"{len(devices)} shards")
        wb, tb = runners.batched_scan_async(aprob, *args[:5])
        require(torch.equal(ws, wb) and torch.equal(ts, tb),
                f"async {label}: sharded != batched")
        got = in_turns({
            "sharded": lambda: runners._sharded_run(devices, "async", aprob,
                                                    *args),
            "batched": lambda: runners._batched_async(aprob, *args),
            "sharded uncaptured": lambda: runners._sharded_run(
                devices, "async", aprob, *args, capture=False),
            "batched uncaptured": lambda: runners._batched_async(
                aprob, *args, capture=False)}, AU)
        print(f"sharded async {label}, R={RS}, {AU} updates: w and trace == "
              f"batched bit for bit; {len(devices) * AU} fused launches, a "
              f"graph a shard; an update: "
              + "; ".join(f"{key} {spread(v, 'ms')}"
                          for key, v in got.items()) + f"  [{smi}]")
    del prob, aprob
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


def graph_check(prob, lifted, masks: dict, step: float, bcd_step: float,
                k: int, smi: str, asyncs: dict) -> None:
    """The step loops captured against the same runs uncaptured at
    PAPER_RIDGE (module docstring, phase "graph"): ``prob`` the encoded
    problem, ``lifted`` the feature-encoded one, ``masks`` the schedules
    ("run" (100, m), "batched" (4, 100, m), "prox" (50, m), "bcd"
    (60, m), "bcd batched" (4, 60, m)); ``asyncs`` the async problem
    ("prob", uncoded, beta 1), its step size ("step"), ring ("B") and
    event streams ("run" (2, 320), the strategy's, "long" (2, 3200),
    "batched" (2, 4, 320)), each (workers, staleness)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.runtime import runners
    dev = prob.device
    p, b = prob.SX.shape[-1], lifted.XS.shape[-1]
    m = prob.m
    hold = np.array(masks["run"], copy=True)
    hold[::3, :8] = 0.0                 # every third step short of k
    cases = []
    for label, kind, mk, ev, degrade in (
            ("coded-gd R=1", "gd", masks["run"][None], 1, None),
            ("coded-gd R=1, the schedule 5 times", "gd",
             np.tile(masks["run"], (5, 1))[None], 1, None),
            ("coded-gd R=4 eval_every=10", "gd", masks["batched"], 10, None),
            ("coded-prox R=1", "prox", masks["prox"][None], 1, None),
            ("coded-gd R=1 degrade hold", "gd", hold[None], 1,
             ("hold", k, 0.5))):
        mk = torch.as_tensor(mk, device=dev)
        w0 = torch.zeros((mk.shape[0], p), device=dev)
        cases.append((label, mk.shape[1], "step", functools.partial(
            runners._run, prob, mk, step, w0, kind=kind,
            h="l1" if kind == "prox" else "l2", eval_every=ev,
            degrade=degrade)))
    mb = torch.as_tensor(masks["bcd"], device=dev)
    mbb = torch.as_tensor(masks["bcd batched"], device=dev)
    cases.append(("coded-bcd", mb.shape[0], "step", functools.partial(
        runners._scan_bcd, lifted, mb, bcd_step,
        torch.zeros((m, b), device=dev))))
    cases.append(("coded-bcd R=4 eval_every=5", mbb.shape[1], "step",
                  functools.partial(runners._batched_bcd, lifted, mbb,
                                    bcd_step,
                                    torch.zeros((4, m, b), device=dev), 5)))
    # async: the ring's slots and the worker change every update, so a
    # block whose indices were baked into its capture would differ from
    # the uncaptured run (B = 2m + 1 = 65 divides no block of 10)
    aprob, B = asyncs["prob"], asyncs["B"]
    wr, sr = asyncs["run"]
    for label, (wk, st), ring, ev in (
            ("async R=1, the strategy's stream", (wr[None], sr[None]), B, 1),
            ("async R=1", (asyncs["long"][0][None],
                           asyncs["long"][1][None]), B, 1),
            ("async R=4 eval_every=10", asyncs["batched"], B, 10),
            ("async R=1 staleness 0, B=1",
             (wr[None], np.zeros_like(sr)[None]), 1, 1)):
        cases.append((label, wk.shape[1], "update", functools.partial(
            runners._batched_async, aprob, wk, st, asyncs["step"],
            torch.zeros((wk.shape[0], p), device=dev), ring, "l2", ev)))
    for label, T, unit, run in cases:
        out = {}
        for cap in (True, False):
            before, n0 = dict(_build.launches), _build.captures
            s0 = _build.capture_seconds
            res = run(capture=cap)
            torch.cuda.synchronize()
            counted = {kn: v - before.get(kn, 0)
                       for kn, v in _build.launches.items()
                       if v != before.get(kn, 0)}
            out[cap] = (res, counted, _build.captures - n0,
                        _build.capture_seconds - s0)
        (xc, tc), lc, nc, cap_s = out[True]
        (xe, te), le, ne, _ = out[False]
        require((nc, ne) == (1, 0), f"graph {label}: {nc} / {ne} captures")
        require(torch.equal(xc, xe) and torch.equal(tc, te),
                f"graph {label}: captured != uncaptured")
        require(lc == le, f"graph {label}: launches {lc} captured, {le} "
                          f"uncaptured")
        if unit == "update":
            require(lc == {"fused_masked_gradient": T},
                    f"graph {label}: launches {lc}, not one an update")
        # a sample each in turns (captured, uncaptured, uncaptured,
        # captured), three rounds; then one profiled run each
        got = {True: [], False: []}
        for _ in range(3):
            for cap in (True, False, False, True):
                got[cap] += [t / T for t in samples_ms(
                    lambda: run(capture=cap), 1)]
        idle = {cap: 1.0 - device_share(lambda: run(capture=cap))
                for cap in (True, False)}
        an = "an" if unit == "update" else "a"
        print(f"graph {label}, {T} {unit}s: captured == uncaptured bit for "
              f"bit, launches {lc} each, one capture ({cap_s * 1e3:.2f} ms "
              f"of host time); {an} {unit} "
              f"captured {spread(got[True], 'ms')}, idle share "
              f"{idle[True]:.2f}; uncaptured {spread(got[False], 'ms')}, "
              f"idle share {idle[False]:.2f}  [{smi}]")
    # the block length the runners take (10 steps) beside others, in
    # turns, two rounds: coded-gd R = 1 at 100 and 500 steps (5, 10, 20)
    # and async R = 1 at 320 and 3200 updates (10, 20, 40)
    block_steps = runners._BLOCK_STEPS
    by_label = {case[0]: case for case in cases}
    try:
        for label, lengths in (("coded-gd R=1", (5, 10, 20)),
                               ("coded-gd R=1, the schedule 5 times",
                                (5, 10, 20)),
                               ("async R=1, the strategy's stream",
                                (10, 20, 40)),
                               ("async R=1", (10, 20, 40))):
            _, T, unit, run = by_label[label]
            got = {}
            for _ in range(2):
                for c in lengths + lengths[::-1]:
                    runners._BLOCK_STEPS = c
                    got.setdefault(c, []).extend(
                        t / T for t in samples_ms(run, 1))
            an = "an" if unit == "update" else "a"
            print(f"graph {label}, {T} {unit}s, captured, {an} {unit} by "
                  f"block length: " + "; ".join(
                      f"{c} {unit}s {spread(v, 'ms')}"
                      for c, v in got.items()) + f"  [{smi}]")
    finally:
        runners._BLOCK_STEPS = block_steps


def make_drive(counts: dict, by_path: dict):
    """``drive(label, fn, expect)``: run one main-path entry with the launch
    counts cleared just before and read just after; it must launch exactly
    ``expect``.  Each path's launches are kept in ``by_path`` and summed in
    ``counts``."""
    import torch
    from repro_torch.kernels import _build

    def drive(label, fn, expect):
        _build.launches.clear()
        out = fn()
        torch.cuda.synchronize()
        got = {kn: v for kn, v in _build.launches.items() if v}
        require(got == expect, f"{label}: launches {got} != {expect}")
        by_path[label] = got
        for kn, v in got.items():
            counts[kn] = counts.get(kn, 0) + v
        return out
    return drive


def ridge_step(spec, n: int, dev) -> tuple[float, float]:
    """(L, step): the reference's step rule 1 / (1.3 L + lam), L = max
    eig(X^T X / n), with the eigenvalues taken on the card in float64."""
    import torch
    Xd = torch.as_tensor(spec.X, dtype=torch.float64, device=dev)
    L = float(torch.linalg.eigvalsh(Xd.T @ Xd / n).max())
    return L, 1.0 / (1.3 * L + spec.lam)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on one card "
                                 "(module docstring).")
    ap.add_argument("--phase", choices=("all", "sharded", "serve", "train",
                                        "ranks"),
                    default="all",
                    help="'sharded': the build and the sharded phase alone "
                    "(on a host with several cards, the split over all of "
                    "them); 'serve': the serve phase alone (no build: it "
                    "runs no kernel of the port); 'train': the build and "
                    "the train and launch phases alone; 'ranks': the "
                    "partitioned train step over every card alone; "
                    "default: every phase")
    args = ap.parse_args(argv)
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
    if args.phase == "ranks":
        ranks_check(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.phase == "serve":
        serve_phase(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # 2. build ---------------------------------------------------------------
    # nvcc's minutes run beside the serve phase, which launches no kernel
    # of the port (it checks that its launch counts read zero)
    whole = args.phase == "all"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(_build.load_library)
        if whole:
            serve_phase(smi)
        building.result()
    print(f"build: {_build.build_seconds:.1f} s host clock in its thread"
          f"{' beside the serve phase' if whole else ''} -> "
          f"{_build.library_path().name}; compiles {_build.builds}; "
          f"{time.perf_counter() - t0:.1f} s until both ended")
    log = _build.library_path().with_suffix(".log")
    if log.exists():      # absent when an earlier process built the library
        text = log.read_text()
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill", text))
        print(f"ptxas: {len(regs)} kernel instantiations, at most "
              f"{max(regs, default=0)} registers a thread, {spills} bytes "
              f"of spills")

    counts: dict[str, int] = {}
    by_path: dict[str, dict[str, int]] = {}
    drive = make_drive(counts, by_path)
    if args.phase in ("sharded", "train"):
        if args.phase == "sharded":
            spec = ProblemSpec.synthetic(cfg.n, cfg.p, noise=0.5,
                                         lam=cfg.lam, seed=0)
            sharded_phase(cfg, ridge_step(spec, cfg.n, dev)[1], smi, drive)
        else:
            train_phase(smi, drive, {})
            launch_phase(smi, drive)
        print(f"launches by path: {json.dumps(by_path)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

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
    # the async update's gradient: the arriving worker as a one-hot mask
    # over the uncoded problem's blocks (beta 1, r = n / m rows a worker);
    # R = 4 with four workers and with one worker four times
    ra = n // m
    SXa = torch.randn((m, ra, p), device=dev, generator=gen)
    Sya = torch.randn((m, ra), device=dev, generator=gen)
    akw = dict(n=n, beta=1.0)
    for label, ids in (("R=1", [5]), ("R=4, workers 3, 17, 0, 31",
                                       [3, 17, 0, 31]),
                       ("R=4, worker 9 four times", [9] * 4)):
        R = len(ids)
        Wa = torch.randn((R, p), device=dev, generator=gen) * 0.01
        oh = torch.as_tensor(np.eye(m, dtype=np.float32)[ids], device=dev)
        ga = fused_masked_gradient(SXa, Sya, Wa, oh, **akw)
        err, rel = rel_err(ga, fused_masked_gradient_plain(SXa, Sya, Wa, oh,
                                                           **akw))
        require(rel <= 1e-4, f"fused one-hot {label}: rel err {rel:.2e}")
        for q in range(R):
            require(torch.equal(ga[q], fused_masked_gradient(
                SXa, Sya, Wa[q], oh[q], **akw)),
                f"fused one-hot {label}: batched row {q} != single call")
        print(f"check fused one-hot {label} at {tuple(SXa.shape)}: max|d| "
              f"{err:.3e} ({rel:.2e} of max|ref|, tol 1e-4); batched[r] == "
              f"single(r) bitwise")
        fused_err = max(fused_err, err)
    # its device time a call beside the REPRO_FUSED=0 form (the block
    # gathered by its device index, two products), by CUDA graph replay
    wa, oh1 = Wa[:1].clone(), torch.as_tensor(np.eye(m, dtype=np.float32)[
        [5]], device=dev)
    idx = torch.tensor([5], device=dev)
    sc = m / (n * 1.0)

    def two_products():
        SXi = SXa.index_select(0, idx)[0]
        return torch.matmul(SXi.T, torch.matmul(SXi, wa[0]) -
                            Sya.index_select(0, idx)[0]) * sc
    err, rel = rel_err(two_products(), fused_masked_gradient(
        SXa, Sya, wa, oh1, **akw)[0])
    require(rel <= 1e-4, f"fused one-hot vs two products: rel {rel:.2e}")
    gk = [graph_ms(lambda: fused_masked_gradient(SXa, Sya, wa, oh1, **akw))]
    gp = [graph_ms(two_products) for _ in range(2)]
    gk.append(graph_ms(lambda: fused_masked_gradient(SXa, Sya, wa, oh1,
                                                     **akw)))
    # one worker's rows, the iterate and the mask read, the gradient
    # written; 2 flops an element in each of 2 passes
    oh_bound = bound_ms((ra * (p + 1) + 2 * p + m) * 4, 4 * ra * p)[0]
    print(f"fused one-hot R=1 at {tuple(SXa.shape)}, device time a call "
          f"(CUDA graph replay; kernel, products, products, kernel): kernel "
          f"{gk[0]:.5f} / {gk[1]:.5f} ms; REPRO_FUSED=0's gather and two "
          f"products {gp[0]:.5f} / {gp[1]:.5f} ms (to the kernel rel "
          f"{rel:.2e}); bound {oh_bound:.5f} ms  [{smi}]")
    del SXa, Sya
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
    L, step = ridge_step(spec, n, dev)
    engine = ClusterEngine(bimodal_delays(), m, seed=0)
    steps, trials, prox_steps = 100, 4, 50
    run_kw = dict(policy=FastestK(k), encoder="fast-hadamard",
                  step_size=step)
    l1spec = ProblemSpec(X=spec.X, y=spec.y, lam=cfg.lam, h="l1")
    Xy = torch.as_tensor(np.concatenate([spec.X, spec.y[:, None]], 1),
                         dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

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
    lb_steps, lb_trials, bcd_steps, async_steps = 50, 2, 60, 10
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
    # async: one fused launch an update (the arriving worker as a one-hot
    # mask) for all realizations; none under REPRO_FUSED=0
    async_updates = async_steps * m
    asy = drive("async run", lambda: get_strategy("async").run(
        spec, engine, steps=async_steps, step_size=step),
        {fused: async_updates})
    asyb = drive("async run_batched", lambda: get_strategy(
        "async").run_batched(spec, engine, steps=async_steps,
                             trials=trials, eval_every=10, step_size=step),
        {fused: async_updates})
    with env_var("REPRO_FUSED", "0"):
        asy0 = drive("async run REPRO_FUSED=0", lambda: get_strategy(
            "async").run(spec, engine, steps=async_steps, step_size=step),
            {})
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
                      ("async run", asy.objective),
                      ("async run_batched", asyb.objective)):
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
    require(np.array_equal(asyb.objective[0], asy.objective[9::10]) and
            np.array_equal(asyb.w[0], asy.w),
            "async run_batched realization 0 != run at the same updates")
    asy_rel = rel_max(asy0.objective, asy.objective)
    # f32 sums in another order: the kernel's tree against two gemvs
    require(asy_rel <= 1e-4, f"async REPRO_FUSED=0 trace vs fused rel "
                             f"{asy_rel:.2e}")
    print(f"coded-bcd: lifted blocks (m, n, N/m) = ({m}, {n}, "
          f"{bcd.w.shape[-1]}); async: {asy.meta['updates']} updates, "
          f"max staleness {asy.meta['max_staleness']}, dropped "
          f"{asy.meta['dropped']}; run_batched realization 0 == run bit "
          f"for bit; REPRO_FUSED=0 (two products an update) trace vs the "
          f"fused: max rel diff {asy_rel:.2e} (tol 1e-4)")
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

    # the step loops captured against the same runs uncaptured ---------------
    # coded-bcd on the problem its strategy built (the same encoder and
    # seed, rebuilt here), with its run's masks
    lifted = make_lifted_problem(spec.X, FastHadamardEncoder(p, cfg.beta,
                                                             seed=0), m,
                                 *phi_quadratic(spec.y, device=dev),
                                 device=dev)
    # async on the problem its strategy built (the uncoded encoder, beta
    # 1), with its run's events, a stream ten times as long, and 4
    # realizations
    aprob = make_encoded_problem(spec.X, spec.y,
                                 make_encoder("uncoded", n, beta=1.0), m,
                                 lam=spec.lam, device=dev)
    ev = asy.schedule
    bound = asy.meta["staleness_bound"]
    long_ev = engine.sample_async(10 * async_updates, bound)
    bat_ev = engine.sample_asyncs(async_updates, bound, trials)
    graph_check(prob, lifted, {
        "run": res.schedule.masks, "batched": bat.schedules.masks,
        "prox": prox.schedule.masks, "bcd": bcd.schedule.masks,
        "bcd batched": engine.sample_schedules(bcd_steps, FastestK(k),
                                               4).masks},
        step, bcd.meta["step_size"], k, smi, {
            "prob": aprob, "step": asy.meta["step_size"], "B": bound + 1,
            "run": (ev.workers, ev.staleness),
            "long": (long_ev.workers, long_ev.staleness),
            "batched": (bat_ev.workers, bat_ev.staleness)})

    # the workloads ------------------------------------------------------
    workloads_phase(dev, smi, drive)
    # the experiment harness and its CLIs ---------------------------------
    harness_phase(cfg, smi, drive)
    # coded SGD over the dense LM ------------------------------------------
    train_phase(smi, drive, table["coded_combine"])
    # coded-prox at LASSO §5.4's published width ---------------------------
    wide_phase(smi, drive, table)
    # (the model zoo's serve path ran beside the build)
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
    print(f"step R=1 captured (objective every step): {spread(step1, 'ms')}  "
          f"[{smi}]")
    print(f"step R=4 captured (objective every 10 steps): "
          f"{spread(step4, 'ms')}  [{smi}]")
    print(f"encode (make_encoded_problem, host prep included, host clock): "
          f"{spread(encode_s, 's')}  [{smi}]")
    device_breakdown(lambda: scan_gd(prob, masks_run, step, w0),
                     f"{steps} steps R=1 captured")
    device_breakdown(lambda: batched_scan_gd(
        prob, masks_bat, step, w0[None].repeat(trials, 1), eval_every=10),
        f"{steps} steps R=4 captured")
    masks_lb = lb.schedule.masks
    step_lb = [t / lb_steps for t in samples_ms(
        lambda: run_encoded_lbfgs(prob, masks_lb, memory=10), 5)]
    print(f"coded-lbfgs step (memory 10, objective every step): "
          f"{spread(step_lb, 'ms')}  [{smi}]")
    device_breakdown(lambda: run_encoded_lbfgs(prob, masks_lb[:20],
                                               memory=10),
                     "20 coded-lbfgs steps")
    # coded-bcd (the lifted problem of the graph check) and async on the
    # problems their strategies built, with their runs' masks and events
    v0 = torch.zeros((m, lifted.XS.shape[-1]), device=dev)
    masks_bcd = bcd.schedule.masks
    step_bcd = [t / bcd_steps for t in samples_ms(
        lambda: scan_bcd(lifted, masks_bcd, bcd.meta["step_size"], v0), 5)]
    print(f"coded-bcd step captured (objective every step): "
          f"{spread(step_bcd, 'ms')}  [{smi}]")
    device_breakdown(lambda: scan_bcd(lifted, masks_bcd, bcd.meta["step_size"],
                                      v0),
                     f"{bcd_steps} coded-bcd steps captured")
    del lifted
    upd = [t / ev.updates for t in samples_ms(
        lambda: scan_async(aprob, ev.workers, ev.staleness,
                           asy.meta["step_size"], w0,
                           buffer_size=bound + 1), 5)]
    print(f"async update captured (objective every update, "
          f"{ev.updates} updates): {spread(upd, 'ms')}  [{smi}]")
    device_breakdown(lambda: scan_async(aprob, ev.workers, ev.staleness,
                                        asy.meta["step_size"], w0,
                                        buffer_size=bound + 1),
                     f"{ev.updates} async updates captured")
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
