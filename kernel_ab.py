#!/usr/bin/env python3
"""Hold this checkout's fused-gradient and combine kernels against another
checkout's (for example the parent commit, unpacked with ``git archive``
into a git-ignored directory) on one NVIDIA card:

    python3 kernel_ab.py OTHER_CHECKOUT

Each checkout runs in its own process (each builds its own kernels), in
the order other, this, this, other, on the same inputs at the PAPER_RIDGE
shapes, made on the card from seed 0: the fused gradient at (32, 256, 6000)
single and batched at R = 4 and R = 16 (24 of 32 workers a realization),
and the combine at (32, 6000) and (32, 4194304).  It prints each case's
time in every run (CUDA events, mean over back-to-back calls after
warm-up; the combine at (32, 6000) also the profiler's device time a call)
and whether the two checkouts' outputs are equal bit for bit, then the
same as one JSON line.  Exits 2 without a card, 1 if a run fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, P, M, K, BETA = 4096, 6000, 32, 24, 2.0
R_ROWS = 256                     # rows a worker: N = 8192 encoded rows / 32


def _cases(torch, np, dev):
    """(name, fn) pairs over inputs made on the card from seed 0."""
    from repro_torch.kernels.coded_reduce import coded_combine_call
    from repro_torch.kernels.fused_step import fused_masked_gradient
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    SX = torch.randn((M, R_ROWS, P), device=dev, generator=gen)
    Sy = torch.randn((M, R_ROWS), device=dev, generator=gen)
    kw = dict(n=N, beta=BETA)
    cases = []
    for R in (1, 4, 16):
        W = torch.randn((R, P), device=dev, generator=gen) * 0.01
        masks = np.zeros((R, M), np.float32)
        for q in range(R):
            masks[q, rng.permutation(M)[:K]] = 1.0
        mk = torch.as_tensor(masks, device=dev)
        name = "fused single" if R == 1 else f"fused batched R={R}"
        if R == 1:
            cases.append((name, lambda W=W, mk=mk: fused_masked_gradient(
                SX, Sy, W[0], mk[0], **kw)))
        else:
            cases.append((name, lambda W=W, mk=mk: fused_masked_gradient(
                SX, Sy, W, mk, **kw)))
    for cp in (P, 4194304):
        g = torch.randn((M, cp), device=dev, generator=gen)
        c = torch.rand(M, device=dev, generator=gen)
        cases.append((f"combine (32, {cp})",
                      lambda g=g, c=c: coded_combine_call(g, c)))
    return cases


def _time_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
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


def _device_us(torch, fn, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, "self_device_time_total", 0.0)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / reps


def worker(src: str, out: str) -> int:
    """Run every case with the package under ``src``; save the outputs and
    times to ``out`` (a torch file)."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    dev = torch.device("cuda")
    outputs, times = {}, {}
    for name, fn in _cases(torch, np, dev):
        outputs[name] = fn().cpu()
        reps = 20 if "fused" in name or "4194304" in name else 200
        times[name] = _time_ms(torch, fn, reps)
        if name == f"combine (32, {P})":
            times[name + " device_us"] = _device_us(torch, fn, 50)
    torch.save({"outputs": outputs, "times": times}, out)
    return 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        return worker(sys.argv[2], sys.argv[3])
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing run", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    srcs = {"other": str(other / "src"), "this": str(ROOT / "src")}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, who in enumerate(("other", "this", "this", "other")):
            out = Path(tmp) / f"{i}.pt"
            proc = subprocess.run([sys.executable, __file__, "--worker",
                                   srcs[who], str(out)], cwd=ROOT)
            if proc.returncode:
                print(f"kernel_ab: run {i} ({who}) failed", file=sys.stderr)
                return 1
            runs.append((who, torch.load(out)))
    report = {"order": [w for w, _ in runs], "times": {}, "bitwise": {}}
    for name in runs[0][1]["times"]:
        report["times"][name] = [r["times"][name] for _, r in runs]
        print(f"{name}: " + ", ".join(
            f"{who} {r['times'][name]:.4f}" for who, r in runs)
            + (" us" if name.endswith("device_us") else " ms"))
    for name, ref in runs[0][1]["outputs"].items():
        same = torch.equal(ref, runs[1][1]["outputs"][name])
        report["bitwise"][name] = same
        print(f"{name}: this == other bit for bit: {same}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report["card"] = smi
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
