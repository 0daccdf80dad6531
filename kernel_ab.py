#!/usr/bin/env python3
"""Hold this checkout's kernels against another checkout's (for example
the parent commit, unpacked with ``git archive`` into a git-ignored
directory) on one NVIDIA card:

    python3 kernel_ab.py OTHER_CHECKOUT [NAME_PART]

(NAME_PART runs only the cases whose name holds it, e.g. "fwht".)  Each
checkout runs in its own process (each builds its own kernels), in
the order other, this, this, other, on the same inputs, made on the card
from seed 0: at the PAPER_RIDGE shapes the fused gradient at (32, 256,
6000) single and batched at R = 4 and R = 16 (24 of 32 workers a
realization), the combine at (32, 6000) and (32, 4194304), the FWHT of
decode_t's (6001, 8192) and the SRHT of the (6001, 4096) data into
N = 8192, full frame and worker 5's rows [1280, 1536); at the wide path's
shapes (LASSO §5.4, n 32 768, N 65 536) the FWHT at (8, 65536) and
(2, 262144), and the SRHT of 64 columns, full frame and worker 5's rows
[2560, 3072), and of the path's 100 001 columns; past the cluster's 2^18
(the strided passes) the FWHT at (4, 2^19) and the SRHT of 8 columns of
300 000 into N = 2^19; and the fused gradient past p = 16 384 at the wide
path's width p = 100 000: (8, 512, 100000) single and batched at R = 4
(masks drawn at 0.7, worker 0 on), then the path's step, (128, 512,
100000) single with 80 of 128 workers active (26.2 GB of S X, made after
the other cases' inputs are freed).  The SRHT's signed slot map, where
the checkout's wrapper takes one, is built before the cases.  It prints
each case's time in every run (CUDA events, mean over back-to-back calls
after warm-up; the combine at (32, 6000) also the profiler's device time
a call; the FWHT and SRHT cases that the host's launch path paces also
the card's own time a call, by CUDA graph replay, as "device_ms") and
whether the two checkouts' outputs are equal bit for bit (else their
largest difference over the other's largest magnitude; the 100 001-column
encode is compared on every 1000th column), then the same as one JSON
line.  The wide fused cases must agree to rel 1e-4 (two checkouts may
sum a row's dot products in another order).  Exits 2 without a card, 1 if
a run fails or a wide fused case disagrees.
"""
from __future__ import annotations

import json
import math
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
    cases += _hadamard_cases(torch, np, dev, gen)
    return cases


def _hadamard_cases(torch, np, dev, gen):
    """The FWHT and SRHT cases: the main path's one-pass shapes and worker
    5's window, then the wide path's, then past the cluster's 2^18 (the
    strided passes).  Where the checkout's SRHT wrapper takes a signed slot
    map, it is built once beforehand, as an encoder's caller does."""
    import inspect

    from repro_torch.kernels import encode
    from repro_torch.kernels.fwht import fwht_kernel_call
    call = encode.srht_encode_call
    takes_map = "smap" in inspect.signature(call).parameters
    cases = []
    for rows, nf in ((P + 1, 2 * N), (8, 65536), (2, 262144), (4, 1 << 19)):
        x = torch.randn((rows, nf), device=dev, generator=gen)
        cases.append((f"fwht ({rows}, {nf})",
                      lambda x=x: fwht_kernel_call(x)))
    rng = np.random.default_rng(0)
    for n, NN, p, windows in ((N, 2 * N, P + 1, ((0, 2 * N), (1280, 1536))),
                              (32768, 65536, 64, ((0, 65536), (2560, 3072))),
                              (32768, 65536, 100001, ((0, 65536),)),
                              (300000, 1 << 19, 8, ((0, 1 << 19),))):
        cols = torch.as_tensor(rng.choice(NN, n, replace=False).astype(
            np.int32), device=dev)
        signs = torch.as_tensor(rng.choice([-1.0, 1.0], n).astype(
            np.float32), device=dev)
        extra = ({"smap": encode.srht_signed_slot_map(cols, signs, NN)}
                 if takes_map else {})
        xt = torch.randn((p, n), device=dev, generator=gen)
        for lo, hi in windows:
            kw = dict(N=NN, lo=lo, hi=hi, scale=1.0 / math.sqrt(n), **extra)
            cases.append((f"srht ({p}, {n}) -> [{lo}, {hi}) of {NN}",
                          lambda xt=xt, cols=cols, signs=signs, kw=kw:
                          call(xt, cols, signs, **kw)))
    return cases


WIDE_TOL = 1e-4                  # the wide fused cases, this vs other


def _wide_fused_cases(torch, np, dev):
    """The fused gradient at the wide path's width, p = 100 000 (LASSO
    §5.4 with n 32 768: r = 512 rows a worker): 8 workers single and
    batched at R = 4, then the path's 128 workers with 80 active."""
    from repro_torch.kernels.fused_step import fused_masked_gradient
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    m, r, p = 128, 512, 100000
    SX = torch.randn((m, r, p), device=dev, generator=gen)
    Sy = torch.randn((m, r), device=dev, generator=gen)
    kw = dict(n=32768, beta=BETA)
    SX8, Sy8 = SX[:8], Sy[:8].contiguous()
    W4 = torch.randn((4, p), device=dev, generator=gen) * 0.01
    masks4 = torch.as_tensor((rng.random((4, 8)) < 0.7).astype(np.float32),
                             device=dev)
    masks4[:, 0] = 1.0
    mask = torch.zeros(m, device=dev)
    mask[torch.as_tensor(rng.permutation(m)[:80], device=dev)] = 1.0
    w = torch.randn(p, device=dev, generator=gen) * 0.01
    return [
        ("fused wide (8, 512, 100000) single", lambda: fused_masked_gradient(
            SX8, Sy8, W4[0], masks4[0], **kw)),
        ("fused wide (8, 512, 100000) batched R=4",
         lambda: fused_masked_gradient(SX8, Sy8, W4, masks4, **kw)),
        ("fused wide (128, 512, 100000) single, 80 active",
         lambda: fused_masked_gradient(SX, Sy, w, mask, **kw)),
    ]


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


def _graph_ms(torch, fn, reps: int = 20, calls: int = 10) -> float:
    """The card's own time a call: ``calls`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events (the host's launch path
    taken out)."""
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


def worker(src: str, out: str, only: str) -> int:
    """Run every case whose name holds ``only`` with the package under
    ``src``; save the outputs and times to ``out`` (a torch file)."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    dev = torch.device("cuda")
    outputs, times = {}, {}
    # each group's inputs are freed before the next group's are made
    for group in (_cases, _wide_fused_cases):
        cases = group(torch, np, dev)
        for name, fn in cases:
            if only not in name:
                continue
            res = fn()
            # the 100 001-column encode's frame is 26 GB: every 1000th
            # column
            outputs[name] = (res[::1000] if res.shape[0] > 10**5
                             else res).cpu()
            del res
            reps = (3 if "100001" in name else
                    5 if "(128, 512, 100000)" in name else
                    20 if any(k in name for k in ("fused", "4194304",
                                                  "6001"))
                    else 200)
            times[name] = _time_ms(torch, fn, reps)
            if reps == 200 and name.startswith(("fwht", "srht")):
                # paced by the host's launch path: the card's own share
                times[name + " device_ms"] = _graph_ms(torch, fn)
            if name == f"combine (32, {P})":
                times[name + " device_us"] = _device_us(torch, fn, 50)
        del cases
        torch.cuda.empty_cache()
    torch.save({"outputs": outputs, "times": times}, out)
    return 0


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        return worker(sys.argv[2], sys.argv[3], sys.argv[4])
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 1
    only = sys.argv[2] if len(sys.argv) == 3 else ""
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
                                   srcs[who], str(out), only], cwd=ROOT)
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
    report["rel_diff"] = {}
    disagree = []
    for name, ref in runs[0][1]["outputs"].items():
        got = runs[1][1]["outputs"][name]
        same = torch.equal(ref, got)
        report["bitwise"][name] = same
        rel = float((got.float() - ref.float()).abs().max()
                    / ref.float().abs().max().clamp_min(1e-30))
        report["rel_diff"][name] = rel
        wide = name.startswith("fused wide")
        if wide and rel > WIDE_TOL:
            disagree.append(name)
        print(f"{name}: this == other bit for bit: {same}"
              + ("" if same else f" (max|this - other| = {rel:.3e} of "
                 f"max|other|)")
              + (f"; tol {WIDE_TOL:.0e}" if wide else ""))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report["card"] = smi
    print(smi)
    print(json.dumps(report))
    if disagree:
        print(f"kernel_ab: outputs disagree past rel {WIDE_TOL:.0e}: "
              f"{disagree}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
