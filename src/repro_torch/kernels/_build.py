"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` into an object; the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library is named by a hash of the sources and flags and lives in
``kernels/build/`` (ignored by git), so an unchanged tree builds once.  A
failed build raises: nothing falls back to the plain PyTorch versions.

``launch`` calls a C entry with its operands' card current and that card's
current stream: the library's per-card caches key on ``cudaGetDevice``.
``launches`` counts, per kernel wrapper, the calls that launched a kernel
on the card (never the plain CPU path); ``chip_smoke.py`` clears it before
driving the main path and reads it after.  A CUDA graph capture takes its
counts back and each replay adds them (``repro_torch.graphs``).
``build_seconds`` and ``builds`` add up the library's loads, and
``capture_seconds`` and ``captures`` the graph captures
(``obs.timing.CompileWatch`` reads their differences across a region to
split build and capture time from run time).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["launches", "launch", "load_library",
           "library_path", "check", "stream_of", "operands_device",
           "build_seconds", "builds", "capture_seconds", "captures",
           "NVCC_FLAGS"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: collections.Counter = collections.Counter()
# host seconds of the library's loads in this process (the ``nvcc`` builds,
# the link and the load), and the loads that ran ``nvcc``
build_seconds = 0.0
builds = 0
# host seconds of the CUDA graph captures in this process (the runners'
# and the model zoo's loops), and their number (added by
# ``repro_torch.graphs``)
capture_seconds = 0.0
captures = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(is the CUDA toolkit installed?)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"librepro_kernels-{h.hexdigest()[:16]}.so"


def _compile(lib: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place atomically (concurrent builders each write their own temp dir).
    Returns the compilers' output (the ``-Xptxas -v`` register report)."""
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    (BUILD / (lib.stem + ".log")).write_text(log)
    return log


_SIGNATURES = {
    "repro_fwht": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "repro_fwht_strided": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "repro_fwht_cluster": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p],
    "repro_empty": [ctypes.c_void_p],
    "repro_srht_onepass": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_int, ctypes.c_void_p],
    "repro_srht_pruned": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "repro_srht_cluster": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "repro_srht_segments": [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
    "repro_fused_masked_gradient_wide": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "repro_fused_masked_gradient": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p],
    "repro_coded_combine": [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_int, ctypes.c_void_p],
    # the kernels' own shape choices, for the tests to hold against the
    # wrappers' Python versions
    "repro_fused_realization_tile": [ctypes.c_int],
    "repro_fused_wide_plan": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "repro_coded_combine_groups": [ctypes.c_int],
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global build_seconds, builds
    t0 = time.perf_counter()
    lib_path = library_path()
    built = not lib_path.exists()
    if built:
        _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_seconds += time.perf_counter() - t0
    builds += built
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel '{kernel}' failed to launch "
                           f"(cudaError {err})")


def operands_device(*tensors):
    """The one device the tensors lie on; tensors on two devices raise,
    naming both (a launch copies nothing)."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"kernel operands on {dev} and {t.device}: a "
                             f"launch takes the tensors of one card")
    return dev


def launch(kernel: str, entry, operands, *args) -> None:
    """Call the C entry ``entry(*args, stream)`` with the operands' card
    current, ``stream`` being that card's current stream, and raise if it
    returns an error.

    The library sizes its launches by the current card (``cudaGetDevice``:
    SM count, shared-memory opt-in, resident blocks), and PyTorch's device
    guards put the previous card back after every op: without the switch
    here a tensor on ``cuda:1`` would launch into card 1's stream with
    card 0's settings.  ``operands`` are every tensor the entry reads or
    writes; on two cards they raise (``operands_device``).
    """
    import torch
    dev = operands_device(*operands)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    # one runtime call where the card is current already (the usual case)
    prev = torch.cuda._exchange_device(index)
    try:
        check(entry(*args, stream_of(dev)), kernel)
    finally:
        if prev != index:
            torch.cuda._exchange_device(prev)


def stream_of(where) -> int:
    """PyTorch's current stream on the card of ``where`` (a tensor or a
    device; a CUDA device without an index is the current card), as a raw
    handle (read straight from the runtime where this build of PyTorch
    offers it, without making a Stream object)."""
    import torch
    dev = where if isinstance(where, torch.device) else where.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream
