"""repro_torch.workloads — the paper-§5 workload zoo on the port.

Port of ``repro.workloads``: each workload (ridge, LASSO, logistic, matrix
factorization) builds its dataset at ``smoke``/``bench``/``paper``
presets, lowers itself to the port's strategy layer, and scores itself
with its paper metric against a host ground-truth reference.

    from repro_torch.workloads import get_workload
    result = get_workload("ridge").run("coded", preset="smoke")  # on CUDA
    result = get_workload("ridge").run("coded", preset="smoke",
                                       device="cpu")

``run_workload_matrix`` and ``python -m repro_torch.workloads.run`` run a
workload x strategy matrix through ``repro_torch.experiments``.
"""
from .base import (Preset, UnsupportedStrategy, Workload, WorkloadRunResult,
                   available_workloads, get_workload, register_workload)
from . import ground_truth
# Importing the workload modules registers them.
from . import ridge, lasso, logistic, matrix_factorization  # noqa: F401

__all__ = [
    "Preset", "UnsupportedStrategy", "Workload", "WorkloadRunResult",
    "available_workloads", "get_workload", "register_workload",
    "ground_truth", "run_workload_matrix",
]


def __getattr__(name):
    # Lazy: importing .runner eagerly would shadow `python -m
    # repro_torch.workloads.run` (runpy warns about double import).
    if name == "run_workload_matrix":
        from .runner import run_workload_matrix
        return run_workload_matrix
    raise AttributeError(name)
