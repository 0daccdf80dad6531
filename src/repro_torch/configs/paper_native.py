"""The paper's own experiment configurations (§5) — the four problems it
evaluates on EC2, with the published dimensions, regularization, worker
counts, fastest-k settings, delay models and schemes.  ``PAPER_RIDGE`` is
the size the port's main path runs at; the workloads' ``paper`` presets
read all four.  Own copy of the reference's
``repro.configs.paper_native`` (the port imports nothing of ``repro``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class QuadraticProblemConfig:
    name: str
    n: int                    # samples (rows of X)
    p: int                    # features
    m: int                    # workers
    k: Tuple[int, ...]        # fastest-k settings evaluated
    lam: float
    beta: float = 2.0
    regularizer: str = "l2"   # l2 | l1 | none
    algorithm: str = "lbfgs"  # gd | lbfgs | prox | bcd
    encoders: Tuple[str, ...] = ("uncoded", "replication", "hadamard")
    delay_model: str = "bimodal"
    instance_note: str = ""


PAPER_RIDGE = QuadraticProblemConfig(
    name="ridge_s5_1", n=4096, p=6000, m=32, k=(12, 24, 32), lam=0.05,
    algorithm="lbfgs", encoders=("uncoded", "replication", "hadamard"),
    delay_model="bimodal",
    instance_note="EC2: 32x m1.small workers + c3.8xlarge master (Fig 7)")

PAPER_MF = QuadraticProblemConfig(
    name="matrix_factorization_s5_2", n=1_000_000, p=15, m=24, k=(3, 12, 24),
    lam=10.0, algorithm="lbfgs",
    encoders=("uncoded", "replication", "gaussian", "paley", "hadamard"),
    delay_model="exponential",
    instance_note="MovieLens-1M, p=15 embedding, b=3, ALS (Tables 2-3)")

PAPER_LOGISTIC = QuadraticProblemConfig(
    name="logistic_s5_3", n=597_641, p=32_500, m=128, k=(64, 80, 128),
    lam=1e-5, regularizer="l2", algorithm="bcd",
    encoders=("uncoded", "replication", "steiner", "haar"),
    delay_model="bimodal",
    instance_note="rcv1.binary; 128x t2.medium + c3.4xlarge (Figs 10-13); "
                  "second delay model: power-law background tasks")

PAPER_LASSO = QuadraticProblemConfig(
    name="lasso_s5_4", n=130_000, p=100_000, m=128, k=(80, 128), lam=0.6,
    regularizer="l1", algorithm="prox",
    encoders=("uncoded", "replication", "steiner"),
    delay_model="multimodal",
    instance_note="7695-sparse ground truth, sigma=40 noise, F1 metric "
                  "(Fig 14)")

PAPER_PROBLEMS = {c.name: c for c in
                  [PAPER_RIDGE, PAPER_MF, PAPER_LOGISTIC, PAPER_LASSO]}
