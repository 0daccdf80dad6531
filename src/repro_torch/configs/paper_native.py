"""The paper's ridge configuration (§5.1, Fig. 7) — the published
dimensions, regularization, worker count, fastest-k settings and delay
model the port's main path runs at.  Own copy of the reference's
``repro.configs.paper_native.PAPER_RIDGE`` (the port imports nothing of
``repro``)."""
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
