"""Legacy-facing trainer API, a thin adapter over ``train.coded`` (port of
``repro.train.trainer``).

``Trainer(cfg, tcfg, delay_model=...)`` keeps the historical signature: it
builds the engine and a fastest-k policy from the config and defers to
:class:`repro_torch.train.coded.CodedTrainer` (same ``run()`` return
shape; the history records carry the active / exact / compile-split
fields).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.straggler import DelayModel, constant_delays
from repro_torch.runtime.engine import ClusterEngine, FastestK

from .coded import CodedTrainer, TrainerConfig

__all__ = ["TrainerConfig", "Trainer"]


class Trainer(CodedTrainer):
    """Back-compat constructor: delay model in, engine-driven loop out."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 delay_model: Optional[DelayModel] = None, *, device=None):
        engine = ClusterEngine(delay_model or constant_delays(0.0),
                               tcfg.m_workers, compute_time=0.05,
                               seed=tcfg.seed)
        super().__init__(cfg, tcfg, engine, policy=FastestK(tcfg.wait_k),
                         device=device)
