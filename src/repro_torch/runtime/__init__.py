"""repro_torch.runtime — the straggler cluster runtime of the port.

  * ``engine``     — discrete-event cluster simulator (host numpy, bit for
                     bit the reference's): delay sampling, active-set
                     policies, barrier wall-clock accounting;
  * ``faults``     — crash / blackout / zone / corruption injection and the
                     sub-k degrade policies;
  * ``runners``    — the device loops of encoded GD, ISTA and BCD and of
                     async stale-gradient SGD, single and batched over
                     realizations;
  * ``strategies`` — ``coded-gd``, ``coded-prox``, ``coded-lbfgs``,
                     ``coded-bcd``, ``uncoded``, ``replication`` and
                     ``async`` behind one ``Strategy`` registry;
  * ``compare``    — the strategy x delay-model CLI, a thin front-end over
                     ``repro_torch.experiments``.
"""
from .engine import (DELAY_MODELS, POLICIES, ActiveSetPolicy, AdaptiveK,
                     AdversarialRotation, AsyncBatch, AsyncTrace,
                     ClusterEngine, Deadline, FastestK, IterationEvent,
                     Schedule, ScheduleBatch, make_delay_model, make_policy)
from .faults import (FAULT_KINDS, BlackoutFault, CorruptionFault, CrashFault,
                     DegradePolicy, FaultEvent, FaultModel, ZoneFault,
                     make_degrade, make_fault_model)
from .runners import (batched_scan_async, batched_scan_bcd, batched_scan_gd,
                      batched_scan_prox, scan_async, scan_bcd, scan_gd,
                      scan_prox, sharded_scan_async, sharded_scan_gd,
                      sharded_scan_prox, trials_device_count)
from .strategies import (ProblemSpec, RunResult, Strategy, TrialsResult,
                         available_strategies, check_trials, get_strategy,
                         register_strategy, resolve_eval_every,
                         summary_stats)

__all__ = [
    "DELAY_MODELS", "POLICIES", "ActiveSetPolicy", "AdaptiveK",
    "AdversarialRotation", "AsyncBatch", "AsyncTrace", "ClusterEngine",
    "Deadline", "FastestK", "IterationEvent", "Schedule", "ScheduleBatch",
    "make_delay_model", "make_policy", "scan_gd", "scan_prox", "scan_bcd",
    "scan_async", "batched_scan_gd", "batched_scan_prox", "batched_scan_bcd",
    "batched_scan_async", "sharded_scan_gd", "sharded_scan_prox",
    "sharded_scan_async", "trials_device_count", "ProblemSpec", "RunResult",
    "Strategy", "TrialsResult", "available_strategies", "check_trials",
    "get_strategy", "register_strategy", "resolve_eval_every",
    "summary_stats", "run_matrix",
    "FAULT_KINDS", "BlackoutFault", "CorruptionFault", "CrashFault",
    "DegradePolicy", "FaultEvent", "FaultModel", "ZoneFault", "make_degrade",
    "make_fault_model",
]


def __getattr__(name):
    # Lazy: importing .compare eagerly would shadow `python -m
    # repro_torch.runtime.compare` (runpy warns about double import).
    if name == "run_matrix":
        from .compare import run_matrix
        return run_matrix
    raise AttributeError(name)
