"""repro_torch.obs — structured tracing (own copy of ``repro.obs.trace``).

With no active recorder every hook is a single ``is None`` check.
"""
from .trace import TraceEvent, TraceRecorder, current_recorder, span

__all__ = ["TraceEvent", "TraceRecorder", "current_recorder", "span"]
