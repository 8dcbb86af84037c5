"""Observability: tracing spans and the engine snapshot.

:mod:`trace` is a host-only copy of the reference's ``repro.obs.trace``: it
records nestable, thread-safe spans (near-zero cost while disabled) with
Chrome/Perfetto export. The lazy executor opens its ``plan.execute`` span
through it. :mod:`metrics` holds only :func:`engine_snapshot` (the cache
stats and the kernel backend); the reference's metrics registry arrives
with its first producer. The cost-model check (``model_check``) and with it
``profiled`` wait for the H100's local-cost constants (ROADMAP queue A
item 4).
"""

from __future__ import annotations

from . import metrics, trace
from .metrics import engine_snapshot
from .trace import Trace, get_trace, span, tracing

__all__ = [
    "Trace",
    "engine_snapshot",
    "get_trace",
    "metrics",
    "span",
    "trace",
    "tracing",
]
