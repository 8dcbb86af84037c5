"""Engine telemetry: one snapshot of the port's host-side state.

The reference's ``repro.obs.metrics`` also holds a process-global registry
of counters, gauges and timings. No module of the port records a metric
yet, so the registry arrives with its first producer (streaming, the
service or the cost-model check; ROADMAP queue A). :func:`engine_snapshot`
reads what exists now: the plan and op cache stats and the kernel backend.
"""

from __future__ import annotations

__all__ = ["engine_snapshot"]


def engine_snapshot() -> dict:
    """The shared plan and op cache stats
    (``repro_torch.plan.executor.cache_stats``) and the kernel backend."""
    from ..kernels import registry as _kernels
    from ..plan import executor as _executor

    return {"caches": _executor.cache_stats(),
            "kernel_backend": _kernels.get_backend()}
