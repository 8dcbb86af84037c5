"""Shared plan/op cache manager: cross-query reuse + telemetry.

The reference's ``repro.service.cache`` on the port. The two host-side
LRUs in front of execution -- the optimized-plan cache
(``repro_torch.plan.executor._PLAN_CACHE``) and the op cache
(``repro_torch.core.api._OP_CACHE``) -- are process-wide by design: their
keys are structural (plan shape, schemas, worker count and device, kernel
routing), so two *different* queries running the *same* pipeline shape
share one optimizer pass and one composed callable. That reuse is what a
multi-query service wants, and with ``_LRUCache`` thread-safe and
counter-instrumented it is also safe and observable under concurrency.

``CacheManager`` is the service's window onto those caches: cumulative
stats, a marked baseline at service construction, and per-window deltas so
``service.stats()`` can report hit/miss/eviction counts attributable to
*this* service's queries rather than the whole process history.
"""

from __future__ import annotations

from ..plan import executor as _executor

__all__ = ["CacheManager"]


def _diff(now: dict, base: dict) -> dict:
    out = {}
    for name in ("hits", "misses", "evictions"):
        out[name] = now[name] - base.get(name, 0)
    out["size"] = now["size"]
    out["maxsize"] = now["maxsize"]
    return out


class CacheManager:
    """Snapshot/delta view over the shared plan + op caches.

    ``mark()`` re-baselines the window (called at service construction);
    ``stats()`` returns both cumulative process-wide counters and the
    since-mark delta. ``hit_rate(kind)`` is the windowed hit fraction
    (``None`` before any lookup).
    """

    def __init__(self):
        self._base = _executor.cache_stats()

    def mark(self) -> None:
        """Re-baseline the telemetry window to 'now'."""
        self._base = _executor.cache_stats()

    def stats(self) -> dict:
        """``{"plan": {...}, "op": {...}}``, each with cumulative counters
        plus a ``"window"`` sub-dict of since-mark deltas."""
        now = _executor.cache_stats()
        out = {}
        for kind in ("plan", "op"):
            entry = dict(now[kind])
            entry["window"] = _diff(now[kind], self._base.get(kind, {}))
            out[kind] = entry
        return out

    def hit_rate(self, kind: str = "op") -> float | None:
        """Windowed hit fraction for ``kind`` ("plan" or "op"); ``None``
        when the window saw no lookups."""
        w = self.stats()[kind]["window"]
        total = w["hits"] + w["misses"]
        return (w["hits"] / total) if total else None
