"""Typed process metrics: counters and gauges.

The reference's ``repro.obs.metrics`` (host only), with the port's engine
snapshot.

One process-global registry (:func:`registry`) holds the engine's
counters: the streaming runner's ``info`` dict scalars (``batches``,
``retries:<site>``, ``checkpoints``, ``chunks_decoded``, ...), and — via
:func:`engine_snapshot` — the shared plan and op ``_LRUCache`` stats.

Sub-registries chain to a parent under a prefix: a streaming run creates
``MetricsRegistry(parent=registry(), prefix="stream.")`` so its local
counters are the single source of truth for that run *and* every
increment also lands in the process totals. :meth:`Counter.restore`
(reloading counters from a checkpoint snapshot on resume) deliberately
sets only the local value — the restored counts were earned by the
crashed process, so propagating them would double-count the work in this
process's totals.

All metric mutation is thread-safe (prefetch thread, service driver
thread); metrics are always on — unlike spans they are a handful of
locked integer bumps, not worth a disable path.
"""

from __future__ import annotations

import threading

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "engine_snapshot",
    "registry",
]


class Counter:
    """Monotonic counter. ``add`` propagates to the parent counter;
    ``restore`` does not (see the module docstring for why)."""

    __slots__ = ("name", "_value", "_lock", "_parent")

    def __init__(self, name: str, parent: "Counter | None" = None):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        self._parent = parent

    def add(self, n: int = 1) -> None:
        """Increment by ``n`` (thread-safe), propagating to the parent."""
        with self._lock:
            self._value += n
        if self._parent is not None:
            self._parent.add(n)

    def restore(self, value) -> None:
        """Set the local value *without* parent propagation — for reloading
        a checkpointed count on resume, where the restored work was done
        (and already counted) by the previous process."""
        with self._lock:
            self._value = value

    @property
    def value(self):
        """The current count."""
        with self._lock:
            return self._value


class Gauge:
    """Last-value gauge with a high-water mark (:meth:`max` for peaks)."""

    __slots__ = ("name", "_value", "_hwm", "_lock", "_parent")

    def __init__(self, name: str, parent: "Gauge | None" = None):
        self.name = name
        self._value = None
        self._hwm = None
        self._lock = threading.Lock()
        self._parent = parent

    def set(self, v) -> None:
        """Set the current value (the high-water mark keeps the max)."""
        with self._lock:
            self._value = v
            self._hwm = v if self._hwm is None else max(self._hwm, v)
        if self._parent is not None:
            self._parent.set(v)

    def max(self, v) -> None:
        """Raise the gauge to ``v`` only if higher — peak tracking."""
        with self._lock:
            if self._value is None or v > self._value:
                self._value = v
                self._hwm = v if self._hwm is None else max(self._hwm, v)
        if self._parent is not None:
            self._parent.max(v)

    def restore(self, v) -> None:
        """Set the local value *without* parent propagation — the gauge
        analogue of :meth:`Counter.restore` for checkpoint resume."""
        with self._lock:
            self._value = v
            self._hwm = v if self._hwm is None else max(self._hwm, v)

    @property
    def value(self):
        """The current value (None if never set)."""
        with self._lock:
            return self._value

    @property
    def hwm(self):
        """The high-water mark (None if never set)."""
        with self._lock:
            return self._hwm


class MetricsRegistry:
    """Get-or-create named metrics, optionally chained to a parent.

    ``MetricsRegistry(parent=registry(), prefix="stream.")`` makes every
    local metric mirror into the parent under the prefixed name on each
    increment (but not on :meth:`Counter.restore`)."""

    def __init__(self, parent: "MetricsRegistry | None" = None,
                 prefix: str = ""):
        self._parent = parent
        self._prefix = prefix
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                up = None
                if self._parent is not None:
                    up = self._parent._get(self._prefix + name, cls)
                m = self._metrics[name] = cls(name, up)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        """Get or create the named :class:`Counter`."""
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """Get or create the named :class:`Gauge`."""
        return self._get(name, Gauge)

    def counters(self) -> dict:
        """``{name: value}`` for every counter in this registry."""
        with self._lock:
            items = list(self._metrics.items())
        return {n: m.value for n, m in items if isinstance(m, Counter)}

    def scalars(self) -> dict:
        """``{name: value}`` for every counter and every set gauge."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for n, m in items:
            if isinstance(m, Counter):
                out[n] = m.value
            elif isinstance(m, Gauge) and m.value is not None:
                out[n] = m.value
        return out

    def snapshot(self) -> dict:
        """Full view: every counter's and gauge's value by name."""
        with self._lock:
            items = list(self._metrics.items())
        return {n: m.value for n, m in items}

    def reset(self) -> None:
        """Drop every metric in this registry (parents are untouched)."""
        with self._lock:
            self._metrics.clear()


_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry — parent of every per-run registry."""
    return _GLOBAL


def engine_snapshot() -> dict:
    """One unified engine-telemetry view: the global registry's metrics,
    the shared plan and op cache stats
    (``repro_torch.plan.executor.cache_stats``), and the kernel backend."""
    from ..kernels import registry as _kernels
    from ..plan import executor as _executor

    return {"metrics": _GLOBAL.snapshot(),
            "caches": _executor.cache_stats(),
            "kernel_backend": _kernels.get_backend()}
