"""Structured tracing: nestable spans with a process-wide recorder.

A copy of the reference's ``repro.obs.trace``. A span times one unit of
engine work on the host clock and nests per thread (each thread keeps its
own span stack; the recorder they append to is shared and lock-guarded).
The engine's spans: ``partition.hash`` / ``partition.range`` (destinations),
``shuffle`` with ``shuffle.buffers`` and the receive side's ``compact``
inside it, ``compact`` wherever rows are compacted, ``local.sort``,
``local.unique``, ``local.groupby``, ``local.join``, ``local.anti_join``,
``plan.build`` and ``plan.execute`` (the lazy executor), ``service.*`` and
``stream.*``.

While tracing is on, every :func:`span` is also a
``torch.profiler.record_function`` range of the same name, opened on entry
and closed on exit. A ``torch.profiler`` session running at the same time
therefore holds each span as a host range on its own clock, and links
each device operation to the host operation that launched it: the device
work launched inside a span's host range, not the span's host interval,
measures the card (the device range the profiler draws for a span covers
only work launched directly in it, not in the spans nested inside). Spans
never synchronize. The retroactive spans of :func:`complete`
(``service.query``, ``stream.stage``, ...) and :func:`instant` markers are
recorded here only: they close after the fact, so the profiler never sees
them.

Near-zero cost when disabled (the default): :func:`span` returns one
shared no-op handle, so the hot paths pay a single boolean check, no
per-call object allocation and no profiler call. Enable with
:func:`enable` / :func:`tracing`, or process-wide via the
``REPRO_TRACE=1`` environment variable.

Recorded spans export as Chrome/Perfetto ``trace_event`` JSON via
:meth:`Trace.to_chrome_trace` — load the saved file in
https://ui.perfetto.dev or ``chrome://tracing``.

Intervals that do not nest on a call stack (a streaming stage suspended
and resumed across service quanta, a query's whole lifetime closed from
the scheduler) are recorded retroactively with :func:`complete` from
explicit :func:`now` timestamps, so interleaved queries never corrupt a
thread's span stack.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

import torch

__all__ = [
    "Span",
    "Trace",
    "complete",
    "disable",
    "enable",
    "enabled",
    "get_trace",
    "instant",
    "mark",
    "now",
    "reset",
    "span",
    "summary",
    "tracing",
]

_EPOCH = time.perf_counter()
_PID = os.getpid()
# backstop against unbounded growth in long-lived traced processes; the
# drop count is surfaced on the Trace so truncation is never silent
_MAX_EVENTS = 1_000_000

_enabled = os.environ.get("REPRO_TRACE", "") not in ("", "0")
_lock = threading.Lock()
_events: list = []
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()


def now() -> float:
    """Seconds since the trace epoch (module import) — the spans' clock.

    Use with :func:`complete` to record intervals retroactively."""
    return time.perf_counter() - _EPOCH


def enabled() -> bool:
    """True when spans are currently being recorded."""
    return _enabled


def enable() -> None:
    """Start recording spans (process-global, all threads)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording spans; spans already recorded are kept."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop every recorded span (the enabled flag is unchanged)."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def mark() -> int:
    """Current recorded-span count; pass as ``since`` to :func:`get_trace`
    to scope a later snapshot to spans recorded after this point."""
    with _lock:
        return len(_events)


def _record(sp: "Span") -> None:
    global _dropped
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(sp)
        else:
            _dropped += 1


class Span:
    """One recorded (or in-flight) span: a name, a wall interval, attrs.

    Use via :func:`span` as a context manager; inside the ``with`` block,
    :meth:`set` (or mutating ``attrs`` directly) attaches data — e.g. the
    ``shuffle`` span's ``slots`` and ``rows``. While open, the span is
    also a ``torch.profiler.record_function`` range of its name."""

    __slots__ = ("sid", "parent", "name", "cat", "t0", "t1", "tid",
                 "thread", "attrs", "_range")

    def __init__(self, name: str, cat: str | None = None,
                 attrs: dict | None = None):
        self.sid = next(_ids)
        self.parent: int | None = None
        self.name = name
        self.cat = cat
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = 0
        self.thread = ""
        self.attrs = {} if attrs is None else attrs
        self._range = None

    def set(self, **attrs):
        """Attach attributes to this span; returns the span."""
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        """Recorded wall seconds (0.0 while still open)."""
        return max(self.t1 - self.t0, 0.0)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent = stack[-1].sid if stack else None
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread = t.name
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        self.t1 = now()
        self._range.__exit__(*exc)
        self._range = None
        stack = getattr(_tls, "stack", [])
        if stack and stack[-1] is self:
            stack.pop()
        else:
            # out-of-order exit (a generator holding an open span was
            # closed while a later span was live): drop self wherever it
            # sits so the rest of the stack stays consistent
            try:
                stack.remove(self)
            except ValueError:
                pass
        _record(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.3f}ms, "
                f"attrs={self.attrs!r})")


class _NullSpan:
    """Shared do-nothing span handle returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    @property
    def attrs(self):
        # a throwaway dict: mutations are discarded, callers need no guard
        return {}

    @property
    def duration_s(self):
        return 0.0


_NULL = _NullSpan()


def span(name: str, cat: str | None = None, **attrs):
    """Open a nestable span: ``with span("shuffle", bytes=nb): ...``.

    Returns the shared no-op handle while tracing is disabled, so callers
    on hot paths need no enabled-check of their own (when attribute
    *computation* is expensive, gate it on :func:`enabled`)."""
    if not _enabled:
        return _NULL
    return Span(name, cat, attrs)


def instant(name: str, **attrs) -> None:
    """Record a zero-duration marker event (no stack participation)."""
    if not _enabled:
        return
    sp = Span(name, "instant", attrs)
    t = threading.current_thread()
    sp.tid = t.ident or 0
    sp.thread = t.name
    sp.t0 = sp.t1 = now()
    _record(sp)


def complete(name: str, t0: float, t1: float | None = None, **attrs) -> None:
    """Record a span retroactively from explicit :func:`now` timestamps.

    For intervals that do not nest on a thread's call stack — a streaming
    stage whose generator is suspended/resumed between other queries'
    quanta, or a query's submit-to-finish lifetime closed by the service
    scheduler."""
    if not _enabled:
        return
    sp = Span(name, None, attrs)
    t = threading.current_thread()
    sp.tid = t.ident or 0
    sp.thread = t.name
    sp.t0 = float(t0)
    sp.t1 = now() if t1 is None else float(t1)
    _record(sp)


class _Tracing:
    """Context manager for :func:`tracing` (re-entrant, state-restoring)."""

    __slots__ = ("_prev",)

    def __enter__(self):
        self._prev = _enabled
        enable()
        return self

    def __exit__(self, *exc):
        if not self._prev:
            disable()
        return False


def tracing() -> _Tracing:
    """Enable tracing for a ``with`` block, restoring the prior state on
    exit (nesting inside an already-enabled region is a no-op)."""
    return _Tracing()


def _jsonable(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)  # numpy scalars
    if callable(item):
        try:
            return _jsonable(item())
        except (TypeError, ValueError):
            pass
    return repr(v)


class Trace:
    """An immutable snapshot of recorded spans (see :func:`get_trace`).

    ``spans`` is the tuple of :class:`Span` records; ``dropped`` counts
    spans lost to the recorder's size backstop (0 in normal runs)."""

    def __init__(self, spans, dropped: int = 0):
        self.spans = tuple(spans)
        self.dropped = int(dropped)

    def __len__(self):
        return len(self.spans)

    def to_chrome_trace(self) -> dict:
        """The trace as a Chrome/Perfetto ``trace_event`` JSON object.

        Returns the dict form (``{"traceEvents": [...]}`` with complete
        ``"X"`` events, microsecond timestamps, and thread-name metadata);
        ``json.dump`` it or use :meth:`save` to write a file Perfetto and
        ``chrome://tracing`` load directly."""
        events = []
        threads: dict[int, str] = {}
        for sp in self.spans:
            if sp.thread and sp.tid not in threads:
                threads[sp.tid] = sp.thread
        for tid, tname in threads.items():
            events.append({"name": "thread_name", "ph": "M", "pid": _PID,
                           "tid": tid, "args": {"name": tname}})
        for sp in self.spans:
            events.append({"name": sp.name,
                           "cat": sp.cat or "repro",
                           "ph": "X",
                           "ts": sp.t0 * 1e6,
                           "dur": sp.duration_s * 1e6,
                           "pid": _PID,
                           "tid": sp.tid,
                           "args": _jsonable(sp.attrs)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        """Write :meth:`to_chrome_trace` JSON to ``path``; returns it."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def summary(self) -> dict:
        """Aggregate by span name: ``{name: {"count", "total_s"}}``."""
        out: dict[str, dict] = {}
        for sp in self.spans:
            d = out.setdefault(sp.name, {"count": 0, "total_s": 0.0})
            d["count"] += 1
            d["total_s"] += sp.duration_s
        return out


def get_trace(since: int = 0) -> Trace:
    """Snapshot the recorder (spans from index ``since``; see :func:`mark`)."""
    with _lock:
        return Trace(_events[since:], _dropped)


def summary() -> dict:
    """Compact process-trace summary for telemetry surfaces (e.g.
    ``QueryService.stats()["trace"]``): enabled flag, span/drop counts,
    and per-name aggregates."""
    tr = get_trace()
    return {"enabled": _enabled, "spans": len(tr), "dropped": tr.dropped,
            "by_name": tr.summary()}
