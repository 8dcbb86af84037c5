"""Admission control: bound how much work shares the card at once.

The reference's ``repro.service.admission`` on the port, with the same
default budget, factor, learning bounds and EWMA. The service cannot let
every submitted query start immediately -- device memory is static (every
DDF/scan batch is a fixed-capacity padded table) and working sets add up.
Admission control enforces three bounds, in order:

1. **concurrency** — at most ``max_running`` queries hold admission slots;
2. **memory budget** — the sum of admitted queries' cost-model-estimated
   working sets (:func:`estimate_query_bytes`) stays under
   ``memory_budget_bytes``. A single query whose own estimate exceeds the
   whole budget is still admitted *alone* (otherwise it could never run);
   the budget throttles co-residency, it is not a hard per-query cap;
3. **backlog** — queries that don't fit wait in a FIFO backlog of at most
   ``max_backlog``; past that the service **sheds**: submission fails with
   :class:`AdmissionError` instead of queueing unboundedly (the overload
   behavior a front door needs — reject fast, don't collapse).

The memory estimate reuses the streaming cost model's framing: a scan-
bearing query's resident set is its cost-model-sized morsel (scan
``capacity * P`` rows at the manifest's ``row_bytes``) inflated by
``working_set_factor`` for shuffle buffers and operator intermediates
(matching ``cost_model.choose_batch_rows``), plus its in-memory source
tables; a scan-free query is its source tables inflated the same way.
Everything is computed from host-side metadata (capacities, schemas) — no
device sync on the submission path. As in the reference, a streaming
query's carry (groupby/unique state of ``carry_capacity`` slots per
worker, by default ``ceil(rows / P)``) is not part of the estimate: a
streamed groupby over many groups can peak far above it, which the
observed-peak correction below can raise by at most 8x.

The static estimate is also *corrected by observation*: streaming runs
report their measured peak working set (the runner's
``peak_working_set_bytes`` gauge, via ``repro_torch.obs``), and
:meth:`AdmissionController.observe` folds the observed-vs-estimated ratio
into an EWMA keyed by the query's plan shape (:func:`query_learn_key`).
Repeat submissions of the same shape are admitted against the corrected
estimate — the feedback loop that keeps the cost model honest at the
front door.
"""

from __future__ import annotations

import collections
import hashlib
import math
import threading

from ..plan.logical import Scan, plan_signature, walk
from .session import QuerySession, QueryState

__all__ = [
    "AdmissionError",
    "AdmissionController",
    "estimate_query_bytes",
    "query_learn_key",
]

#: default memory budget for co-resident queries (bytes), the reference's
DEFAULT_MEMORY_BUDGET = 256e6


class AdmissionError(RuntimeError):
    """Submission rejected: the admission backlog is full (shed-on-overflow)
    or the service is shutting down."""


def _ddf_row_bytes(columns) -> float:
    """Bytes per row of an in-memory DDF's schema (columns are (P,
    capacity, ...) tensors)."""
    total = 0.0
    for v in columns.values():
        total += v.element_size() * math.prod(v.shape[2:])
    return max(total, 1.0)


def estimate_query_bytes(query, working_set_factor: float = 4.0) -> float:
    """Cost-model working-set estimate for one query, in bytes.

    ``query`` is a ``LazyDDF`` (scan-bearing or not) or a callable (an
    opaque eager thunk — charged 0, it brings its own already-resident
    tables). Scan leaves contribute one morsel's padded device table
    (``capacity * P * row_bytes``) times ``working_set_factor``; when the
    dataset manifest carries per-chunk sketches (``repro_torch.stats``), the
    morsel guess is tightened by the selectivity-adjusted row estimate —
    a tiny highly-selective scan no longer reserves a full morsel's
    worth of budget. ``Source`` leaves contribute their full padded
    capacity times the same factor (shuffle outputs/intermediates scale
    with input size). Duplicate sids are counted once.
    """
    if not hasattr(query, "_root"):
        return 0.0  # eager thunks (and anything else the scheduler vets)
    P = query._ctx.nworkers
    total = 0.0
    seen: set = set()
    for n in walk(query._root):
        if isinstance(n, Scan) and n.sid not in seen:
            seen.add(n.sid)
            man = query._scans[n.sid]
            rows = float(n.capacity * P)
            from ..stats import scan_row_estimate  # avoid import cycle
            est = scan_row_estimate(man, n)
            if est is not None:
                rows = min(rows, max(float(est), 1.0))
            total += rows * man.row_bytes()
    for sid, ddf in query._sources.items():
        if sid in seen:
            continue
        seen.add(sid)
        total += ddf.capacity * P * _ddf_row_bytes(ddf.columns)
    return total * max(working_set_factor, 1.0)


def query_learn_key(query) -> str | None:
    """Identity under which observed working-set peaks are learned: the
    plan's process-stable shape (``plan_signature``) plus the worker
    count. Queries with the same shape and worker count have the same static
    buffer sizing, so one query's measured peak predicts the next's.
    Opaque eager thunks have no plan to key on — None, no learning."""
    if not hasattr(query, "_root"):
        return None
    h = hashlib.sha256()
    h.update(plan_signature(query._root).encode())
    h.update(f"P={query._ctx.nworkers}".encode())
    return h.hexdigest()


#: clamp on the learned estimate-correction ratio — one wild measurement
#: (or a tiny probe run of a shape) cannot swing admissions unboundedly
_RATIO_BOUNDS = (0.125, 8.0)

#: EWMA weight of the newest observation when updating a learned ratio
_EWMA_WEIGHT = 0.5


class AdmissionController:
    """Slot + budget accounting and the FIFO backlog.

    Thread-safe; the service calls :meth:`offer` at submission time and
    :meth:`release` when a query reaches a terminal state (the scheduler's
    finish callback). ``release`` returns the backlogged sessions that now
    fit, in FIFO order — the service hands those to the scheduler.
    """

    def __init__(self, max_running: int = 4, max_backlog: int = 32,
                 memory_budget_bytes: float = DEFAULT_MEMORY_BUDGET,
                 working_set_factor: float = 4.0):
        self.max_running = max(int(max_running), 1)
        self.max_backlog = max(int(max_backlog), 0)
        self.memory_budget_bytes = float(memory_budget_bytes)
        self.working_set_factor = float(working_set_factor)
        self._lock = threading.Lock()
        self._running: dict[str, float] = {}  # qid -> cost bytes
        self._backlog: collections.deque[QuerySession] = collections.deque()
        # learned correction ratios: query_learn_key -> EWMA of
        # observed peak working set / static cost-model estimate
        self._learned: dict[str, float] = {}
        self.admitted_total = 0
        self.rejected_total = 0
        self.queued_total = 0
        self.observed_total = 0

    # -- internals -------------------------------------------------------------
    def _fits(self, cost: float) -> bool:
        if len(self._running) >= self.max_running:
            return False
        if not self._running:
            return True  # a lone over-budget query must still run
        return sum(self._running.values()) + cost <= self.memory_budget_bytes

    def _admit(self, session: QuerySession) -> None:
        self._running[session.qid] = session.cost_bytes
        self.admitted_total += 1
        session._transition(QueryState.ADMITTED)

    # -- service surface -------------------------------------------------------
    def offer(self, session: QuerySession) -> str:
        """Place a PENDING session: returns ``"admitted"`` or ``"queued"``.

        Estimates the session's cost (stored on ``session.cost_bytes``),
        admits it when it fits, otherwise backlogs it FIFO. A full backlog
        sheds: the session is failed with :class:`AdmissionError` and the
        same error is raised to the submitter.
        """
        if not session.cost_bytes:
            session.cost_base = estimate_query_bytes(
                session.query, self.working_set_factor)
            session.admission_key = query_learn_key(session.query)
            session.cost_bytes = session.cost_base
        with self._lock:
            ratio = (self._learned.get(session.admission_key)
                     if session.admission_key else None)
            if ratio is not None and session.cost_base:
                session.cost_bytes = session.cost_base * ratio
            if self._fits(session.cost_bytes) and not self._backlog:
                self._admit(session)
                return "admitted"
            if len(self._backlog) >= self.max_backlog:
                self.rejected_total += 1
                err = AdmissionError(
                    f"query {session.qid} rejected: admission backlog full "
                    f"({len(self._backlog)}/{self.max_backlog} queued, "
                    f"{len(self._running)}/{self.max_running} running, "
                    f"{sum(self._running.values()):.0f}/"
                    f"{self.memory_budget_bytes:.0f} budget bytes in use)")
                session._finish(QueryState.FAILED, error=err)
                raise err
            self._backlog.append(session)
            self.queued_total += 1
            return "queued"

    def release(self, session: QuerySession) -> list:
        """Free a finished query's slot; admit now-fitting backlog heads.

        Cancelled-while-pending sessions are dropped from the backlog here
        (lazily — ``QuerySession.cancel`` resolves their future without
        touching the deque). Returns newly admitted sessions, FIFO order.
        """
        with self._lock:
            self._running.pop(session.qid, None)
            admitted = []
            while self._backlog:
                head = self._backlog[0]
                if head.state in QueryState.TERMINAL:
                    self._backlog.popleft()  # cancelled while queued
                    continue
                if not self._fits(head.cost_bytes):
                    break
                self._backlog.popleft()
                self._admit(head)
                admitted.append(head)
            return admitted

    def observe(self, session: QuerySession) -> None:
        """Close the estimate-vs-reality loop for one finished query.

        Streaming runs measure their actual peak working set (the
        ``peak_working_set_bytes`` gauge in the runner's info); the ratio
        of that observed peak (re-inflated by ``working_set_factor``, the
        same headroom the static estimate carries for unmeasured shuffle
        intermediates) to the query's *base* estimate becomes an EWMA-
        learned correction for the query's plan shape. The next submission
        of the same shape is admitted against the corrected estimate —
        systematically over-estimated shapes stop hogging budget,
        under-estimated ones stop over-committing the card. Ratios are
        clamped to ``_RATIO_BOUNDS``; queries without a learn key or a
        measured peak (eager thunks, failed runs) teach nothing."""
        key = getattr(session, "admission_key", None)
        base = getattr(session, "cost_base", 0.0)
        peak = (session.info or {}).get("peak_working_set_bytes")
        if not key or not base or not peak:
            return
        lo, hi = _RATIO_BOUNDS
        obs = min(max(float(peak) * self.working_set_factor / base, lo), hi)
        with self._lock:
            prev = self._learned.get(key)
            self._learned[key] = (obs if prev is None else
                                  (1.0 - _EWMA_WEIGHT) * prev
                                  + _EWMA_WEIGHT * obs)
            self.observed_total += 1

    def learned_ratio(self, query) -> float | None:
        """The current correction ratio for ``query``'s plan shape (None
        when nothing has been learned yet)."""
        key = query_learn_key(query)
        with self._lock:
            return self._learned.get(key) if key else None

    def backlog_depth(self) -> int:
        """Current number of queued (not yet admitted) sessions."""
        with self._lock:
            return sum(1 for s in self._backlog
                       if s.state not in QueryState.TERMINAL)

    def stats(self) -> dict:
        """Telemetry snapshot for ``service.stats()``."""
        with self._lock:
            return {
                "max_running": self.max_running,
                "max_backlog": self.max_backlog,
                "memory_budget_bytes": self.memory_budget_bytes,
                "running": len(self._running),
                "in_use_bytes": float(sum(self._running.values())),
                "backlog": sum(1 for s in self._backlog
                               if s.state not in QueryState.TERMINAL),
                "admitted_total": self.admitted_total,
                "queued_total": self.queued_total,
                "rejected_total": self.rejected_total,
                "learned_keys": len(self._learned),
                "observed_total": self.observed_total,
            }
