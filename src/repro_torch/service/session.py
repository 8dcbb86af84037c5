"""Per-query lifecycle state for the concurrent query service.

A copy of the reference's ``repro.service.session`` (host only). Every
query submitted to :class:`~repro_torch.service.QueryService` gets a
:class:`QuerySession`: a unique query id, a lifecycle state machine

    PENDING -> ADMITTED -> RUNNING -> DONE | FAILED | CANCELLED

(PENDING and ADMITTED may also jump straight to FAILED/CANCELLED — an
admission shed or a cancel before the first morsel), a result future the
submitting thread blocks on (:meth:`QuerySession.result`), and a
cooperative cancellation flag the morsel scheduler checks between quanta.

The :class:`SessionManager` is the service's registry: it mints ids,
tracks every session, and snapshots per-state counts for
``QueryService.stats()``. All state transitions run under the session's
lock and are validated against the state machine — an illegal transition
is a bug in the service, not a user error, and raises ``RuntimeError``.
"""

from __future__ import annotations

import threading
import time
import uuid

__all__ = [
    "QueryState",
    "QueryCancelled",
    "QuerySession",
    "SessionManager",
]


class QueryState:
    """Lifecycle states of a query session (string constants).

    ``PENDING`` — submitted, waiting in the admission backlog;
    ``ADMITTED`` — holds an admission slot, queued for the scheduler;
    ``RUNNING`` — at least one morsel executed;
    ``DONE`` / ``FAILED`` / ``CANCELLED`` — terminal.
    """

    PENDING = "PENDING"
    ADMITTED = "ADMITTED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    ALL = (PENDING, ADMITTED, RUNNING, DONE, FAILED, CANCELLED)
    TERMINAL = (DONE, FAILED, CANCELLED)


_TRANSITIONS = {
    QueryState.PENDING: {QueryState.ADMITTED, QueryState.FAILED,
                         QueryState.CANCELLED},
    QueryState.ADMITTED: {QueryState.RUNNING, QueryState.FAILED,
                          QueryState.CANCELLED},
    QueryState.RUNNING: {QueryState.DONE, QueryState.FAILED,
                         QueryState.CANCELLED},
    QueryState.DONE: set(),
    QueryState.FAILED: set(),
    QueryState.CANCELLED: set(),
}


class QueryCancelled(Exception):
    """Raised by :meth:`QuerySession.result` when the query was cancelled
    (by :meth:`QuerySession.cancel` or a cancelling service shutdown)
    before producing a result."""


class QuerySession:
    """Handle + lifecycle state for one submitted query.

    The submitting thread keeps this handle: :meth:`result` blocks until
    the scheduler finishes the query (returning the result DDF, or raising
    the query's error / :class:`QueryCancelled`); :meth:`cancel` requests
    cooperative cancellation — the scheduler stops the query at the next
    morsel boundary, so one in-flight morsel may still complete.

    Attributes populated by the service/scheduler: ``morsels`` (quanta
    executed), ``device_s`` (measured seconds inside this query's morsels,
    each ending in a wait for the query's device, so on the card they
    include its card time), ``cost_bytes`` (admission estimate), ``info`` (the runner's
    folded counters, for streaming queries).
    """

    def __init__(self, qid: str, query, opts: dict, weight: float = 1.0,
                 label: str | None = None):
        self.qid = qid
        self.query = query
        self.opts = dict(opts)
        self.weight = float(weight)
        self.label = label or qid
        self.state = QueryState.PENDING
        self.cost_bytes = 0.0
        self.cost_base = 0.0  # pre-correction admission estimate
        self.admission_key: str | None = None  # plan-shape learning key
        self.morsels = 0
        self.device_s = 0.0
        self.info: dict = {}
        self.submitted_at = time.monotonic()
        # a service over a process group: the submission index that names
        # the query on every rank, and cancels that only record the request
        self.index: int | None = None
        self.grouped = False
        self.started_at: float | None = None
        self.finished_at: float | None = None
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    # -- state machine ---------------------------------------------------------
    def _transition(self, new: str) -> None:
        """Validated state transition (service-internal)."""
        with self._lock:
            if new not in _TRANSITIONS[self.state]:
                raise RuntimeError(
                    f"query {self.qid}: illegal transition "
                    f"{self.state} -> {new}")
            self.state = new

    def _finish(self, state: str, result=None, error=None,
                info: dict | None = None) -> None:
        """Terminal transition + future resolution (service-internal)."""
        self._transition(state)
        self._result = result
        self._error = error
        if info:
            self.info = dict(info)
        self.finished_at = time.monotonic()
        self._done.set()

    # -- public handle surface -------------------------------------------------
    def cancel(self) -> bool:
        """Request cooperative cancellation.

        A PENDING (backlogged) query is cancelled immediately; an admitted
        or running query stops at its next morsel boundary (the scheduler
        closes its step generator, unwinding spill/prefetch state).
        Returns False when the query already reached a terminal state.

        In a service over a process group the request is only recorded:
        rank 0's scheduler decides where the query stops, the same on every
        rank (a PENDING query too).
        """
        with self._lock:
            if self.state in QueryState.TERMINAL:
                return False
            self._cancel.set()
            if self.state == QueryState.PENDING and not self.grouped:
                # not yet handed to the scheduler: resolve here; the
                # admission backlog drops finished sessions lazily
                self.state = QueryState.CANCELLED
                self.finished_at = time.monotonic()
                self._done.set()
            return True

    def cancel_requested(self) -> bool:
        """True once :meth:`cancel` has been called (scheduler checkpoint)."""
        return self._cancel.is_set()

    def done(self) -> bool:
        """True once the session reached a terminal state."""
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        """Block until the query finishes; return its result DDF.

        Raises the query's error for FAILED sessions,
        :class:`QueryCancelled` for cancelled ones, and ``TimeoutError``
        when ``timeout`` (seconds) elapses first.
        """
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.qid} still {self.state} after {timeout}s")
        if self.state == QueryState.CANCELLED:
            raise QueryCancelled(f"query {self.qid} was cancelled")
        if self._error is not None:
            raise self._error
        return self._result

    def describe(self) -> dict:
        """JSON-able snapshot of this session for ``service.stats()``."""
        wall = ((self.finished_at or time.monotonic())
                - self.submitted_at)
        return {
            "qid": self.qid,
            "label": self.label,
            "state": self.state,
            "weight": self.weight,
            "morsels": self.morsels,
            "device_s": round(self.device_s, 6),
            "cost_bytes": float(self.cost_bytes),
            "wall_s": round(wall, 6),
        }

    def __repr__(self) -> str:
        return f"QuerySession({self.qid!r}, {self.state}, morsels={self.morsels})"


class SessionManager:
    """Registry of every session a service has seen.

    Mints unique query ids (monotonic sequence + uuid suffix, so ids are
    both orderable in logs and globally unique), keeps sessions for the
    service's lifetime (terminal sessions stay inspectable through
    ``stats()``), and serves per-state counts.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: dict[str, QuerySession] = {}
        self._seq = 0

    def create(self, query, opts: dict, weight: float = 1.0,
               label: str | None = None) -> QuerySession:
        """Mint a new PENDING session for ``query``."""
        with self._lock:
            self._seq += 1
            qid = f"q{self._seq:04d}-{uuid.uuid4().hex[:8]}"
            s = QuerySession(qid, query, opts, weight=weight, label=label)
            self._sessions[qid] = s
            return s

    def get(self, qid: str) -> QuerySession:
        """Look up a session by id (KeyError on unknown ids)."""
        with self._lock:
            return self._sessions[qid]

    def sessions(self) -> list:
        """All sessions, in submission order."""
        with self._lock:
            return list(self._sessions.values())

    def counts(self) -> dict:
        """``{state: count}`` over every session ever submitted."""
        out = {s: 0 for s in QueryState.ALL}
        for sess in self.sessions():
            out[sess.state] += 1
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)
