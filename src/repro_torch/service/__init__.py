"""Concurrent query service: many lazy/streaming queries, one shared card.

The reference's ``repro.service`` on the port. Everything below this
package serves exactly one synchronous caller at a time; ``QueryService``
is the long-lived layer that turns the library into a system. It
multiplexes many simultaneous queries over one card by driving their
cost-model-sized morsels through a single scheduler thread:

- ``session``   — per-query lifecycle (PENDING -> ADMITTED -> RUNNING ->
  DONE/FAILED/CANCELLED), unique query ids, result futures, cooperative
  cancellation (:class:`QuerySession`, :class:`SessionManager`);
- ``scheduler`` — the async morsel scheduler interleaving step generators
  (``repro_torch.stream.StreamExecution``) from independent queries, with
  round-robin and deficit-weighted fair-queuing policies
  (:class:`MorselScheduler`);
- ``admission`` — cost-model-estimated memory budgets, bounded concurrent
  admissions, FIFO backlog with shed-on-overflow
  (:class:`AdmissionController`, :class:`AdmissionError`);
- ``cache``     — the shared plan/op cache manager with
  hit/miss/eviction telemetry (:class:`CacheManager`) — queries sharing a
  pipeline shape share one optimizer pass and one composed callable.

Typical use::

    from repro_torch.service import QueryService

    with QueryService(policy="fair", max_running=4) as svc:
        handles = [svc.submit(q) for q in queries]      # LazyDDFs
        results = [h.result() for h in handles]         # eager DDFs
        print(svc.stats())

Results are bit-identical to running each query's ``collect`` /
``collect_stream`` serially: one scheduler thread serializes device
dispatches, every query owns its runner state, and the shared caches are
keyed structurally. The service takes no device: each query runs on its
own context's (the card, unless the query was built on the CPU), and each
morsel ends in a wait for that device, so ``device_s`` is card time. The
reference's ``docs/SERVICE.md`` documents the ``stats()`` schema, which is
the same here.

Over a process group, ``QueryService(ctx=DDFContext(..., group=...))`` on
every rank, each rank submitting the same queries in the same order: rank
0's scheduler admits, orders and cancels for all of them
(:class:`~repro_torch.service.scheduler.GroupedScheduler`), so every rank
runs the same morsels and gets the same results. There a shed submission
fails its session (``result()`` raises :class:`AdmissionError`) on every
rank instead of raising from ``submit``, only rank 0's ``cancel`` requests
count, and the callers run no collective on the group while the service is
up (its thread sends them).
"""

from __future__ import annotations

import threading

from ..obs import trace as _trace
from .admission import AdmissionController, AdmissionError, estimate_query_bytes
from .cache import CacheManager
from .scheduler import POLICIES, GroupedScheduler, MorselScheduler
from .session import QueryCancelled, QuerySession, QueryState, SessionManager

__all__ = [
    "QueryService",
    "QuerySession",
    "QueryState",
    "QueryCancelled",
    "SessionManager",
    "MorselScheduler",
    "GroupedScheduler",
    "POLICIES",
    "AdmissionController",
    "AdmissionError",
    "estimate_query_bytes",
    "CacheManager",
]


class QueryService:
    """Long-lived front door multiplexing queries over one shared card.

    Args:
      policy: scheduling policy — ``"fair"`` (deficit-weighted fair
        queuing over measured morsel seconds, the default) or
        ``"round_robin"`` (one morsel per query per turn).
      max_running: concurrent admission slots (queries interleaving on the
        card at once).
      max_backlog: FIFO backlog depth past the admission slots; a full
        backlog sheds new submissions with :class:`AdmissionError`.
      memory_budget_bytes: cost-model working-set budget shared by the
        admitted queries (see :func:`estimate_query_bytes`).
      quantum_s: fair-queuing quantum — device seconds granted per
        scheduling turn per unit weight.
      ctx: a ``DDFContext`` with a process group: the service spans its
        ranks, every query must be over that group, and rank 0 decides
        (see the module's notes). None (or a context without a group): one
        process, today's scheduler.

    ``submit`` accepts a ``LazyDDF`` (scan-bearing plans run through the
    streaming engine morsel by morsel; scan-free plans are one-quantum
    dispatches) or a zero-argument callable (an opaque eager
    escape hatch). Streaming keyword options (``batch_rows``,
    ``checkpoint_dir``, ...) pass through to the runner.
    """

    def __init__(self, policy: str = "fair", max_running: int = 4,
                 max_backlog: int = 32,
                 memory_budget_bytes: float = 256e6,
                 quantum_s: float = 0.02, ctx=None):
        self.sessions = SessionManager()
        self.admission = AdmissionController(
            max_running=max_running, max_backlog=max_backlog,
            memory_budget_bytes=memory_budget_bytes)
        self.caches = CacheManager()
        self.group = ctx.group if ctx is not None else None
        if self.group is None:
            self.scheduler = MorselScheduler(policy=policy, quantum_s=quantum_s,
                                             on_finish=self._on_query_finished)
        else:
            self.scheduler = GroupedScheduler(ctx.workers, self.admission.offer,
                                              policy=policy, quantum_s=quantum_s,
                                              on_finish=self._on_query_finished)
        self._lock = threading.Lock()
        self._closed = False
        self.scheduler.start()

    # -- submission ------------------------------------------------------------
    def submit(self, query, weight: float = 1.0, label: str | None = None,
               **stream_opts) -> QuerySession:
        """Submit a query; returns its :class:`QuerySession` handle.

        The session is PENDING until admission control grants it a slot
        (immediately, or FIFO from the backlog as earlier queries finish).
        Raises :class:`AdmissionError` when the backlog is full
        (shed-on-overflow) or the service is shut down. ``weight`` scales
        the query's share under the ``"fair"`` policy; ``label`` names it
        in ``stats()``.
        """
        qctx = getattr(query, "_ctx", None)  # a LazyDDF's; a thunk has none
        if qctx is not None and qctx.group is not self.group:
            raise ValueError(
                "submit: the query's process group is not the service's; a query "
                "over a group needs QueryService(ctx=...) with that group's context")
        with self._lock:
            if self._closed:
                raise AdmissionError("service is shut down")
            session = self.sessions.create(query, stream_opts, weight=weight,
                                           label=label)
            if self.group is not None:  # rank 0's scheduler admits it
                self.scheduler.submit(session)
                return session
            verdict = self.admission.offer(session)
        if verdict == "admitted":
            self.scheduler.enqueue(session)
        return session

    def cancel(self, qid: str) -> bool:
        """Cancel a query by id (cooperative; see
        :meth:`QuerySession.cancel`). False if already terminal."""
        return self.sessions.get(qid).cancel()

    # -- scheduler callback ----------------------------------------------------
    def _on_query_finished(self, session: QuerySession) -> None:
        # learn from the finished query's measured peak working set before
        # releasing its slot (so a same-shape backlog head is re-costed
        # against the corrected estimate)
        self.admission.observe(session)
        for newly_admitted in self.admission.release(session):
            self.scheduler.enqueue(newly_admitted)

    # -- introspection ---------------------------------------------------------
    def stats(self) -> dict:
        """One consistent snapshot of the whole service.

        ``{"sessions": {state: count}, "queries": [per-session dicts],
        "scheduler": {...}, "admission": {...}, "caches": {"plan"/"op":
        cumulative + windowed hit/miss/eviction counts}, "trace":
        {"enabled", "spans", "dropped", "by_name"}}`` — the reference's
        schema (``docs/SERVICE.md``, tracing in ``docs/OBSERVABILITY.md``).
        """
        return {
            "sessions": self.sessions.counts(),
            "queries": [s.describe() for s in self.sessions.sessions()],
            "scheduler": self.scheduler.stats(),
            "admission": self.admission.stats(),
            "caches": self.caches.stats(),
            "trace": _trace.summary(),
        }

    # -- lifecycle -------------------------------------------------------------
    def shutdown(self, cancel: bool = False, timeout: float | None = None) -> None:
        """Stop the service: drain every submitted query (default) or
        cancel active + pending work (``cancel=True``). Idempotent; new
        submissions are shed from the moment shutdown begins."""
        with self._lock:
            self._closed = True
        self.scheduler.shutdown(cancel=cancel, timeout=timeout)

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # cancel on error exits, drain on clean ones
        self.shutdown(cancel=exc_type is not None)
