"""Async morsel scheduler: interleave many queries' morsels on one card.

The reference's ``repro.service.scheduler`` on the port. The streaming
runner sizes every morsel from the cost model precisely so a morsel can act
as a *scheduling quantum* — one scan batch through the one composed plan
callable. ``repro_torch.stream.StreamExecution`` exposes that
loop as an externally drivable step generator, and this scheduler drives
many of them concurrently: a single worker thread round-robins ``next()``
across the active queries' generators, so device programs from different
queries interleave at morsel granularity while each query's own morsel
order — and therefore its result, bit for bit — is exactly what a solo run
produces. (One scheduler thread, many queries: determinism per query comes
free, host-side decode still overlaps device work through each runner's
own prefetch thread, and the card never sees two competing dispatches.)

Scheduling policies:

- ``"round_robin"`` — one morsel per active query per turn. Simple, and
  perfectly fair in *morsel count*; queries with expensive morsels get a
  proportionally larger share of device time.
- ``"fair"`` — deficit-weighted fair queuing (deficit round robin over
  measured morsel wall seconds). Each turn a query's deficit grows by
  ``quantum_s * weight``; it runs morsels while its deficit covers the
  next morsel's estimated cost (the last measured one) and pays each
  morsel's measured cost from the deficit. Queries with cheap morsels
  batch several per turn; expensive-morsel queries yield the card after
  one — device *time* is shared in proportion to weight, not morsel count.

Scan-free lazy queries (and opaque eager thunks) are one-quantum queries:
their single dispatch is one "morsel".

The one difference from the reference: a morsel's time ends in a wait for
the query's device (:func:`repro_torch.plan.executor.sync`, the port's
``jax.block_until_ready``; nothing on the CPU). Launches on the card return
before the work is done, and a morsel that ends without a host read (a
scan-free lazy query, an eager thunk) would otherwise leave its card time
to be charged to whatever morsel runs next, of whatever query. With the
wait, ``device_s`` and the fair policy's cost estimate are each query's
own card time.

Lifecycle integration: the scheduler transitions sessions ADMITTED ->
RUNNING at their first morsel and resolves them to DONE/FAILED/CANCELLED;
a cancel request (``QuerySession.cancel``) is honored at the next morsel
boundary by closing the query's step generator (``GeneratorExit`` unwinds
the runner's ``finally`` blocks, releasing spill/prefetch state). The
``on_finish`` callback hands every terminal session back to the service,
which releases its admission slot and enqueues newly admitted work.

Over a process group (:class:`GroupedScheduler`) every rank must run the
same morsels in the same order, or the ranks block in each other's
collectives. There the order may depend on nothing one rank sees alone (a
clock, when a submission or a cancel arrived): rank 0's scheduler thread
alone decides, and before each step it sends every rank a record of its
decision, which the other ranks' threads follow.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from ..core.api import DDF
from ..obs import trace as _trace
from ..plan import executor as _executor
from ..plan.frame import LazyDDF
from ..stream.runner import StreamExecution
from .admission import AdmissionError
from .session import QueryCancelled, QuerySession, QueryState

__all__ = ["MorselScheduler", "GroupedScheduler", "POLICIES"]

#: supported scheduling policies
POLICIES = ("round_robin", "fair")

#: cap on accumulated deficit, in turns' worth of quantum — an idle-ish
#: query cannot bank unbounded credit and then monopolize the card
_DEFICIT_CAP_TURNS = 4.0


def _device_of(value):
    """The device an eager thunk's result lies on (None for host values)."""
    if isinstance(value, DDF):
        return value.ctx.device
    if isinstance(value, torch.Tensor):
        return value.device
    return None


def _steps_for(entry: "_Active"):
    """Build the step generator for a submitted query.

    Streaming (scan-bearing ``LazyDDF``) queries run through
    ``StreamExecution`` with the session's stream options; scan-free lazy
    queries and eager thunks become one-quantum generators. Every
    generator returns ``(result, info dict)``. Sets ``entry.device``: a
    lazy query's context's device, or once it has run, the device of an
    eager thunk's result.
    """
    session = entry.session
    q = session.query
    if isinstance(q, LazyDDF):
        entry.device = q._ctx.device
        if q._scans:
            ex = StreamExecution(q, **session.opts)

            def stream_steps():
                yield from ex.steps()
                return ex.result, ex.info

            return stream_steps()
        if session.opts:
            raise ValueError(
                f"query {session.qid}: stream options "
                f"{sorted(session.opts)} only apply to scan-bearing "
                "(streaming) queries")

        def lazy_steps():
            out = q.collect()
            yield "device"
            return out, dict(q.last_info or {})

        return lazy_steps()
    if isinstance(q, DDF):
        raise TypeError(
            "submit() takes a LazyDDF (use .lazy() on an eager DDF) or a "
            "zero-argument callable, not a materialized DDF")
    if callable(q):
        def eager_steps():
            out = q()
            entry.device = _device_of(out)
            yield "eager"
            return out, {}

        return eager_steps()
    raise TypeError(f"unsupported query type {type(q).__name__}")


class _Active:
    """Scheduler-internal per-query run state."""

    __slots__ = ("session", "gen", "device", "deficit", "cost_est", "t_start")

    def __init__(self, session: QuerySession):
        self.session = session
        self.gen = None
        self.device: torch.device | None = None  # what each morsel waits for
        self.deficit = 0.0
        self.cost_est = 0.0
        self.t_start: float | None = None  # trace clock, first morsel


class MorselScheduler:
    """The service's single worker loop driving all admitted queries.

    ``enqueue`` hands over ADMITTED sessions; the loop builds their step
    generators lazily (so a cancel-before-start never touches the card)
    and interleaves morsels per the policy. The loop's thread is the only
    one that launches the queries' work on the card.
    ``shutdown(cancel=False)`` drains the active set; ``cancel=True`` closes
    every generator and cancels pending sessions instead.
    """

    def __init__(self, policy: str = "fair", quantum_s: float = 0.02,
                 on_finish=None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        self.policy = policy
        self.quantum_s = float(quantum_s)
        self._on_finish = on_finish
        # RLock: the finish callback (service release -> enqueue of newly
        # admitted work) can re-enter the scheduler from the worker thread
        # while an activation already holds the condition
        self._cond = threading.Condition(threading.RLock())
        self._incoming: collections.deque[QuerySession] = collections.deque()
        self._active: collections.deque[_Active] = collections.deque()
        self._stop = False
        self._abort = False
        self._thread: threading.Thread | None = None
        self.morsels_total = 0
        self.turns_total = 0

    # -- service surface -------------------------------------------------------
    def start(self) -> None:
        """Start the worker thread (idempotent)."""
        with self._cond:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, name="repro-service-scheduler", daemon=True)
            self._thread.start()

    def enqueue(self, session: QuerySession) -> None:
        """Hand an ADMITTED session to the worker loop.

        Accepted during a draining shutdown (backlogged sessions admitted
        as slots free up are part of the drain), rejected once a
        cancelling shutdown is underway."""
        with self._cond:
            if self._stop and self._abort:
                raise RuntimeError("scheduler is shut down")
            self._incoming.append(session)
            self._cond.notify()

    def shutdown(self, cancel: bool = False, timeout: float | None = None) -> None:
        """Stop the loop: drain active queries, or cancel them.

        ``cancel=False`` (drain) finishes everything already enqueued, then
        exits; ``cancel=True`` closes active generators and cancels
        still-queued sessions at the next loop iteration.
        """
        with self._cond:
            self._stop = True
            self._abort = bool(cancel)
            self._cond.notify()
            t = self._thread
        if t is not None:
            t.join(timeout)

    def active_count(self) -> int:
        """Number of queries currently interleaving (excludes incoming)."""
        with self._cond:
            return len(self._active)

    def stats(self) -> dict:
        """Telemetry snapshot for ``service.stats()``."""
        with self._cond:
            return {
                "policy": self.policy,
                "quantum_s": self.quantum_s,
                "active": len(self._active),
                "incoming": len(self._incoming),
                "morsels_total": self.morsels_total,
                "turns_total": self.turns_total,
            }

    # -- worker loop -----------------------------------------------------------
    def _finish(self, entry: _Active, state: str, result=None, error=None,
                info=None) -> None:
        entry.session._finish(state, result=result, error=error, info=info)
        if _trace.enabled() and entry.t_start is not None:
            # retroactive query-lifetime span: stack spans would misnest
            # across interleaved queries on the one scheduler thread
            s = entry.session
            _trace.complete("service.query", entry.t_start, qid=s.qid,
                            label=s.label, state=state, morsels=s.morsels,
                            device_s=s.device_s)
        if self._on_finish is not None:
            self._on_finish(entry.session)

    def _activate(self, session: QuerySession,
                  check_cancel: bool = True) -> _Active | None:
        if check_cancel and session.cancel_requested():
            # cancelled between admission and first morsel: never build the
            # generator, never touch the card
            session._finish(QueryState.CANCELLED)
            if self._on_finish is not None:
                self._on_finish(session)
            return None
        entry = _Active(session)
        try:
            entry.gen = _steps_for(entry)
        except BaseException as e:
            session._finish(QueryState.FAILED, error=e)
            if self._on_finish is not None:
                self._on_finish(session)
            return None
        return entry

    def _step_once(self, entry: _Active, check_cancel: bool = True) -> bool:
        """Run one morsel of ``entry``; False when the query left the
        active set (finished, failed, or cancelled)."""
        s = entry.session
        if check_cancel and s.cancel_requested():
            entry.gen.close()
            self._finish(entry, QueryState.CANCELLED,
                         error=QueryCancelled(s.qid))
            return False
        if s.state == QueryState.ADMITTED:
            s._transition(QueryState.RUNNING)
            s.started_at = time.monotonic()
            entry.t_start = _trace.now()
        t0 = time.perf_counter()
        try:
            with _trace.span("service.morsel", qid=s.qid):
                try:
                    next(entry.gen)
                    done = None
                except StopIteration as e:
                    done = e.value if e.value is not None else (None, {})
                # the morsel's card work, so it is charged here and not to
                # the next morsel (a launch returns before the card is done)
                if entry.device is not None:
                    _executor.sync(entry.device)
        except BaseException as e:
            self._finish(entry, QueryState.FAILED, error=e)
            return False
        if done is not None:
            out, info = done
            self._finish(entry, QueryState.DONE, result=out, info=info)
            return False
        dt = time.perf_counter() - t0
        s.morsels += 1
        s.device_s += dt
        entry.cost_est = dt
        with self._cond:
            self.morsels_total += 1
        return True

    def _run_turn(self, entry: _Active) -> bool:
        """One scheduling turn for ``entry`` per the policy; False when the
        query finished during the turn."""
        with self._cond:
            self.turns_total += 1
        if self.policy == "round_robin":
            return self._step_once(entry)
        # deficit round robin over measured morsel seconds; the cap can
        # never fall below one morsel's estimated cost, else a query whose
        # morsels outweigh the banked maximum would starve forever
        w = max(entry.session.weight, 1e-6)
        cap = max(_DEFICIT_CAP_TURNS * self.quantum_s * w, entry.cost_est)
        entry.deficit = min(entry.deficit + self.quantum_s * w, cap)
        while entry.deficit >= entry.cost_est:
            if not self._step_once(entry):
                return False
            entry.deficit = max(entry.deficit - entry.cost_est, 0.0)
            if entry.cost_est <= 0.0:
                break  # unmeasurably cheap morsel: one per turn is enough
        return True

    def _loop(self) -> None:
        while True:
            with self._cond:
                while (not self._stop and not self._incoming
                       and not self._active):
                    self._cond.wait()
                while self._incoming:
                    entry = self._activate(self._incoming.popleft())
                    if entry is not None:
                        self._active.append(entry)
                if self._stop and (self._abort or not self._active):
                    abort = self._abort
                    break
                if not self._active:
                    continue
                entry = self._active.popleft()
            alive = self._run_turn(entry)
            if alive:
                with self._cond:
                    self._active.append(entry)
        if abort:
            # cancelling shutdown: close every generator, cancel sessions
            for entry in list(self._active):
                entry.session._cancel.set()
                entry.gen.close()
                if entry.session.state not in QueryState.TERMINAL:
                    self._finish(entry, QueryState.CANCELLED,
                                 error=QueryCancelled(entry.session.qid))
            self._active.clear()
            for session in list(self._incoming):
                session.cancel()
            self._incoming.clear()


# the ops of a grouped scheduler's decision log
_TURN, _RUN, _ACTIVATE, _CANCEL, _FINISH, _STOP, _IDLE = range(7)

#: an idle leader sends a record this often, so that the other ranks, which
#: wait for the next record in a collective, stay inside its time limit
_IDLE_BEAT_S = 1.0


class GroupedScheduler(MorselScheduler):
    """The scheduler of a service over a process group.

    Every rank's service holds the same queries, submitted in the same
    order and named by their submission index. Rank 0's thread takes every
    decision, by the one-process scheduler's rules on rank 0's clock: it
    admits each submission in order (``admit``, the service's admission
    controller, which runs on rank 0 alone), activates admitted queries,
    starts each turn, runs each morsel (the ``"fair"`` policy spends rank
    0's measured morsel seconds), honours cancels at a morsel boundary
    (rank 0's requests; the other ranks' are ignored) and stops. Before
    each step it sends every rank the record ``(turn, op, query index,
    morsels)`` (``WorkerBlock.broadcast_ints``), op one of turn, run (one
    morsel), activate, cancel, finish (a submission admission shed) or
    stop; the other ranks' threads take each step as its record arrives.
    A rank whose caller has not submitted the named query yet waits for it
    up to the group's time limit, then fails. Every collective of the
    service's queries runs on these threads, so the callers run none on the
    group while the service is up.
    """

    def __init__(self, workers, admit, policy: str = "fair", quantum_s: float = 0.02,
                 on_finish=None):
        self.workers = workers
        self.leads = workers.rank == 0
        # only rank 0 admits: the other ranks release no slots
        super().__init__(policy=policy, quantum_s=quantum_s,
                         on_finish=on_finish if self.leads else None)
        self._admit = admit
        self._submitted: list[QuerySession] = []
        self._arrivals: collections.deque[QuerySession] = collections.deque()
        self._queued: list[QuerySession] = []  # rank 0: backlogged by admission
        self._by_index: dict[int, _Active] = {}
        self.error: BaseException | None = None

    def start(self) -> None:
        with self._cond:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name="repro-service-scheduler", daemon=True)
            self._thread.start()

    def submit(self, session: QuerySession) -> None:
        """Name ``session`` by its submission index and hand it to the
        thread (rank 0 admits it there)."""
        with self._cond:
            if self.error is not None:
                raise RuntimeError("the grouped scheduler has failed") from self.error
            if self._stop and self._abort:
                raise RuntimeError("scheduler is shut down")
            session.grouped = True
            session.index = len(self._submitted)
            self._submitted.append(session)
            if self.leads:
                self._arrivals.append(session)
            self._cond.notify_all()

    def stats(self) -> dict:
        out = super().stats()
        out.update(rank=self.workers.rank, world=self.workers.world)
        return out

    # -- both sides ------------------------------------------------------------
    def _run(self) -> None:
        try:
            dev = self.workers.device
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.set_device(dev)  # a new thread starts on card 0
            self._lead() if self.leads else self._follow()
        except BaseException as e:  # every query still open fails with it
            with self._cond:
                self.error = e
            self._end_all(QueryState.FAILED, e)

    def _end_all(self, state: str, error: BaseException) -> None:
        """Close every open query's generator and end its session."""
        for entry in list(self._by_index.values()):
            entry.gen.close()
        self._by_index.clear()
        self._active.clear()
        self._incoming.clear()
        with self._cond:
            open_ = [s for s in self._submitted if s.state not in QueryState.TERMINAL]
        for s in open_:
            s._finish(state, error=error)

    def _morsel(self, entry: _Active) -> bool:
        """One morsel of ``entry``; False when the query left the active set."""
        if MorselScheduler._step_once(self, entry, check_cancel=False):
            return True
        self._by_index.pop(entry.session.index, None)
        return False

    def _start_query(self, session: QuerySession) -> None:
        entry = self._activate(session, check_cancel=False)
        if entry is not None:
            self._by_index[session.index] = entry
            self._active.append(entry)

    def _cancel_query(self, session: QuerySession) -> None:
        entry = self._by_index.pop(session.index, None)
        if entry is not None:
            if entry in self._active:
                self._active.remove(entry)
            entry.gen.close()
            self._finish(entry, QueryState.CANCELLED, error=QueryCancelled(session.qid))
            return
        session._finish(QueryState.CANCELLED, error=QueryCancelled(session.qid))
        if self._on_finish is not None:
            self._on_finish(session)

    # -- rank 0 ------------------------------------------------------------------
    def _send(self, op: int, index: int = -1, morsels: int = 0) -> None:
        self.workers.broadcast_ints([self.turns_total, op, index, morsels])

    def _run_turn(self, entry: _Active) -> bool:
        self._send(_TURN, entry.session.index)
        return super()._run_turn(entry)

    def _step_once(self, entry: _Active, check_cancel: bool = True) -> bool:
        """The one-process turn's morsel, announced first; a cancel rank 0
        was asked for ends the query here instead."""
        s = entry.session
        if check_cancel and s.cancel_requested():
            self._send(_CANCEL, s.index)
            self._cancel_query(s)
            return False
        self._send(_RUN, s.index, 1)
        return self._morsel(entry)

    def _lead(self) -> None:
        while True:
            with self._cond:
                if not (self._stop or self._arrivals or self._incoming or self._active
                        or any(s.cancel_requested() for s in self._queued)):
                    self._cond.wait(_IDLE_BEAT_S)
                arrivals = list(self._arrivals)
                self._arrivals.clear()
                stop, abort = self._stop, self._abort
            acted = bool(arrivals)
            for s in arrivals:
                try:
                    verdict = self._admit(s)
                except AdmissionError:  # shed: failed here, failed everywhere
                    self._send(_FINISH, s.index)
                    continue
                if verdict == "admitted":
                    with self._cond:
                        self._incoming.append(s)
                else:
                    self._queued.append(s)
            self._queued = [s for s in self._queued if s.state == QueryState.PENDING]
            for s in [s for s in self._queued if s.cancel_requested()]:
                acted = True
                self._send(_CANCEL, s.index)
                self._cancel_query(s)
            while True:
                with self._cond:
                    if not self._incoming:
                        break
                    s = self._incoming.popleft()
                acted = True
                if s.cancel_requested():
                    self._send(_CANCEL, s.index)
                    self._cancel_query(s)
                else:
                    self._send(_ACTIVATE, s.index)
                    self._start_query(s)
            if stop and (abort or not self._active):
                self._send(_STOP, -1, int(abort))
                if abort:
                    self._end_all(QueryState.CANCELLED, QueryCancelled("service shut down"))
                return
            if self._active:
                acted = True
                entry = self._active.popleft()
                if self._run_turn(entry):
                    self._active.append(entry)
            if not acted:
                self._send(_IDLE)

    # -- the other ranks -----------------------------------------------------------
    def _session_at(self, index: int) -> QuerySession:
        """This rank's submission ``index``, waiting for its caller to
        submit it up to the group's time limit."""
        deadline = time.monotonic() + self.workers.timeout_s
        with self._cond:
            while len(self._submitted) <= index:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"rank {self.workers.rank}: query {index} was not submitted within "
                        f"{self.workers.timeout_s:.0f} s of rank 0's; every rank submits "
                        "the same queries in the same order")
                self._cond.wait(left)
            return self._submitted[index]

    def _follow(self) -> None:
        while True:
            turn, op, index, morsels = self.workers.broadcast_ints([0, 0, 0, 0])
            if op == _IDLE:
                continue
            if op == _STOP:
                if morsels:
                    self._end_all(QueryState.CANCELLED, QueryCancelled("service shut down"))
                return
            if turn != self.turns_total:
                raise RuntimeError(f"rank {self.workers.rank} is at turn {self.turns_total}, "
                                   f"rank 0's decision log at {turn}")
            s = self._session_at(index)
            if op == _TURN:
                with self._cond:
                    self.turns_total += 1
            elif op == _RUN:
                entry = self._by_index[index]
                if not self._morsel(entry) and entry in self._active:
                    self._active.remove(entry)
            elif op == _FINISH:
                s._finish(QueryState.FAILED, error=AdmissionError(
                    f"query {s.qid} rejected: rank 0's admission backlog was full"))
            elif op == _CANCEL:
                self._cancel_query(s)
            elif op == _ACTIVATE:
                if s.state == QueryState.PENDING:
                    s._transition(QueryState.ADMITTED)
                self._start_query(s)
            else:
                raise RuntimeError(f"unknown op {op} in rank 0's decision log")
