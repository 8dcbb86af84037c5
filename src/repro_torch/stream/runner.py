"""Morsel-driven out-of-core batch runner (the streaming engine's core).

The reference's ``repro.stream.runner`` on one card. The runner executes a
lazy plan whose leaves include ``SCAN`` nodes over chunked on-disk datasets
(``repro_torch.data.dataset``). The dataset is sliced into cost-model-sized
batches (``SCAN.capacity`` per worker, from ``cost_model.choose_batch_rows``);
every batch is decoded host-side (projection + pushed-down predicates
applied *before* admission), copied to the card as a fixed-capacity
(P, capacity) table, and driven through the **same** optimized plan
(``executor.run_planned`` — one plan and one composed callable per
pipeline, every later batch is an op-cache hit). Host-side decode of batch
*k+1* overlaps the card's work on batch *k* via a double-buffered prefetch
thread.

**Streamable vs blocking.** A subtree is *streamable* when evaluating it on
a contiguous scan batch equals the global evaluation restricted to that
batch: embarrassingly-parallel ops, rebalance, joins whose other side is
scan-free. Blocking ops (groupby / unique / sort / set ops / scan x scan
joins) need cross-batch state:

- **carry state** — ``groupby`` runs per batch with ``emit_partials`` and
  the partial aggregates are merged into a device-resident carry table
  (``local_groupby(merge=True)``; hash placement is identical across
  batches, so the merge is worker-local). ``unique`` carries the distinct
  rows seen so far. One finalize pass at the end.
- **host-side spill** — ``sort_values`` streams its input to an on-disk
  spill dataset and runs one final stable host merge by the sort key;
  joins with scans on *both* sides spill each side into key-hash buckets
  and join bucket pairs (build side never has to fit device capacity).

Plans mixing these compose by staged materialization: the deepest blocking
node is finalized first, substituted back as an in-memory ``Source``, and
the rewritten plan streams again until no scans remain.

**Fault tolerance.** Every hot-path unit of work passes a named fault site
(``repro_torch.testing.faults``) and a bounded-backoff retry
(``repro_torch.stream.recovery``): ``chunk_decode`` around each batch's
host decode, ``device_op`` around each per-batch plan run on the card,
``spill_write`` around each spill append, ``checkpoint_publish`` inside
snapshot publication, and ``prefetch`` in the producer thread (kill-only —
a dead prefetch thread propagates its error instead of hanging the
consumer). Retryable failures (injected faults, I/O errors, torn npz
reads) re-execute in place; fatal errors (``strict_overflow``, schema
mismatches) propagate immediately.

**Externally drivable morsel steps.** The runner's execution is decomposed
into value-returning *step generators*: every internal loop yields one
event string per morsel of work (a scan batch through the optimized plan, a
spilled bucket joined, a scan-free device dispatch) and carries its result
back through ``return``. :func:`collect` / :func:`to_batches` simply drain
the generator; :class:`StreamExecution` hands the same generator to
external callers (the query service, ``repro_torch.service``, interleaves
morsels of many queries this way), which cancel a query cooperatively by
closing its generator (``GeneratorExit`` unwinds the runner's ``finally``
blocks, cleaning up spill state).

With ``checkpoint_dir`` set, the runner snapshots its whole per-query
state — scan cursor, the card's carry tables (as host numpy: the (P,
capacity) columns and the int32 counts), spill-writer manifests,
partially-joined bucket outputs, folded info counters — every
``checkpoint_every`` morsels through :class:`~repro_torch.stream.StreamCheckpoint`
(atomic tmp-dir-rename publish). The execution is decomposed into
deterministically numbered *stages* (one per blocking materialization /
final concat), allocated in plan order, so a resumed run (``resume=True``)
skips completed stages by restoring their materialized outputs, fast-
forwards to the snapshotted cursor of the in-flight stage, and recomputes
only the tail — producing output bit-identical to an uninterrupted run.

**Over a process group** (``DDFContext(group=...)``) every rank runs the
same morsels in the same order, so every host decision is taken from global
values: each rank decodes the same global row range of a batch and keeps
its block of the workers (``DDF.from_numpy``), row counts and the per-batch
aux counters are gathered over the group (``strict_overflow`` raises on
every rank at the same morsel; the adaptive controller replans at the same
batch), and a snapshot holds every worker's ``(P, capacity)`` columns and
``(P,)`` counts, so it resumes at any world that divides P, one process
included. Rank 0 alone writes the snapshots and the spill files under the
checkpoint store, between barriers; the other ranks read the same files
after it. Private spills (no store) are each rank's own temporary
directory. Fault plans count per process, so every rank fails and retries
at the same unit; a real error on one rank makes the others raise at the
group's collective time limit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import queue
import shutil
import tempfile
import threading
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from .. import expr as _expr
from ..core import cost_model
from ..core.api import DDF, DDFContext
from ..core.dataframe import Table, concat
from ..core.promotion import dtype_name
from ..core.local_ops import finalize_groupby, local_groupby, local_unique
from ..core.partition import default_quota
from ..data.dataset import (
    DatasetManifest,
    DatasetWriter,
    normalize_schema,
    read_rows,
)
from ..obs import metrics as _metrics
from ..obs import model_check as _model
from ..obs import trace as _trace
from ..plan import executor, optimizer
from ..plan.logical import (
    Fused,
    GroupBy,
    Join,
    MapColumns,
    Node,
    Project,
    Rebalance,
    Recode,
    Rename,
    Scan,
    Select,
    Sort,
    Source,
    Unique,
    WithColumn,
    plan_signature,
    row_bytes_of,
    schema_of,
    walk,
)
from ..testing import faults as _faults
from . import recovery as _recovery
from .checkpoint import StreamCheckpoint

__all__ = ["collect", "to_batches", "StreamExecution"]

_EPLIKE = (Select, Project, Rename, MapColumns, WithColumn, Fused, Rebalance,
           Recode)
_SIDS = itertools.count(1 << 20)  # runner-created Source ids, disjoint range

_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)


# -- plan analysis -------------------------------------------------------------

def _has_scan(node: Node) -> bool:
    return any(isinstance(n, Scan) for n in walk(node))


def _streamable(node: Node) -> bool:
    """True when per-batch evaluation == global evaluation per batch."""
    if not _has_scan(node):
        return True
    if isinstance(node, Scan):
        return True
    if isinstance(node, _EPLIKE):
        return _streamable(node.child)
    if isinstance(node, Join):
        lh, rh = _has_scan(node.left), _has_scan(node.right)
        if lh and rh:
            return False  # cross-batch matches: needs the spill join
        return _streamable(node.left if lh else node.right)
    # GroupBy / Unique / Sort / Union / Difference: cross-batch state
    # (set ops deduplicate, so even a probe-side scan cannot stream)
    return False


def _find_blocking(root: Node) -> Node | None:
    """Deepest non-streamable scan-bearing node whose children are each
    scan-free or streamable (post-order walk => deepest first)."""
    for n in walk(root):
        if _has_scan(n) and not _streamable(n):
            if all((not _has_scan(c)) or _streamable(c) for c in n.children):
                return n
    return None


def _replace_node(root: Node, target: Node, repl: Node) -> Node:
    memo: dict = {}

    def rec(n: Node) -> Node:
        if n is target:
            return repl
        if id(n) in memo:
            return memo[id(n)]
        kids = tuple(rec(c) for c in n.children)
        out = n if kids == n.children else n.with_children(kids)
        memo[id(n)] = out
        return out

    return rec(root)


def _set_batch_caps(root: Node, cap: int) -> Node:
    def rec(n: Node) -> Node:
        if isinstance(n, Scan):
            return dataclasses.replace(n, capacity=cap)
        kids = tuple(rec(c) for c in n.children)
        return n if kids == n.children else n.with_children(kids)

    return rec(root)


def _ddf_schema(ddf: DDF) -> tuple:
    return tuple(sorted((n, dtype_name(v.dtype), tuple(v.shape[2:]))
                        for n, v in ddf.columns.items()))


def _host(v) -> np.ndarray:
    """An aux counter (a (P,) tensor on the card, or host data) as numpy."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# -- host-side hashing (spill-join bucketing) ----------------------------------

def _np_hash32(x: np.ndarray) -> np.ndarray:
    """numpy replica of ``partition.hash32`` (lowbias32), for host bucketing
    and the host key->partition mirror: the same bits as the card's
    ``hash_partition`` destinations for the same canonical columns."""
    x = np.asarray(x)
    if x.dtype in (np.int64, np.uint64):
        u = x.astype(np.uint64)
        x = (u ^ (u >> np.uint64(32))).astype(np.uint32)
    elif x.dtype == np.bool_:
        x = x.astype(np.uint32)
    elif np.issubdtype(x.dtype, np.floating):
        x = np.ascontiguousarray(x.astype(np.float32)).view(np.uint32)
    else:
        x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * _M1
        x = x ^ (x >> np.uint32(15))
        x = x * _M2
        x = x ^ (x >> np.uint32(16))
    return x


def _np_hash_columns(host: Mapping[str, np.ndarray], cols) -> np.ndarray:
    n = len(next(iter(host.values())))
    h = np.zeros((n,), np.uint32)
    with np.errstate(over="ignore"):
        for name in cols:
            hk = _np_hash32(host[name])
            h = h ^ (hk + np.uint32(0x9E3779B9) + (h << np.uint32(6))
                     + (h >> np.uint32(2)))
    return h


def _drain(gen):
    """Run a step generator to completion, returning its ``return`` value.

    The synchronous entry points (:func:`collect`, the blocking prefix of
    :func:`to_batches`) drive the same generators the query service steps
    externally — draining is just "schedule every morsel back to back".
    """
    while True:
        try:
            next(gen)
        except StopIteration as e:
            return e.value


# -- prefetch (double buffering) -----------------------------------------------

_ITEM, _ERR, _DONE = "item", "err", "done"


def _prefetched(gen: Iterator, depth: int = 2) -> Iterator:
    """Run ``gen`` on a background thread with a bounded queue, so host
    decode of the next batch overlaps device execution of the current one.

    Queue traffic is tagged ``(kind, payload)`` tuples, so a decoder
    exception is an explicit ``_ERR`` item re-raised on the consumer thread
    (never confused with data), and the ``prefetch`` fault site fires in
    the producer. The consumer polls with a timeout and checks producer
    liveness: a prefetch thread that dies without enqueueing anything
    raises instead of blocking ``q.get()`` forever. Abandoning the
    iterator early (consumer ``break``/``close``) sets a stop flag the
    producer polls between puts, so the thread exits instead of blocking
    forever on a full queue; the consumer then waits for it (it finishes
    the item it is decoding, and closes ``gen``), so that no producer
    outlives its iterator, into the interpreter's shutdown."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def put(kind, payload) -> bool:
        while not stop.is_set():
            try:
                q.put((kind, payload), timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in gen:
                _faults.check("prefetch")
                if not put(_ITEM, item):
                    return
            put(_DONE, None)
        except BaseException as e:  # surfaced on the consumer thread
            put(_ERR, e)
        finally:
            if hasattr(gen, "close"):
                gen.close()

    t = threading.Thread(target=work, name="repro-stream-prefetch", daemon=True)
    t.start()
    try:
        while True:
            try:
                kind, payload = q.get(timeout=1.0)
            except queue.Empty:
                if not t.is_alive():
                    raise RuntimeError(
                        "stream prefetch thread died without yielding a "
                        "result or an error")
                continue
            if kind == _DONE:
                return
            if kind == _ERR:
                raise payload
            yield payload
    finally:
        stop.set()
        t.join()


# -- checkpoint session --------------------------------------------------------

class _CkptSession:
    """Per-run view of a :class:`StreamCheckpoint` store.

    Tracks completed-stage outputs (restored on resume instead of
    recomputed), the in-flight stage's snapshot callback, and the periodic
    publish cadence (every ``every`` morsel ticks). A snapshot is one
    consistent view: every completed stage's arrays + the active stage's
    cursor/state + the runner's folded info counters."""

    def __init__(self, runner: "_Runner", store: StreamCheckpoint,
                 every: int, resume: bool):
        self.runner = runner
        self.store = store
        self.every = max(int(every), 1)
        self.query_key = runner._query_key()
        # stage -> {"meta": json-able, "stage_end": int, "arrays": {name: np}}
        self.completed: dict[int, dict] = {}
        self.active_stage: int | None = None
        self.active_meta: dict | None = None
        self.active_arrays: dict | None = None
        self.resumed = False
        self._ticks = 0
        self._step = 0
        self._cur_stage: int | None = None
        self._snapshot_fn: Callable[[], tuple[dict, dict]] | None = None
        if resume and self.store.latest() is not None:
            self._restore()

    def _restore(self) -> None:
        manifest, arrays = self.store.load()
        if manifest.get("query_key") != self.query_key:
            raise ValueError(
                "resume=True but the checkpoint under "
                f"{self.store.directory!r} belongs to a different query "
                "(plan / worker count / scanned dataset changed)")
        want = {n: list(v.words)
                for n, v in sorted(self.runner.vocabs.items())}
        got = manifest.get("vocabs", want)
        if got != want:
            raise ValueError(
                "resume=True but the checkpoint's string vocabularies do "
                "not match this query's (carried code columns would decode "
                f"to different strings): checkpoint has {sorted(got)}, "
                f"query has {sorted(want)}")
        self.resumed = True
        self._step = int(manifest["step"]) + 1
        self._ticks = int(manifest.get("ticks", 0))
        for s, entry in manifest.get("completed", {}).items():
            s = int(s)
            pre = f"completed/{s}/"
            self.completed[s] = {
                "meta": entry["meta"],
                "stage_end": int(entry["stage_end"]),
                "arrays": {k[len(pre):]: v for k, v in arrays.items()
                           if k.startswith(pre)},
            }
        if manifest.get("active_stage") is not None:
            self.active_stage = int(manifest["active_stage"])
            self.active_meta = manifest.get("active_meta") or {}
            self.active_arrays = {k[len("active/"):]: v
                                  for k, v in arrays.items()
                                  if k.startswith("active/")}
        self.runner._info_restore(
            manifest.get("info", {}),
            {k[len("info/"):]: v for k, v in arrays.items()
             if k.startswith("info/")})

    def take_active(self, stage: int):
        """Consume the snapshot's in-flight state if it belongs to
        ``stage`` (returns ``(meta, arrays)`` once, else None)."""
        if self.active_stage == stage and self.active_meta is not None:
            meta, arrays = self.active_meta, self.active_arrays or {}
            self.active_stage = None
            self.active_meta = None
            self.active_arrays = None
            return meta, arrays
        return None

    def set_active(self, stage: int, snapshot_fn) -> None:
        """Register the in-flight stage's state provider:
        ``snapshot_fn() -> (json-able meta, numpy arrays)``."""
        self._cur_stage = stage
        self._snapshot_fn = snapshot_fn

    def complete(self, stage: int, meta: dict, arrays: dict) -> None:
        """Record a finished stage's output; it rides along the next
        periodic publish (resume recomputes any unpublished tail)."""
        self.completed[stage] = {"meta": dict(meta),
                                 "stage_end": int(self.runner._stage),
                                 "arrays": dict(arrays)}
        if self._cur_stage == stage:
            self._cur_stage = None
            self._snapshot_fn = None

    def tick(self) -> None:
        """One morsel of progress; publishes every ``every`` ticks."""
        self._ticks += 1
        if self._ticks % self.every == 0:
            self.publish()

    def publish(self) -> None:
        meta, active_arrays = (self._snapshot_fn() if self._snapshot_fn
                               else ({}, {}))
        info_scalars, info_arrays = self.runner._info_state()
        arrays: dict[str, np.ndarray] = {}
        completed_meta = {}
        for s, entry in self.completed.items():
            completed_meta[str(s)] = {"meta": entry["meta"],
                                      "stage_end": entry["stage_end"]}
            for name, v in entry["arrays"].items():
                arrays[f"completed/{s}/{name}"] = v
        for name, v in active_arrays.items():
            arrays[f"active/{name}"] = v
        for name, v in info_arrays.items():
            arrays[f"info/{name}"] = v
        manifest = {
            "query_key": self.query_key,
            "ticks": self._ticks,
            "completed": completed_meta,
            "active_stage": self._cur_stage,
            "active_meta": meta,
            "info": info_scalars,
            # dict-column vocabs: carried/completed-stage code arrays are
            # meaningless without these, so they are snapshot state too
            "vocabs": {n: list(v.words)
                       for n, v in sorted(self.runner.vocabs.items())},
        }
        step = self._step
        blk = self.runner.ctx.workers
        blk.barrier()  # no rank reads the store while rank 0 publishes
        if blk.rank == 0:
            # the checkpoint_publish fault site fires inside store.save
            # (between staging and the atomic rename), so the retry wraps
            # save directly
            self.runner._retry_call(
                "checkpoint_publish",
                lambda: self.store.save(step, manifest, arrays))
        else:  # the same fault site and retries, so that the ranks count alike
            self.runner._retry_call(
                "checkpoint_publish", lambda: _faults.check("checkpoint_publish"))
        blk.barrier()  # published before any rank goes on
        self._step += 1
        self.runner.metrics.counter("checkpoints").add(1)
        _trace.instant("stream.checkpoint", step=step,
                       arrays=len(arrays))

    def finish(self) -> None:
        """Query succeeded: snapshots and spill are crash artifacts only
        (cleared by rank 0 once every rank is done with them)."""
        blk = self.runner.ctx.workers
        blk.barrier()
        if blk.rank == 0:
            self.store.clear()
        blk.barrier()


# -- the runner ---------------------------------------------------------------

class _Runner:
    def __init__(self, lazy, batch_rows=None, prefetch=True,
                 carry_capacity=None, spill_dir=None, spill_compress=False,
                 strict_overflow=True, checkpoint_dir=None, checkpoint_every=4,
                 resume=False, max_retries=2, retry_backoff_s=0.05,
                 adaptive=False, replan_every=None):
        self.ctx: DDFContext = lazy._ctx
        self.P = self.ctx.nworkers
        self.params = cost_model.params_for_fabric()
        self.sources = dict(lazy._sources)
        self.scans: dict[int, DatasetManifest] = dict(lazy._scans)
        # dict-encoded string columns: host-side vocab metadata riding the
        # LazyDDF — folded into the checkpoint query_key (codes only mean
        # something under one vocab) and persisted/validated across resume
        self.vocabs = dict(getattr(lazy, "_vocabs", {}) or {})
        self.prefetch = bool(prefetch)
        self.carry_capacity = carry_capacity
        self.spill_dir = spill_dir
        self.spill_compress = bool(spill_compress)
        self.strict_overflow = bool(strict_overflow)
        self.adaptive = bool(adaptive)
        self.replan_every = replan_every
        # per-batch shuffle-key observation channel: _host_batches fills
        # self._obs[k] = (rows, histogram) on the decode (prefetch) thread
        # when _obs_keys is set; the consuming carry loop pops by batch
        # index (dict item assignment is GIL-atomic)
        self._obs: dict[int, tuple] = {}
        self._obs_keys: tuple | None = None
        root = lazy._root
        if batch_rows is not None:
            root = _set_batch_caps(root, max(-(-int(batch_rows) // self.P), 1))
        self.root = root
        caps = [n.capacity for n in walk(root) if isinstance(n, Scan)]
        self.nominal_batch_rows = (max(caps) * self.P) if caps else None
        # the kernel backend override threads through unchanged: every
        # per-batch plan goes through cached_op, whose keys carry the
        # dispatch signature — recorded here so run info shows which
        # backend the stream executed under.
        from ..kernels import registry as _kernel_registry

        self.info: dict = {"kernel_backend": _kernel_registry.get_backend()}
        # typed counters for everything numeric the run used to keep as
        # ad-hoc info keys (batches, retries:<site>, checkpoints, peak
        # working set). Parenting under the global registry means process
        # totals aggregate across runs while each run reads its own values;
        # the info dict keeps only non-metric payloads (arrays, strings).
        self.metrics = _metrics.MetricsRegistry(parent=_metrics.registry(),
                                                prefix="stream.")
        self.metrics.counter("batches")  # pre-create: info always has it
        self.metrics.counter("chunks_decoded")   # chunk-skip visibility:
        self.metrics.counter("chunks_skipped")   # info always carries both
        self.metrics.counter("replans")
        self.retry = _recovery.RetryPolicy(max_retries=int(max_retries),
                                           backoff_s=float(retry_backoff_s))
        self._stage = 0
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        self.session: _CkptSession | None = None
        if checkpoint_dir is not None:
            self.session = _CkptSession(self, StreamCheckpoint(checkpoint_dir),
                                        checkpoint_every, resume)

    # -- fault sites + retry ---------------------------------------------------
    def _note_retry(self, site: str, attempt: int, exc: BaseException) -> None:
        # Counter.add is internally locked — safe from the prefetch thread
        # and the service driver thread without a runner-level lock.
        self.metrics.counter(f"retries:{site}").add(1)
        _trace.instant("stream.retry", site=site, attempt=int(attempt),
                       error=type(exc).__name__)

    def _retry_call(self, site: str, fn):
        """Retry ``fn`` under the site's policy (fault check is inside fn)."""
        return _recovery.call_with_retry(fn, self.retry, site,
                                         on_retry=self._note_retry)

    def _guarded(self, site: str, fn):
        """One unit of work at a named fault site: the injected-fault check
        fires before each (re-)execution, and retryable failures re-run
        with bounded backoff."""
        def unit():
            _faults.check(site)
            return fn()
        return self._retry_call(site, unit)

    # -- info bookkeeping ------------------------------------------------------
    def _fold_aux(self, aux_list: list, scope: str | None = None) -> None:
        """Fold per-batch aux dicts into run info.

        ``scope`` namespaces the keys (``"{scope}:{k}"``). Aux keys are
        ``n{i}:{name}`` with ``i`` the node's post-order index *within that
        stage's plan* — two different stages can both emit ``n0:overflow_agg``
        for unrelated operators, and on a resumed run the restored info
        already holds the crashed process's totals. Scoping keeps those
        identically named counters from alias-summing (double counting)."""
        for aux in aux_list:
            for k, v in aux.items():
                if scope is not None:
                    k = f"{scope}:{k}"
                v = _host(v)
                if "overflow" in k:
                    prev = self.info.get(k)
                    self.info[k] = v if prev is None else prev + v
                else:
                    self.info[k] = v
        if self.strict_overflow:
            bad = {k: int(np.sum(v)) for k, v in self.info.items()
                   if isinstance(v, np.ndarray) and "overflow" in k
                   and np.sum(v) > 0}
            if bad:
                raise RuntimeError(
                    f"streaming run overflowed static buffers: {bad} rows "
                    "dropped — results would silently diverge from eager "
                    "execution. Pin larger quota/capacity on the offending "
                    "op, lower batch_rows, or pass strict_overflow=False to "
                    "accept eager-style truncation semantics.")

    def _info_view(self) -> dict:
        """The run-info mapping handed to callers: non-metric payloads from
        the info dict merged with this run's metric values (counters plus
        any set gauges). The metrics registry is the single source of truth
        for every numeric counter."""
        out = dict(self.info)
        out.update(self.metrics.scalars())
        return out

    def _info_state(self) -> tuple[dict, dict]:
        """Split run info into (JSON-able scalars, numpy arrays) for the
        checkpoint manifest."""
        scalars, arrays = {}, {}
        for k, v in self._info_view().items():
            if isinstance(v, np.ndarray):
                arrays[k] = v
            elif isinstance(v, (np.integer, np.floating)):
                scalars[k] = v.item()
            else:
                scalars[k] = v
        return scalars, arrays

    # gauge-typed info keys: restored with .restore (set, don't accumulate)
    _GAUGE_KEYS = frozenset({"peak_working_set_bytes"})

    def _info_restore(self, scalars: dict, arrays: dict) -> None:
        """Rehydrate run info from a checkpoint manifest.

        Numeric scalars route into this run's metric registry via
        ``restore`` — a *local-only* set. The restored counts were earned
        by the crashed process; re-adding them here would propagate to the
        parent (process-global) registry a second time and double-count
        identically named counters across the resume. ``kernel_backend``
        stays whatever the *current* process runs under."""
        for k, v in scalars.items():
            if k == "kernel_backend":
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                if k in self._GAUGE_KEYS:
                    self.metrics.gauge(k).restore(v)
                else:
                    self.metrics.counter(k).restore(int(v))
            else:
                self.info[k] = v
        self.info.update(arrays)

    # -- checkpoint/stage machinery --------------------------------------------
    def _query_key(self) -> str:
        """Identity of the work a checkpoint belongs to: the (pre-optimizer)
        plan shape, the worker count, and every scanned dataset's schema +
        chunk list. Resuming under a different key is refused — the cursor
        would index different data."""
        h = hashlib.sha256()
        h.update(plan_signature(self.root).encode())
        h.update(f"P={self.P}".encode())
        done = set()
        for n in walk(self.root):
            if isinstance(n, Scan) and n.sid not in done:
                done.add(n.sid)
                m = self.scans[n.sid]
                # capacity: the cursor's meaning depends on the batch size
                h.update(repr((len(done), int(n.capacity), m.schema,
                               m.chunks)).encode())
                # dict columns: carried codes only decode under this vocab
                h.update(repr(getattr(m, "vocabs", ())).encode())
        h.update(repr(sorted((n, v.words)
                             for n, v in self.vocabs.items())).encode())
        return h.hexdigest()

    def _stage_enter(self, kind: str):
        """Allocate the next stage id (deterministic plan-order numbering).

        Returns ``(stage, completed_entry, active_resume)``. The stage id
        is always allocated — it scopes aux counters and trace spans even
        without a checkpoint session; ``completed_entry`` is set when this
        stage already finished in the snapshot (the counter fast-forwards
        past any child stages via the recorded ``stage_end``);
        ``active_resume = (meta, arrays)`` when the snapshot died inside
        this stage."""
        i = self._stage
        self._stage += 1
        if self.session is None:
            return i, None, None
        entry = self.session.completed.get(i)
        if entry is not None:
            if entry["meta"].get("kind") != kind:
                raise ValueError(
                    f"checkpoint stage {i} is a {entry['meta'].get('kind')!r} "
                    f"stage, expected {kind!r} — snapshot does not match "
                    "this query")
            self._stage = int(entry["stage_end"])
            return i, entry, None
        return i, None, self.session.take_active(i)

    def _stage_done(self, stage, kind: str, meta: dict, arrays: dict) -> None:
        if self.session is not None and stage is not None:
            meta = dict(meta)
            meta["kind"] = kind
            self.session.complete(stage, meta, arrays)

    def _tick(self) -> None:
        if self.session is not None:
            self.session.tick()

    def _stage_span(self, stage, kind: str, t0: float, **attrs) -> None:
        """Record a retroactive span for one finished streaming stage.

        Stage drivers are generators the query service suspends between
        morsels, so a stack-scoped span would misnest across interleaved
        queries — a ``trace.complete`` from captured timestamps cannot.
        The duration therefore includes any time spent suspended."""
        if _trace.enabled():
            _trace.complete("stream.stage", t0, kind=kind, stage=stage,
                            **attrs)

    def _resident_bytes(self) -> float:
        """Padded bytes of the always-resident inputs (non-scanned
        sources)."""
        return sum(float(d.capacity) * self.P * row_bytes_of(_ddf_schema(d))
                   for d in self.sources.values())

    def _note_working_set(self, extra_bytes: float) -> None:
        """Fold one observation into the run's peak-working-set gauge: the
        resident sources plus the active stage's padded batch/carry/bucket
        tables (the reference's admission controller learns per-query-key
        corrections from this peak)."""
        self.metrics.gauge("peak_working_set_bytes").max(
            self._resident_bytes() + float(extra_bytes))

    # -- DDF <-> checkpoint arrays ---------------------------------------------
    def _ddf_arrays(self, ddf: DDF) -> tuple[dict, dict]:
        """Faithful snapshot of a DDF as host numpy: the padded (P,
        capacity) columns + the int32 per-worker counts, verbatim, of every
        worker (gathered over a group). (A to_numpy/from_numpy round-trip
        would re-partition rows contiguously and break worker-local carry
        merges — hash placement must survive the snapshot.)"""
        gather = self.ctx.workers.gather_workers
        arrays = {"counts": gather(ddf.counts).cpu().numpy()}
        for n, v in ddf.columns.items():
            arrays[f"col/{n}"] = gather(v).cpu().numpy()
        return arrays, {"capacity": int(ddf.capacity)}

    def _ddf_from_arrays(self, arrays: Mapping[str, np.ndarray]) -> DDF:
        """The DDF of a snapshot's arrays: this process's block of workers."""
        dev, lo, hi = self.ctx.device, self.ctx.workers.lo, self.ctx.workers.hi
        cols = {k[len("col/"):]: torch.from_numpy(np.ascontiguousarray(v[lo:hi])).to(dev)
                for k, v in arrays.items() if k.startswith("col/")}
        counts = torch.from_numpy(np.asarray(arrays["counts"], np.int32)[lo:hi]).to(dev)
        return DDF(cols, counts, self.ctx)

    def _restore_ddf(self, entry: dict) -> DDF:
        return self._ddf_from_arrays(entry["arrays"])

    # -- batch iteration over one streamable subtree ---------------------------
    def _prep(self, root: Node):
        from ..stats import chunk_skip_mask, plan_stats  # local: avoid cycle

        scans = [n for n in walk(root) if isinstance(n, Scan)]
        sids = {s.sid for s in scans}
        if len(sids) != 1:
            raise ValueError(f"streamable subtree must hold exactly one scan, "
                             f"got {sorted(sids)}")
        scan = scans[0]
        man = self.scans[scan.sid]
        batch_rows = scan.capacity * self.P
        srcs = {n.sid: self.sources[n.sid] for n in walk(root)
                if isinstance(n, Source)}
        src_rows = executor.source_row_counts(srcs)
        src_rows[scan.sid] = max(min(man.num_rows, batch_rows), 1)
        stats = plan_stats({scan.sid: man})
        plan = optimizer.optimize(root, self.P, src_rows, self.params,
                                  stats=stats)
        scan_opt = next(n for n in walk(plan) if isinstance(n, Scan))
        # chunk-skip mask from the *optimized* scan (post predicate
        # absorption): conservative — never flags a chunk that could
        # contribute a matching row, so skipping is bit-identical
        skips = chunk_skip_mask(man, scan_opt.pred_sigs)
        return plan, scan_opt, man, batch_rows, srcs, skips

    def _host_batches(self, man: DatasetManifest, scan: Scan,
                      batch_rows: int, start: int = 0,
                      skips=None) -> Iterator[tuple]:
        cols = scan.columns
        # expression predicates may reference columns outside the scan's
        # projected output (the optimizer narrows the decode set past them
        # because the reference set is exact): decode the superset, filter,
        # then drop the pred-only columns before admission
        read_cols = cols
        if cols is not None:
            extra = set()
            for sig in scan.pred_sigs:
                if isinstance(sig, _expr.Expr):
                    extra |= _expr.referenced_columns(sig)
            extra -= set(cols)
            if extra:
                read_cols = tuple(sorted(set(cols) | extra))
        total = man.num_rows
        nb = max(-(-total // batch_rows), 1)
        # per-chunk global offsets, for attributing skip/decode counts to
        # the batch whose row range covers each chunk
        chunk_offs = np.cumsum([0] + [r for _, r in man.chunks])
        obs_keys = self._obs_keys
        for k in range(start, nb):
            lo, hi = k * batch_rows, min((k + 1) * batch_rows, total)

            def decode(lo=lo, hi=hi, k=k):
                # spans carry the prefetch thread's tid when prefetching —
                # decode/compute overlap is visible in the trace timeline
                t0 = _trace.now()
                data = read_rows(man, lo, hi, columns=read_cols,
                                 skip_chunks=skips)
                n_over = n_skip = 0
                for i in range(len(man.chunks)):
                    if chunk_offs[i] < hi and chunk_offs[i + 1] > lo:
                        n_over += 1
                        if skips is not None and skips[i]:
                            n_skip += 1
                # Counter.add is locked: safe from the prefetch thread
                self.metrics.counter("chunks_skipped").add(n_skip)
                self.metrics.counter("chunks_decoded").add(n_over - n_skip)
                for fn in scan.pred_fns:
                    mask = np.asarray(fn(data)).astype(bool)
                    data = {n: v[mask] for n, v in data.items()}
                if read_cols is not cols:
                    data = {n: data[n] for n in cols}
                if obs_keys is not None and data \
                        and all(c in data for c in obs_keys):
                    # host mirror of the device shuffle's key->partition
                    # map: the observed per-partition histogram the
                    # adaptive controller and quota accounting consume
                    rows_out = len(next(iter(data.values())))
                    dest = _np_hash_columns(data, obs_keys) % np.uint32(self.P)
                    self._obs[k] = (rows_out,
                                    np.bincount(dest, minlength=self.P))
                if _trace.enabled():
                    out_rows = (len(next(iter(data.values())))
                                if data else hi - lo)
                    nbytes = sum(int(v.nbytes) for v in data.values())
                    _trace.complete("stream.decode", t0, batch=k,
                                    rows_read=hi - lo, rows_out=out_rows,
                                    bytes=nbytes)
                    pred = _model.scan_prediction(
                        hi - lo, row_bytes_of(schema_of(scan)), self.P,
                        self.params)
                    _model.record(
                        "partitioned_io", "stream.Scan", pred["predicted_s"],
                        _trace.now() - t0,
                        predicted_rows=pred["predicted_rows"],
                        observed_rows=out_rows,
                        predicted_bytes=pred["predicted_bytes"],
                        observed_bytes=nbytes, meta={"batch": k})
                return data

            yield k, self._guarded("chunk_decode", decode)

    def _iter_batches(self, root: Node, prep=None, start: int = 0):
        """Yield ``(batch index, result DDF, aux)`` per streamed batch of a
        streamable subtree (``start`` skips already-folded batches on
        resume — the scan cursor)."""
        plan, scan_opt, man, batch_rows, srcs, skips = prep or self._prep(root)
        batch_bytes = (scan_opt.capacity * self.P
                       * row_bytes_of(schema_of(scan_opt)))
        self._note_working_set(batch_bytes)
        preds = None
        if _trace.enabled():
            src_rows = executor.source_row_counts(srcs)
            src_rows[scan_opt.sid] = max(min(man.num_rows, batch_rows), 1)
            # the scan's partitioned_io cost is host-side decode, recorded
            # per batch in _host_batches — keep only the device program's
            # patterns here or scans would be double-counted
            preds = [p for p in _model.predict_plan(plan, self.P, src_rows,
                                                    self.params)
                     if p["pattern"] != "partitioned_io"]
        gen = self._host_batches(man, scan_opt, batch_rows, start=start,
                                 skips=skips)
        if self.prefetch:
            gen = _prefetched(gen)
        for k, data in gen:
            def run(data=data):
                bddf = DDF.from_numpy(data, self.ctx,
                                      capacity=scan_opt.capacity, mode="eager")
                return executor.run_planned(
                    plan, self.ctx, {**srcs, scan_opt.sid: bddf})

            if preds is not None:
                t0 = _trace.now()
                out, aux = self._guarded("device_op", run)
                executor.sync(out.counts)
                t1 = _trace.now()
                rows = out.num_rows()
                _trace.complete("stream.device_op", t0, t1, batch=k,
                                ops=len(preds), out_rows=rows)
                _model.record_program(preds, t1 - t0, observed_rows=rows,
                                      op_prefix="stream.")
            else:
                out, aux = self._guarded("device_op", run)
            self.metrics.counter("batches").add(1)
            yield k, out, aux

    # -- streamable whole-plan paths -------------------------------------------
    def _stream_host(self, root: Node, start: int = 0, prep=None,
                     scope: str | None = None) -> Iterator[tuple]:
        # aux folds per batch: a strict_overflow violation raises BEFORE the
        # truncated batch is handed out (and early iterator abandon cannot
        # skip the check). The per-batch device sync this implies is free
        # here — to_numpy() syncs on the same results anyway.
        for k, out, aux in self._iter_batches(root, prep=prep, start=start):
            self._fold_aux([aux], scope=scope)
            yield k, out.to_numpy()

    def _from_host(self, host: dict, schema: tuple) -> DDF:
        if not host:
            host = {n: np.zeros((0,) + tuple(tail), np.dtype(dt))
                    for n, dt, tail in schema}
        total = len(next(iter(host.values())))
        cap = max(-(-total // self.P), 1)
        return DDF.from_numpy(host, self.ctx, capacity=cap, mode="eager")

    def _stream_concat(self, root: Node) -> DDF:
        stage, entry, resume = self._stage_enter("concat")
        if entry is not None:
            return self._restore_ddf(entry)
        t0 = _trace.now()
        schema = schema_of(root)
        outs: list[dict] = []
        cursor = {"k": 0}
        if resume is not None:
            rmeta, rarr = resume
            cursor["k"] = int(rmeta["k"])
            acc = {n: rarr[f"acc/{n}"] for n, _, _ in schema
                   if f"acc/{n}" in rarr}
            if acc:
                outs.append(acc)

        def snap():
            host = {n: np.concatenate([o[n] for o in outs])
                    for n, _, _ in schema} if outs else {}
            return ({"k": cursor["k"]},
                    {f"acc/{n}": v for n, v in host.items()})

        if self.session is not None:
            self.session.set_active(stage, snap)
        for k, host in self._stream_host(root, start=cursor["k"],
                                         scope=f"s{stage}"):
            outs.append(host)
            cursor["k"] = k + 1
            self._tick()
            yield "concat"
        host = {n: np.concatenate([o[n] for o in outs])
                for n, _, _ in schema} if outs else {}
        out = self._from_host(host, schema)
        self._stage_span(stage, "concat", t0, batches=cursor["k"])
        arrays, meta = self._ddf_arrays(out)
        self._stage_done(stage, "concat", meta, arrays)
        return out

    # -- carry-state tails ------------------------------------------------------
    def _carry_cap(self, node: Node, scan_total: int) -> int:
        if self.carry_capacity:
            return int(self.carry_capacity)
        if getattr(node, "capacity", None):
            return int(node.capacity)
        return max(-(-max(scan_total, 1) // self.P), 1)

    def _empty_carry(self, schema: tuple, cap: int) -> DDF:
        host = {n: np.zeros((0,) + tuple(tail), np.dtype(dt))
                for n, dt, tail in schema}
        return DDF.from_numpy(host, self.ctx, capacity=cap, mode="eager")

    @staticmethod
    def _truncate_with_overflow(full: Table, cap: int):
        """Cut a compacted table down to the carry capacity, reporting how
        many live rows (groups) the cut drops — the carry-state analogue of
        the shuffle overflow counters, so ``strict_overflow`` sees it."""
        cols = {k: v[:, :cap] for k, v in full.columns.items()}
        ov = torch.clamp(full.nvalid - cap, min=0)
        return Table(cols, torch.clamp(full.nvalid, max=cap)), {"overflow_carry": ov}

    @staticmethod
    def _keys_direct(node: Node) -> bool:
        """True when every node below a shuffle passes the scan's columns
        through untouched — the condition under which the host hash
        mirror over decoded rows equals the device shuffle's
        key->partition map (the observation the adaptive controller
        feeds on)."""
        return all(isinstance(n, (Scan, Select, Project, Rebalance))
                   for n in walk(node))

    def _run_carry(self, B: Node, batch_root: Node, merge,
                   stage=None, resume=None):
        """Shared carry-state drive loop: stream batches through the
        optimized per-batch plan, folding each result into the carry DDF.
        The carry table (padded columns + per-worker counts) plus the scan
        cursor *is* the whole cross-batch state, so it is exactly what the
        checkpoint session snapshots.

        With ``adaptive=True`` an :class:`~repro_torch.stats.AdaptiveController`
        watches each batch's observed key histogram (host mirror of the
        device shuffle) and per-worker group counts; at its decision
        cadence it may re-pin quota/capacity on the batch plan for all
        *later* morsels. Corrections only resize static buffers, so
        results stay bit-identical (undersized corrections raise under
        ``strict_overflow`` rather than truncate silently). Controller
        state snapshots into the checkpoint's active-stage meta, so a
        resumed stream re-enters the exact corrected plan and makes the
        same future decisions."""
        from ..stats import AdaptiveController  # local: avoid import cycle

        prep = self._prep(batch_root)
        plan = prep[0]
        cap = self._carry_cap(B, prep[2].num_rows)
        nb = max(-(-prep[2].num_rows // prep[3]), 1)
        shuffle_node = next((n for n in walk(plan)
                             if isinstance(n, (GroupBy, Unique))), None)
        plan_quota = getattr(shuffle_node, "quota", None)
        keys = getattr(B, "by", None) or getattr(B, "subset", None)
        keys_direct = bool(keys) and self._keys_direct(batch_root.children[0])
        ctrl = None
        if (self.adaptive and plan_quota
                and getattr(shuffle_node, "capacity", None)):
            ctrl = AdaptiveController(self.P, plan_quota,
                                      int(shuffle_node.capacity),
                                      replan_every=self.replan_every)
        state = {"k": 0, "carry": None}
        if resume is not None:
            rmeta, rarr = resume
            state["k"] = int(rmeta["k"])
            cap = int(rmeta["cap"])
            state["carry"] = self._ddf_from_arrays(rarr)
            if ctrl is not None and rmeta.get("adaptive"):
                ctrl = AdaptiveController.restore(rmeta["adaptive"])
        else:
            state["carry"] = self._empty_carry(schema_of(plan), cap)
        cur_root = batch_root
        if ctrl is not None and (ctrl.quota_override is not None
                                 or ctrl.capacity_override is not None):
            # resumed mid-correction: re-enter the corrected plan exactly
            cur_root = ctrl.pin(batch_root)
            prep = self._prep(cur_root)
            plan = prep[0]
        # active set here = the carry table plus one batch's partial result
        self._note_working_set((cap + prep[1].capacity) * self.P
                               * row_bytes_of(schema_of(plan)))

        def snap():
            arrays, _ = self._ddf_arrays(state["carry"])
            meta = {"k": state["k"], "cap": cap}
            if ctrl is not None:
                meta["adaptive"] = ctrl.state_dict()
            return meta, arrays

        if self.session is not None:
            self.session.set_active(stage, snap)
        scope = f"s{stage}"
        if keys_direct and (ctrl is not None or _trace.enabled()):
            self._obs_keys = tuple(keys)
        try:
            while state["k"] < nb:
                gen = self._iter_batches(cur_root, prep=prep,
                                         start=state["k"])
                for k, out, aux in gen:
                    # one merge on every worker at once, (P, capacity) tables
                    t, carry_ov = merge(cap)(self.ctx.comm(),
                                             state["carry"].table(), out.table())
                    state["carry"] = DDF(dict(t.columns), t.nvalid, self.ctx)
                    ov = self.ctx.workers.gather_workers(carry_ov["overflow_carry"])
                    self._fold_aux([aux, {"carry:overflow_carry": ov}], scope=scope)
                    state["k"] = k + 1
                    obs = self._obs.pop(k, None)
                    if obs is not None:
                        rows_in, hist = obs
                        quota_now = (ctrl.current_quota if ctrl is not None
                                     else plan_quota)
                        if _trace.enabled() and quota_now:
                            # quota accuracy, in rows: planned per-partition
                            # allowance vs the batch's observed max cell
                            _model.record(
                                "shuffle_quota",
                                f"stream.{type(B).__name__}",
                                float(quota_now),
                                float(max(int(hist.max()), 1)),
                                observed_rows=int(rows_in),
                                meta={"batch": k})
                        if ctrl is not None:
                            counts = self.ctx.workers.gather_workers(
                                out.counts).cpu().numpy()
                            ctrl.observe(rows_in, hist=hist,
                                         groups_out=int(counts.sum()),
                                         max_worker_groups=int(counts.max()))
                    self._tick()
                    yield "carry"
                    if (ctrl is not None and state["k"] < nb
                            and ctrl.should_replan()):
                        gen.close()  # stop the prefetch thread cleanly
                        cur_root = ctrl.apply(batch_root)
                        prep = self._prep(cur_root)
                        plan = prep[0]
                        self.metrics.counter("replans").add(1)
                        _trace.instant("stream.replan", batch=state["k"],
                                       quota=int(ctrl.current_quota))
                        break
                else:
                    break  # generator exhausted: all batches folded
        finally:
            self._obs_keys = None
            self._obs.clear()
        return state["carry"], cap

    def _stream_groupby(self, B: GroupBy) -> DDF:
        stage, entry, resume = self._stage_enter("groupby")
        if entry is not None:
            return self._restore_ddf(entry)
        t0 = _trace.now()
        aggs = {k: v for k, v in B.aggs}
        batch_root = dataclasses.replace(B, emit_partials=True, quota=None,
                                         capacity=None, num_chunks=None)
        by = B.by

        def merge(cap):
            def fn(comm, c, b):
                # merge at full concat capacity (groups <= rows, so no
                # truncation), then cut to the carry capacity with an
                # explicit overflow counter
                full = local_groupby(concat(c, b), by, aggs, merge=True)
                return self._truncate_with_overflow(full, cap)
            return fn

        carry, cap = yield from self._run_carry(
            B, batch_root, merge, stage=stage, resume=resume)
        fin = finalize_groupby(carry.table(), aggs)
        out = DDF(dict(fin.columns), fin.nvalid, self.ctx)
        self._stage_span(stage, "groupby", t0)
        arrays, meta = self._ddf_arrays(out)
        self._stage_done(stage, "groupby", meta, arrays)
        return out

    def _stream_unique(self, B: Unique) -> DDF:
        stage, entry, resume = self._stage_enter("unique")
        if entry is not None:
            return self._restore_ddf(entry)
        t0 = _trace.now()
        batch_root = dataclasses.replace(B, quota=None, capacity=None,
                                         num_chunks=None)
        subset = B.subset

        def merge(cap):
            def fn(comm, c, b):
                # carry rows concat first: earliest-batch occurrence wins,
                # matching local_unique's stable first-occurrence contract
                full = local_unique(concat(c, b), subset)
                return self._truncate_with_overflow(full, cap)
            return fn

        carry, _ = yield from self._run_carry(
            B, batch_root, merge, stage=stage, resume=resume)
        self._stage_span(stage, "unique", t0)
        arrays, meta = self._ddf_arrays(carry)
        self._stage_done(stage, "unique", meta, arrays)
        return carry

    # -- spill tails ------------------------------------------------------------
    def _spill_chunk_rows(self) -> int:
        return self.nominal_batch_rows or 65536

    def _spill_writer(self, schema: tuple) -> DatasetWriter:
        d = tempfile.mkdtemp(prefix="repro-spill-",
                             dir=self.spill_dir)
        # stats=False: spill runs are consumed once in full — sketching
        # them would cost write-time work with no pruning to gain
        return DatasetWriter(d, schema=schema, chunk_rows=self._spill_chunk_rows(),
                             compress=self.spill_compress, stats=False)

    def _stage_spill_writer(self, tag: str, schema: tuple,
                            chunks=None, buffered=None) -> DatasetWriter:
        """A spill writer whose files live under the checkpoint store's
        persistent spill root (they must survive a crash); ``chunks`` +
        ``buffered`` rebuild it from an active-stage snapshot — chunk files
        written after the snapshot are overwritten by index as the resumed
        stream re-appends. Over a group rank 0 alone writes the files; the
        other ranks keep the same writer state and read them after a
        barrier."""
        mine = self.ctx.workers.rank == 0
        d = self.session.store.spill_dir(tag, create=mine)
        if chunks is None:
            return DatasetWriter(d, schema=schema,
                                 chunk_rows=self._spill_chunk_rows(),
                                 compress=self.spill_compress, stats=False,
                                 write=mine)
        return DatasetWriter.resume(d, schema, chunks, buffered=buffered,
                                    chunk_rows=self._spill_chunk_rows(),
                                    compress=self.spill_compress, write=mine)

    def _spill_append(self, writer: DatasetWriter, host: dict) -> None:
        self._guarded("spill_write", lambda: writer.append(host))

    def _stream_sort(self, B: Sort) -> DDF:
        """Spill the sort's input to disk while streaming, then one stable
        host merge by the key. The spill bounds host RSS *during* the
        streaming phase (batches land on disk, not in a growing list); the
        final merge necessarily materializes on host — the sorted result
        becomes a device DDF anyway, so that peak is unavoidable. A k-way
        merge of pre-sorted runs would only change the merge's working set,
        not the result materialization."""
        stage, entry, resume = self._stage_enter("sort")
        if entry is not None:
            return self._restore_ddf(entry)
        t0 = _trace.now()
        prefix = B.child
        schema = schema_of(prefix)
        cursor = {"k": 0}
        if self.session is not None:
            if resume is not None:
                rmeta, rarr = resume
                cursor["k"] = int(rmeta["k"])
                chunks = [(f, int(r)) for f, r in rmeta["chunks"]]
                buffered = {k[len("buf/"):]: v for k, v in rarr.items()
                            if k.startswith("buf/")}
                writer = self._stage_spill_writer(f"stage{stage}", schema,
                                                  chunks=chunks,
                                                  buffered=buffered)
            else:
                writer = self._stage_spill_writer(f"stage{stage}", schema)
            cleanup = False
        else:
            writer = self._spill_writer(schema)
            cleanup = True

        def snap():
            chunks, buf = writer.state()
            return ({"k": cursor["k"], "chunks": [[f, int(r)] for f, r in chunks]},
                    {f"buf/{n}": v for n, v in buf.items()})

        if self.session is not None:
            self.session.set_active(stage, snap)
        try:
            for k, host in self._stream_host(prefix, start=cursor["k"],
                                             scope=f"s{stage}"):
                self._spill_append(writer, host)
                cursor["k"] = k + 1
                self._tick()
                yield "sort-spill"
            man = writer.close()
            if self.session is not None:
                self.ctx.workers.barrier()  # rank 0's spill files are whole
            host = read_rows(man, 0, man.num_rows)
        finally:
            if cleanup:
                shutil.rmtree(writer.directory, ignore_errors=True)
        key = host[B.by]
        if B.descending:
            # the same order-reversing map local_sort uses: exact for ints,
            # sign-flip for floats; stable argsort keeps global row order
            # among equal keys (matching the eager shuffle arrival order)
            key = -key if np.issubdtype(key.dtype, np.floating) \
                else np.bitwise_not(key)
        order = np.argsort(key, kind="stable")
        host = {k: v[order] for k, v in host.items()}
        out = self._from_host(host, schema)
        self._stage_span(stage, "sort", t0, batches=cursor["k"])
        arrays, meta = self._ddf_arrays(out)
        self._stage_done(stage, "sort", meta, arrays)
        return out

    def _spill_buckets(self, side: Node, on: tuple, nb: int):
        """Stream (or eagerly compute) one join side into key-hash buckets."""
        if not _has_scan(side):
            raise AssertionError(
                "spill join is only reachable with scans on both sides")
        stage, entry, resume = self._stage_enter("buckets")
        schema = schema_of(side)
        norm = normalize_schema(schema)
        if entry is not None:
            return [DatasetManifest(d, norm,
                                    tuple((f, int(r)) for f, r in ch))
                    for d, ch in zip(entry["meta"]["dirs"],
                                     entry["meta"]["chunks"])]
        t0 = _trace.now()
        cursor = {"k": 0}
        if self.session is not None:
            chunks_by_b = [None] * nb
            buf_by_b: list = [None] * nb
            if resume is not None:
                rmeta, rarr = resume
                cursor["k"] = int(rmeta["k"])
                for b in range(nb):
                    chunks_by_b[b] = [(f, int(r)) for f, r in rmeta["chunks"][b]]
                    pre = f"b{b}/"
                    buf = {k[len(pre):]: v for k, v in rarr.items()
                           if k.startswith(pre)}
                    buf_by_b[b] = buf or None
            writers = [self._stage_spill_writer(f"stage{stage}/b{b}", schema,
                                                 chunks=chunks_by_b[b],
                                                 buffered=buf_by_b[b])
                       for b in range(nb)]
        else:
            writers = [self._spill_writer(schema) for _ in range(nb)]

        def snap():
            metas, arrays = [], {}
            for b, w in enumerate(writers):
                chunks, buf = w.state()
                metas.append([[f, int(r)] for f, r in chunks])
                for n, v in buf.items():
                    arrays[f"b{b}/{n}"] = v
            return {"k": cursor["k"], "chunks": metas}, arrays

        if self.session is not None:
            self.session.set_active(stage, snap)
        for k, host in self._stream_host(side, start=cursor["k"],
                                         scope=f"s{stage}"):
            cursor["k"] = k + 1
            if len(next(iter(host.values()))):
                h = _np_hash_columns(host, on) % np.uint32(nb)
                for b in range(nb):
                    m = h == b
                    if m.any():
                        self._spill_append(writers[b],
                                           {c: v[m] for c, v in host.items()})
            self._tick()
            yield "bucket-spill"
        mans = [w.close() for w in writers]
        if self.session is not None:
            self.ctx.workers.barrier()  # rank 0's bucket files are whole
        self._stage_span(stage, "buckets", t0, batches=cursor["k"],
                         buckets=nb)
        self._stage_done(stage, "buckets",
                         {"dirs": [m.directory for m in mans],
                          "chunks": [[[f, int(r)] for f, r in m.chunks]
                                     for m in mans]}, {})
        return mans

    def _stream_join_spill(self, B: Join) -> DDF:
        """Out-of-core join with scans on both sides: hash-bucket spill.

        Each side spills into ``nb`` key-hash buckets (equal keys share a
        bucket), then bucket pairs are joined on device one at a time —
        neither side's build table ever has to fit device capacity. Output
        order is bucket-major (row-set equal to the eager join; a downstream
        sort/groupby canonicalizes it). Under a checkpoint session the two
        bucket spills and the bucket-join loop are three separate stages —
        the join loop's snapshot carries the bucket cursor, the adaptive
        ``cap_out``/``quota`` (their growth is deterministic, so a resumed
        run continues with the same buffer sizes), and the concatenated
        output accumulated so far."""
        on = B.on
        per_side_rows = []
        for side in (B.left, B.right):
            sids = [n.sid for n in walk(side) if isinstance(n, Scan)]
            per_side_rows.append(sum(self.scans[s].num_rows for s in sids))
        br = self.nominal_batch_rows or max(max(per_side_rows), 1)
        nb = max(-(-2 * max(per_side_rows) // br), 1)
        mans_l = yield from self._spill_buckets(B.left, on, nb)
        mans_r = yield from self._spill_buckets(B.right, on, nb)
        stage, entry, resume = self._stage_enter("bucketjoin")
        if entry is not None:
            return self._restore_ddf(entry)
        t0 = _trace.now()
        schema = schema_of(B)
        cap_l = max(max((m.num_rows for m in mans_l), default=0) // self.P + 1, 1)
        cap_r = max(max((m.num_rows for m in mans_r), default=0) // self.P + 1, 1)
        sid_l, sid_r = next(_SIDS), next(_SIDS)
        state = {"j": 0,
                 "quota": int(B.quota or default_quota(max(cap_l, cap_r),
                                                       self.P)),
                 "cap_out": int(B.capacity or 2 * max(cap_l, cap_r))}
        outs: list[dict] = []
        if resume is not None:
            rmeta, rarr = resume
            state.update(j=int(rmeta["j"]), quota=int(rmeta["quota"]),
                         cap_out=int(rmeta["cap_out"]))
            acc = {n: rarr[f"acc/{n}"] for n, _, _ in schema
                   if f"acc/{n}" in rarr}
            if acc:
                outs.append(acc)

        def snap():
            host = {n: np.concatenate([o[n] for o in outs])
                    for n, _, _ in schema} if outs else {}
            return ({"j": state["j"], "quota": state["quota"],
                     "cap_out": state["cap_out"]},
                    {f"acc/{n}": v for n, v in host.items()})

        if self.session is not None:
            self.session.set_active(stage, snap)
        rb_l = row_bytes_of(schema_of(B.left))
        rb_r = row_bytes_of(schema_of(B.right))
        rb_out = row_bytes_of(schema)
        try:
            for j in range(state["j"], nb):
                self._note_working_set(
                    self.P * (cap_l * rb_l + cap_r * rb_r
                              + state["cap_out"] * rb_out))
                ml, mr = mans_l[j], mans_r[j]
                if ml.num_rows == 0 or mr.num_rows == 0:
                    state["j"] = j + 1
                    continue
                dl = DDF.from_numpy(read_rows(ml, 0, ml.num_rows), self.ctx,
                                    capacity=cap_l, mode="eager")
                dr = DDF.from_numpy(read_rows(mr, 0, mr.num_rows), self.ctx,
                                    capacity=cap_r, mode="eager")
                while True:
                    # adaptive sizing: join multiplicity is data-dependent,
                    # so grow the static buffers and retry the bucket when
                    # pairs (capacity) or skewed keys (quota) overflow
                    jroot = Join(Source(sid_l, mans_l[0].schema, cap_l),
                                 Source(sid_r, mans_r[0].schema, cap_r),
                                 on, strategy="auto", quota=state["quota"],
                                 capacity=state["cap_out"])

                    def run(jroot=jroot, dl=dl, dr=dr):
                        return executor.execute(
                            jroot, self.ctx, {sid_l: dl, sid_r: dr},
                            src_rows={sid_l: cap_l * self.P,
                                      sid_r: cap_r * self.P})

                    out, aux = self._guarded("device_op", run)
                    ovj = sum(int(_host(v).sum()) for k, v in aux.items()
                              if "overflow_join" in k)
                    ovs = sum(int(_host(v).sum()) for k, v in aux.items()
                              if "overflow" in k and "overflow_join" not in k)
                    if not ovj and not ovs:
                        self._fold_aux([aux], scope=f"s{stage}")
                        break
                    if ovj:
                        state["cap_out"] *= 2
                    if ovs:
                        state["quota"] *= 2
                outs.append(out.to_numpy())
                state["j"] = j + 1
                self._tick()
                yield "bucket-join"
        finally:
            if self.session is None:
                for m in mans_l + mans_r:
                    shutil.rmtree(m.directory, ignore_errors=True)
        host = {n: np.concatenate([o[n] for o in outs])
                for n, _, _ in schema} if outs else {}
        out = self._from_host(host, schema)
        self._stage_span(stage, "bucketjoin", t0, buckets=nb)
        arrays, meta = self._ddf_arrays(out)
        self._stage_done(stage, "bucketjoin", meta, arrays)
        return out

    # -- staged materialization --------------------------------------------------
    def _collect_scanfree(self, root: Node):
        srcs = {n.sid: self.sources[n.sid] for n in walk(root)
                if isinstance(n, Source)}
        if isinstance(root, Source):
            return srcs[root.sid], {}
        return self._guarded("device_op",
                             lambda: executor.execute(root, self.ctx, srcs))

    def _materialize_blocking(self, B: Node):
        """Step generator: finalize one blocking node, returning its DDF."""
        if isinstance(B, GroupBy) and _streamable(B.child) and _has_scan(B.child):
            return (yield from self._stream_groupby(B))
        if isinstance(B, Unique) and _streamable(B.child) and _has_scan(B.child):
            return (yield from self._stream_unique(B))
        if isinstance(B, Sort) and _streamable(B.child) and _has_scan(B.child):
            return (yield from self._stream_sort(B))
        if (isinstance(B, Join) and _has_scan(B.left) and _has_scan(B.right)
                and _streamable(B.left) and _streamable(B.right)):
            return (yield from self._stream_join_spill(B))
        # generic fallback: materialize scan-bearing children individually,
        # then run the (now scan-free) blocking op eagerly. The wrapping
        # stage completes after its recursive child stages, so its recorded
        # stage_end fast-forwards the counter past them on resume.
        stage, entry, _ = self._stage_enter("blocking")
        if entry is not None:
            return self._restore_ddf(entry)
        kids = []
        for c in B.children:
            if _has_scan(c):
                d = yield from self._collect_node(c)
                sid = next(_SIDS)
                self.sources[sid] = d
                kids.append(Source(sid, _ddf_schema(d), d.capacity))
            else:
                kids.append(c)
        out, aux = self._collect_scanfree(B.with_children(kids))
        self._fold_aux([aux], scope=f"s{stage}")
        yield "device"
        arrays, meta = self._ddf_arrays(out)
        self._stage_done(stage, "blocking", meta, arrays)
        return out

    def _drain_blocking(self, root: Node):
        """Step generator: finalize blocking nodes bottom-up until the plan
        is streamable (or scan-free), substituting each result back as a
        Source; returns the rewritten plan root."""
        while _has_scan(root) and not _streamable(root):
            B = _find_blocking(root)
            if B is None:  # cannot happen; guard against infinite loop
                raise RuntimeError("unstreamable plan with no blocking node")
            mat = yield from self._materialize_blocking(B)
            sid = next(_SIDS)
            self.sources[sid] = mat
            root = _replace_node(root, B, Source(sid, _ddf_schema(mat),
                                                 mat.capacity))
        return root

    def _collect_node(self, root: Node):
        """Step generator: evaluate a plan subtree, returning its DDF."""
        root = yield from self._drain_blocking(root)
        if _has_scan(root):
            return (yield from self._stream_concat(root))
        out, aux = self._collect_scanfree(root)
        self._fold_aux([aux])
        yield "device"
        return out

    # -- public entry points -----------------------------------------------------
    def steps(self):
        """The whole query as one externally drivable step generator.

        Yields one event string per morsel of work (the scheduling quantum:
        a scan batch, a spilled bucket join, a scan-free device dispatch)
        and returns ``(result DDF, info dict)``. Closing the generator
        mid-run cancels the query cooperatively — the runner's ``finally``
        blocks release spill/prefetch resources on the way out."""
        out = yield from self._collect_node(self.root)
        if self.session is not None:
            self.session.finish()
        return out, self._info_view()

    def run(self):
        return _drain(self.steps())

    def batches(self) -> Iterator[dict]:
        root = _drain(self._drain_blocking(self.root))
        if _has_scan(root):
            stage, entry, resume = self._stage_enter("emit")
            if entry is None:
                cursor = {"k": int(resume[0]["k"]) if resume is not None else 0}
                if self.session is not None:
                    self.session.set_active(
                        stage, lambda: ({"k": cursor["k"]}, {}))
                for k, host in self._stream_host(root, start=cursor["k"],
                                                 scope=f"s{stage}"):
                    yield host
                    cursor["k"] = k + 1
                    self._tick()
                self._stage_done(stage, "emit", {}, {})
            if self.session is not None:
                self.session.finish()
            return
        out, aux = self._collect_scanfree(root)
        self._fold_aux([aux])
        host = out.to_numpy()
        total = len(next(iter(host.values()))) if host else 0
        step = self.nominal_batch_rows or max(total, 1)
        for lo in range(0, max(total, 1), step):
            yield {k: v[lo:lo + step] for k, v in host.items()}
        if self.session is not None:
            self.session.finish()


class StreamExecution:
    """Externally drivable streaming execution of one lazy query.

    Where :func:`collect` drives every morsel back to back,
    ``StreamExecution`` exposes the runner's step generator so an external
    scheduler can interleave cost-model-sized morsels from *many* queries
    over one card::

        ex = StreamExecution(lazy, batch_rows=..., checkpoint_dir=...)
        for event in ex.steps():   # one event per morsel — yield here to
            ...                    # run a morsel of some *other* query
        out, info = ex.result, ex.info

    Args match :func:`collect`. ``steps()`` may be called once; the result
    DDF and info counters are populated when the generator is exhausted.
    Closing the generator early cancels the query cooperatively (spill and
    prefetch state is released by the runner's ``finally`` blocks).
    """

    def __init__(self, lazy, **opts):
        self._runner = _Runner(lazy, **opts)
        self._started = False
        self.result: DDF | None = None
        self.info: dict | None = None

    @property
    def nominal_batch_rows(self) -> int | None:
        """Cost-model global rows per morsel (None for scan-free plans)."""
        return self._runner.nominal_batch_rows

    def steps(self) -> Iterator[str]:
        """Yield one event string per morsel; populates ``result``/``info``
        on exhaustion. Single-shot: a second call raises ``RuntimeError``."""
        if self._started:
            raise RuntimeError("StreamExecution.steps() may only be called "
                               "once per execution")
        self._started = True
        self.result, self.info = yield from self._runner.steps()


def collect(lazy, batch_rows: int | None = None, prefetch: bool = True,
            carry_capacity: int | None = None, spill_dir: str | None = None,
            spill_compress: bool = False, strict_overflow: bool = True,
            checkpoint_dir: str | None = None, checkpoint_every: int = 4,
            resume: bool = False, max_retries: int = 2,
            retry_backoff_s: float = 0.05, adaptive: bool = False,
            replan_every: int | None = None):
    """Run a scan-bearing lazy plan through the streaming engine.

    Args:
      lazy: the ``LazyDDF`` to execute (``repro_torch.stream.scan_*`` leaves).
      batch_rows: override the cost-model batch size (global rows/batch).
      prefetch: overlap host decode of batch k+1 with the card's work on
        batch k (double buffering); False decodes serially (A/B baseline).
      carry_capacity: per-worker capacity of groupby/unique carry state
        (default: scan rows / workers, the eager-equivalent bound).
      spill_dir: parent directory for spill datasets (default: system tmp).
      spill_compress: compress spilled chunks (saves disk, costs CPU).
      strict_overflow: raise when any static shuffle/join buffer overflowed
        (rows dropped) instead of silently diverging from eager results.
      checkpoint_dir: enable fault-tolerant execution — snapshot the full
        per-query state (scan cursor, carry tables, spill manifests, info
        counters) into this directory every ``checkpoint_every`` morsels
        via an atomic publish; cleared on success.
      checkpoint_every: morsels between snapshots (lower = less recompute
        after a crash, more publish overhead).
      resume: restart from the newest snapshot under ``checkpoint_dir``
        (falls back to a fresh run when none exists; raises ``ValueError``
        if the snapshot belongs to a different query). The resumed result
        is bit-identical to an uninterrupted run.
      max_retries: in-place re-executions per failed unit of work (morsel
        decode / device op / spill append / checkpoint publish) before the
        error propagates; only retryable errors are retried (see
        ``repro_torch.stream.recovery.RETRYABLE_EXCEPTIONS``).
      retry_backoff_s: base of the bounded exponential retry backoff.
      adaptive: enable mid-stream re-planning — an
        ``repro_torch.stats.AdaptiveController`` corrects quota/capacity for
        later morsels of carry-fold stages (groupby/unique) from observed
        batch key histograms; results stay bit-identical (corrections
        only resize static buffers), ``info["replans"]`` counts the
        plan revisions, and the controller state rides the checkpoint so
        resumed runs make the same decisions.
      replan_every: batches between adaptive re-plan decision points
        (default ``cost_model.ADAPTIVE_REPLAN_EVERY``).

    Returns:
      ``(result DDF, info dict)`` — info carries ``batches`` plus summed
      per-batch overflow counters (namespaced ``s<stage>:`` per streaming
      stage), ``retries:<site>`` counts, ``checkpoints`` published,
      ``chunks_decoded`` / ``chunks_skipped`` (statistics-layer chunk
      skipping on absorbed scan predicates), ``replans``, and the
      observed ``peak_working_set_bytes`` (which the reference's query
      service's admission controller learns from). The numeric counters
      come from a per-run ``repro_torch.obs`` metrics registry parented to
      the global one.
    """
    r = _Runner(lazy, batch_rows=batch_rows, prefetch=prefetch,
                carry_capacity=carry_capacity, spill_dir=spill_dir,
                spill_compress=spill_compress, strict_overflow=strict_overflow,
                checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                resume=resume, max_retries=max_retries,
                retry_backoff_s=retry_backoff_s, adaptive=adaptive,
                replan_every=replan_every)
    return r.run()


def to_batches(lazy, batch_rows: int | None = None, prefetch: bool = True,
               carry_capacity: int | None = None, spill_dir: str | None = None,
               spill_compress: bool = False, strict_overflow: bool = True,
               checkpoint_dir: str | None = None, checkpoint_every: int = 4,
               resume: bool = False, max_retries: int = 2,
               retry_backoff_s: float = 0.05, adaptive: bool = False,
               replan_every: int | None = None) -> Iterator[dict]:
    """Stream a lazy plan's result as host column-dict batches.

    Fully-streamable plans yield one dict per morsel without materializing
    the whole result (true out-of-core iteration); plans needing carry or
    spill finalization finalize first and yield ``batch_rows``-sized slices
    of the final table. Args as :func:`collect`; with ``resume=True`` the
    iterator re-yields from the last snapshotted cursor (batches already
    consumed after that snapshot are yielded again).
    """
    r = _Runner(lazy, batch_rows=batch_rows, prefetch=prefetch,
                carry_capacity=carry_capacity, spill_dir=spill_dir,
                spill_compress=spill_compress, strict_overflow=strict_overflow,
                checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                resume=resume, max_retries=max_retries,
                retry_backoff_s=retry_backoff_s, adaptive=adaptive,
                replan_every=replan_every)
    yield from r.batches()
