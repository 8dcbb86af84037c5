"""User-facing distributed dataframe API (paper §2.1, Fig. 2b).

``DDF`` is the virtual collection of row partitions. In the reference its
columns are sharded over a mesh of P devices; here the partitions a process
holds are ``(local, capacity)`` tensors with per-worker live counts
``(local,)``: all P of them on one card, or with ``DDFContext(group=...)``
a rank's block of ``P / world`` workers of a ``torch.distributed`` process
group (NCCL on cards, gloo on the CPU). Every method runs eagerly, so no
compiled-operator cache is needed. Planning (quota / capacity / strategy)
is host-side via ``patterns``, from global values only, so that every rank
takes the same decision.

Auxiliary outputs (overflow counters, pivots, flags) come back as tensors
with one entry per worker held, as the reference's leading per-worker
axis. ``to_numpy`` and ``partitions`` return all P workers on every rank.

String columns are dict-encoded (``core.vocab``): the device holds int32
codes, the DDF a host vocabulary per such column, and the binary operators
(join, union, difference) recode both sides into one merged vocabulary
first.

``DDF.lazy()`` and ``DDF.from_numpy(..., mode="lazy")`` give a
``repro_torch.plan.LazyDDF``, whose executor composes a whole optimized
plan into one callable; :func:`cached_op` keeps those callables. Lazy
plans, streaming and the query service run over a group as the eager
methods do: every rank makes the same calls in the same order.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from .. import expr as _expr
from ..device import resolve_device
from . import operators, patterns
from .comm.communicator import Communicator, make_communicator
from .comm.group import WorkerBlock
from .dataframe import Table, canonical_numpy, from_numpy, map_rows, to_numpy, torch_dtype
from .local_ops import select as local_select
from .local_ops import with_column as local_with_column
from .partition import default_quota
from .vocab import DictVocab, encode_strings, is_string_array

__all__ = ["DDFContext", "DDF", "cached_op", "callable_signature"]


class _LRUCache:
    """Bounded least-recently-used cache for the plan executor's callables
    and optimized plans. Keys are stable signatures; entries past
    ``maxsize`` are evicted least recently used first. Thread-safe, with
    hit/miss/eviction counts (:meth:`stats`)."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._d: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            try:
                self._d.move_to_end(key)
                val = self._d[key]
            except KeyError:
                self.misses += 1
                return None
            self.hits += 1
            return val

    def put(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)
                self.evictions += 1

    def stats(self) -> dict:
        """Telemetry snapshot: ``{hits, misses, evictions, size, maxsize}``."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._d),
                    "maxsize": self.maxsize}

    def __len__(self):
        with self._lock:
            return len(self._d)


_OP_CACHE = _LRUCache(maxsize=256)


def cached_op(ctx: "DDFContext", key: tuple, build: Callable[[], Callable],
              arg_schemas: tuple) -> Callable:
    """Fetch-or-build the callable for (context, op key, argument schemas).
    The reference compiles a jitted shard_map here and keys it on its mesh;
    one card has no compile step, so a miss calls ``build()`` (the plan
    executor composes its callable there) and a hit skips it. The key holds
    the worker count and the device, and the kernel routing
    (``kernels.registry.dispatch_signature``), so a callable made under one
    backend never serves another."""
    from ..kernels import registry as _kernel_registry

    cache_key = (ctx.nworkers, str(ctx.device), key, arg_schemas,
                 _kernel_registry.dispatch_signature())
    op = _OP_CACHE.get(cache_key)
    if op is None:
        op = build()
        _OP_CACHE.put(cache_key, op)
    return op


def _schema_sig(ddf: "DDF") -> tuple:
    return tuple((k, str(v.dtype), tuple(v.shape)) for k, v in sorted(ddf.columns.items()))


def callable_signature(fn: Callable) -> tuple:
    """Best-effort stable identity for a user callable (predicate or map
    function): code location, bytecode hash and the hashable constants,
    defaults and closure values. Two lambdas that differ only in a captured
    constant get different signatures; values are kept raw where hashable,
    so hash-equal but unequal values (``hash(-1) == hash(-2)``) stay apart,
    and unhashable ones fall back to their identity."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return (repr(fn),)

    def ident(v):
        try:
            hash(v)
            return v
        except TypeError:
            return id(v)

    cells = tuple(ident(c.cell_contents)
                  for c in (getattr(fn, "__closure__", None) or ()))
    defaults = tuple(ident(v) for v in (getattr(fn, "__defaults__", None) or ()))
    # co_consts / co_names tell apart same-line lambdas that differ only in
    # a literal or a referenced column name (identical co_code)
    consts = tuple(ident(v) for v in code.co_consts)
    return (code.co_filename, code.co_firstlineno, hash(code.co_code),
            code.co_names, consts, defaults, cells)


@dataclasses.dataclass(frozen=True)
class DDFContext:
    """Execution environment: P workers on one device (the card unless the
    caller asks for the CPU), or with ``group`` (a ``torch.distributed``
    process group, e.g. ``torch.distributed.group.WORLD`` after
    ``core.comm.group.init_from_env()``) spread over its ranks: rank ``r``
    holds the global workers ``[r * P / world, (r + 1) * P / world)`` on
    its own device, ``cuda:LOCAL_RANK`` unless the caller names one.
    ``P % world`` must be 0; there is no fallback to fewer ranks or to the
    CPU."""

    nworkers: int = 1
    device: torch.device | str | None = None
    group: object = None
    workers: WorkerBlock = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.nworkers < 1:
            raise ValueError(f"nworkers must be >= 1, got {self.nworkers}")
        dev = resolve_device(self.device, per_rank=self.group is not None)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "workers", WorkerBlock(self.nworkers, dev, self.group))

    def comm(self) -> Communicator:
        return make_communicator(self.nworkers, self.device, self.group)


def _check_column(name: str, v: np.ndarray):
    """(device values, vocab or None): strings become int32 codes with
    their sorted vocabulary; other columns take their canonical dtype."""
    if is_string_array(v):
        return encode_strings(v)
    if v.dtype.kind == "O":
        raise TypeError(f"column {name!r}: object arrays are not columns; pass "
                        "a numpy string or numeric array")
    v = canonical_numpy(v)
    torch_dtype(v.dtype)  # raises on dtypes the port has no tensor type for
    return v, None


@dataclasses.dataclass
class DDF:
    """Distributed dataframe: columns (P, capacity) + counts (P,) int32."""

    columns: dict[str, torch.Tensor]
    counts: torch.Tensor
    ctx: DDFContext
    #: host vocabularies of the dict-encoded string columns (name ->
    #: ``DictVocab``); their device columns hold int32 codes
    vocabs: dict = dataclasses.field(default_factory=dict)
    # host-side caches: the global row count and the lazy handle
    _nrows: int | None = dataclasses.field(default=None, repr=False, compare=False)
    _lazy_cache: object = dataclasses.field(default=None, repr=False, compare=False)

    # -- metadata --------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[1]

    @property
    def column_names(self) -> tuple:
        return tuple(sorted(self.columns))

    def table(self) -> Table:
        """The partitions held here as a batched :class:`Table`."""
        return Table(self.columns, self.counts)

    def _all_workers(self) -> Table:
        """Every worker's partition, on every rank."""
        gather = self.ctx.workers.gather_workers
        return Table({k: gather(v) for k, v in self.columns.items()}, gather(self.counts))

    def num_rows(self) -> int:
        """Global live-row count over every worker (a device->host sync;
        cached)."""
        if self._nrows is None:
            self._nrows = int(self.ctx.workers.gather_workers(self.counts).sum().item())
        return self._nrows

    # -- construction ------------------------------------------------------------
    @classmethod
    def from_numpy(cls, data: Mapping[str, np.ndarray], ctx: DDFContext,
                   capacity: int | None = None, mode: str | None = None):
        """Partitioned input: rows split contiguously across workers
        (paper §5.3.8), ceil(n / P) per worker unless ``capacity`` is given.
        String columns are dict-encoded.

        ``mode`` picks the handle: "eager" returns this ``DDF``, whose
        methods run at once; "lazy" a ``repro_torch.plan.LazyDDF``, which
        builds a plan and runs it at ``collect()``. None asks
        ``repro_torch.plan.get_default_mode()``."""
        checked, vocabs = {}, {}
        for k, v in data.items():
            checked[k], vocab = _check_column(k, np.asarray(v))
            if vocab is not None:
                vocabs[k] = vocab
        blk = ctx.workers
        t = from_numpy(checked, ctx.nworkers, capacity, ctx.device,
                       workers=range(blk.lo, blk.hi))
        ddf = cls(t.columns, t.nvalid, ctx, vocabs)
        if mode is None:
            from .. import plan  # plan imports this module
            mode = plan.get_default_mode()
        return ddf.lazy() if mode == "lazy" else ddf

    @classmethod
    def from_partitions(cls, columns: Mapping[str, np.ndarray], counts: np.ndarray,
                        ctx: DDFContext, vocabs: Mapping[str, Sequence[str]] | None = None
                        ) -> "DDF":
        """The partition layout of a reference DDF: its padded global columns
        (P * capacity,) and per-worker counts (P,), as
        ``np.asarray(ddf.columns[k])`` and ``np.asarray(ddf.counts)`` give
        them; ``vocabs`` maps each dict-encoded column to its vocabulary's
        words (``ddf.vocabs[k].words``). Over a group every rank passes the
        global layout and keeps its block of workers."""
        nw, lo, hi = ctx.nworkers, ctx.workers.lo, ctx.workers.hi
        counts = np.asarray(counts).astype(np.int32)
        if counts.shape != (nw,):
            raise ValueError(f"counts must have shape ({nw},), got {counts.shape}")
        cols = {}
        for k, v in columns.items():
            v, _ = _check_column(k, np.asarray(v))
            if v.ndim < 1 or v.shape[0] % nw:
                raise ValueError(f"column {k!r}: expected (P * capacity, ...), got {v.shape}")
            v = v.reshape((nw, -1) + v.shape[1:])[lo:hi]
            cols[k] = torch.from_numpy(np.array(v)).to(ctx.device)
        vocabs = {k: DictVocab(tuple(w)) for k, w in (vocabs or {}).items()}
        return cls(cols, torch.from_numpy(counts[lo:hi].copy()).to(ctx.device), ctx, vocabs)

    def _decode(self, k: str, v: np.ndarray) -> np.ndarray:
        return self.vocabs[k].decode(v) if k in self.vocabs else v

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Every worker's live rows to host, in partition order (on every
        rank of a group); dict-encoded columns come back decoded."""
        return {k: self._decode(k, v) for k, v in to_numpy(self._all_workers()).items()}

    def partitions(self) -> list[dict[str, np.ndarray]]:
        """Per worker, all P of them on every rank, its live rows as numpy
        (host), decoded."""
        t = self._all_workers()
        counts = t.nvalid.cpu().numpy()
        host = {k: v.cpu().numpy() for k, v in t.columns.items()}
        return [{k: self._decode(k, v[w, : counts[w]]) for k, v in host.items()}
                for w in range(self.ctx.nworkers)]

    def _ddf(self, table: Table, vocabs: Mapping[str, DictVocab] | None = None) -> "DDF":
        """A DDF of ``table``'s rows with the vocabularies of the columns it
        has."""
        vocabs = vocabs or {}
        return DDF(dict(table.columns), table.nvalid, self.ctx,
                   {n: v for n, v in vocabs.items() if n in table.columns})

    def _check_columns(self, names: Sequence[str], op: str) -> None:
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise KeyError(f"{op}: unknown column(s) {missing}; "
                           f"available schema: {sorted(self.columns)}")

    # -- dict-encoded string columns ----------------------------------------------
    def _recode(self, mappings: Mapping[str, np.ndarray]) -> "DDF":
        """Apply per-column int32 gather maps (``new = map[old]``), the
        device half of vocabulary unification."""
        cols = dict(self.columns)
        for n, m in mappings.items():
            if n in cols:
                lut = torch.from_numpy(np.asarray(m, dtype=np.int32)).to(self.ctx.device)
                # padding slots hold any int32 (a groupby's min/max identity):
                # index as jax does, negatives from the end, then clamped
                codes = cols[n].to(torch.int64)
                codes = torch.where(codes < 0, codes + len(lut), codes)
                cols[n] = lut[codes.clamp(0, len(lut) - 1)]
        return DDF(cols, self.counts, self.ctx, dict(self.vocabs))

    def _unify_vocabs_with(self, other: "DDF", op: str):
        """Vocabulary unification at a binary operator: merge each shared
        dict column's vocabularies on the host and recode both sides into
        the merged code space. Returns ``(left, right, merged)``, merged
        covering every dict column of either side."""
        mixed = sorted(n for n in set(self.vocabs) ^ set(other.vocabs)
                       if n in self.columns and n in other.columns)
        if mixed:
            raise TypeError(
                f"{op}: column(s) {mixed} are dict-encoded strings on one "
                f"side but plain numerics on the other — codes and raw "
                f"values are not comparable; encode both sides or neither")
        merged = {**other.vocabs, **self.vocabs}
        lmaps, rmaps = {}, {}
        for n in sorted(set(self.vocabs) & set(other.vocabs)):
            lv, rv = self.vocabs[n], other.vocabs[n]
            if lv.words == rv.words:
                continue
            mv = lv.merge(rv)
            merged[n] = mv
            if not lv.is_identity_into(mv):
                lmaps[n] = lv.recode_map(mv)
            if not rv.is_identity_into(mv):
                rmaps[n] = rv.recode_map(mv)
        left, right = self._recode(lmaps), other._recode(rmaps)
        left.vocabs = {n: merged[n] for n in self.vocabs}
        right.vocabs = {n: merged[n] for n in other.vocabs}
        return left, right, merged

    # -- embarrassingly parallel (paper §5.3.1) ----------------------------------
    def select(self, pred, name: str = "pred") -> "DDF":
        """Filter rows by a boolean expression: ``select(col("a") > 3)``.

        The expression is validated against the schema (unknown columns
        raise ``KeyError``), constant-folded, string literals bound to the
        vocabularies, and lowered with the reference's dtypes. A Python
        callable over the column dict is deprecated (one-shot
        ``DeprecationWarning``) but still runs. ``name`` is the reference's
        cache-key label; nothing is cached here."""
        if isinstance(pred, (_expr.Expr, bool)) or _expr.is_when_builder(pred):
            pred = _expr.prepare_row_expr(pred, self.columns, "select",
                                          vocabs=self.vocabs or None)
            fn = _expr.to_torch_fn(pred)
        else:
            _expr.warn_callable_deprecated("select")
            fn = pred
        return self._ddf(local_select(self.table(), fn), self.vocabs)

    def with_column(self, name: str, value) -> "DDF":
        """Add (or overwrite) column ``name`` from an expression:
        ``with_column("c", col("a") + col("b"))``. Scalars are coerced to
        literals and broadcast; all other columns pass through."""
        e = _expr.prepare_row_expr(value, self.columns, "with_column",
                                   vocabs=self.vocabs or None)
        out = local_with_column(self.table(), name, _expr.to_torch_fn(e))
        return self._ddf(out, {n: v for n, v in self.vocabs.items() if n != name})

    def project(self, names: Sequence[str]) -> "DDF":
        """Column projection (zero-copy). Unknown names raise ``KeyError``."""
        self._check_columns(names, "project")
        return DDF({n: self.columns[n] for n in names}, self.counts, self.ctx,
                   {n: v for n, v in self.vocabs.items() if n in names})

    def drop(self, names: Sequence[str]) -> "DDF":
        """Drop columns -- the inverse of :meth:`project`."""
        names = tuple(names)
        self._check_columns(names, "drop")
        gone = set(names)
        return DDF({k: v for k, v in self.columns.items() if k not in gone},
                   self.counts, self.ctx,
                   {k: v for k, v in self.vocabs.items() if k not in gone})

    def rename(self, mapping: Mapping[str, str]) -> "DDF":
        """Column rename (zero-copy). Unknown source names raise
        ``KeyError``; colliding target names raise ``ValueError``."""
        self._check_columns(tuple(mapping), "rename")
        targets = [mapping.get(k, k) for k in self.columns]
        dup = {t for t in targets if targets.count(t) > 1}
        if dup:
            raise ValueError(f"rename: duplicate target column(s) {sorted(dup)}")
        return DDF({mapping.get(k, k): v for k, v in self.columns.items()},
                   self.counts, self.ctx,
                   {mapping.get(k, k): v for k, v in self.vocabs.items()})

    def map_columns(self, fn, name: str = "map") -> "DDF":
        """Legacy column-wise map over the raw column dict (deprecated --
        one-shot ``DeprecationWarning``; use :meth:`with_column` /
        :meth:`project`). As in the reference, the result carries no
        vocabularies; ``name`` is the reference's cache-key label."""
        _expr.warn_callable_deprecated("map_columns")
        return self._ddf(map_rows(self.table(), fn))

    # -- loosely synchronous ----------------------------------------------------
    def join(self, other: "DDF", on: Sequence[str], strategy: str = "auto",
             quota: int | None = None, capacity: int | None = None,
             num_chunks: int = 1):
        """Equi-join. ``strategy="auto"`` lets the planner pick hash-shuffle
        vs broadcast; ``num_chunks > 1`` runs the chunked shuffle
        (1 = monolithic all-to-all).

        Returns (joined DDF, {"overflow_*": (P,) int32})."""
        on = tuple(on)
        self._check_columns(on, "join")
        other._check_columns(on, "join")
        left, right, merged = self._unify_vocabs_with(other, "join")
        nw = self.ctx.nworkers
        if strategy == "auto":
            plan = patterns.plan_join(left.num_rows(), right.num_rows(), nw, left.capacity)
            strategy = plan.strategy
        quota = quota or default_quota(left.capacity, nw)
        capacity = capacity or 2 * left.capacity
        comm = self.ctx.comm()
        if strategy == "broadcast":
            gather = "left" if left.num_rows() <= right.num_rows() else "right"
            out, info = operators.dist_join_broadcast(
                comm, left.table(), right.table(), on, capacity, gather=gather)
        elif strategy == "shuffle":
            out, info = operators.dist_join_shuffle(
                comm, left.table(), right.table(), on, quota, capacity,
                num_chunks=num_chunks)
        else:
            raise ValueError(f"unknown join strategy {strategy!r}")
        return self._ddf(out, merged), info

    def groupby(self, by: Sequence[str], aggs,
                pre_combine: bool | None = None, cardinality_hint: float | None = None,
                quota: int | None = None, capacity: int | None = None,
                num_chunks: int = 1):
        """GroupBy-aggregate. ``aggs`` is the canonical mapping
        ``{value_col: (op, ...)}`` or a sequence of aggregation expressions
        (``[col("v").sum(), col("v").mean().alias("avg")]``; aliases apply
        as a rename of the result). With ``pre_combine=None`` the planner
        picks combine-shuffle-reduce vs plain shuffle (from
        ``cardinality_hint``); ``num_chunks > 1`` runs the chunked shuffle.

        Returns (aggregated DDF, {"overflow_shuffle", "overflow_agg"})."""
        renames: tuple = ()
        if not isinstance(aggs, Mapping):
            aggs, renames = _expr.parse_agg_specs(aggs)
        by = tuple(by)
        aggs = {k: tuple(v) for k, v in aggs.items()}
        self._check_columns(by, "groupby(by)")
        self._check_columns(sorted(aggs), "groupby(aggs)")
        bad = sorted(f"{c}.{o}" for c, ops_ in aggs.items() for o in ops_
                     if c in self.vocabs and o in ("sum", "mean"))
        if bad:
            raise TypeError(
                f"groupby: aggregation(s) {bad} are arithmetic over a "
                f"dict-encoded string column — codes have order but no "
                f"arithmetic; only min/max/count apply to strings")
        out_vocabs = dict(self.vocabs)
        for c, ops_ in aggs.items():
            if c in self.vocabs:  # ordered aggs of a dict column stay dict
                for o in ops_:
                    if o in ("min", "max"):
                        out_vocabs[f"{c}_{o}"] = self.vocabs[c]
        nw = self.ctx.nworkers
        if pre_combine is None:
            card = cardinality_hint if cardinality_hint is not None else 0.0
            plan = patterns.plan_groupby(card, nw, capacity or self.capacity)
            pre_combine = plan.strategy == "combine_shuffle_reduce"
        quota = quota or default_quota(self.capacity, nw)
        capacity = capacity or self.capacity
        out, info = operators.dist_groupby(
            self.ctx.comm(), self.table(), by, aggs, quota, capacity, pre_combine,
            num_chunks=num_chunks)
        res = self._ddf(out, out_vocabs)
        if renames:
            res = res.rename(dict(renames))
        return res, info

    def unique(self, subset: Sequence[str], quota: int | None = None,
               capacity: int | None = None, num_chunks: int = 1):
        """Distinct rows by ``subset`` key columns (combine-shuffle-reduce).

        Returns (DDF, {"overflow_shuffle", "overflow_agg"})."""
        subset = tuple(subset)
        self._check_columns(subset, "unique")
        nw = self.ctx.nworkers
        quota = quota or default_quota(self.capacity, nw)
        capacity = capacity or self.capacity
        out, info = operators.dist_unique(
            self.ctx.comm(), self.table(), subset, quota, capacity,
            num_chunks=num_chunks)
        return self._ddf(out, self.vocabs), info

    def union(self, other: "DDF", on: Sequence[str], quota: int | None = None,
              capacity: int | None = None, num_chunks: int = 1):
        """Set union by key: concat + distributed unique (paper Table 2).

        Returns (DDF, {"overflow_shuffle", "overflow_agg"})."""
        on = tuple(on)
        left, right, merged = self._unify_vocabs_with(other, "union")
        nw = self.ctx.nworkers
        cap = left.capacity + right.capacity
        quota = quota or default_quota(cap, nw)
        capacity = capacity or cap
        out, info = operators.dist_union(self.ctx.comm(), left.table(), right.table(), on,
                                         quota, capacity, num_chunks=num_chunks)
        return self._ddf(out, merged), info

    def difference(self, other: "DDF", on: Sequence[str], quota: int | None = None,
                   capacity: int | None = None, num_chunks: int = 1):
        """Set difference by key: co-partition + local anti-join.

        Returns (DDF, {"overflow_left", "overflow_right"})."""
        on = tuple(on)
        left, right, merged = self._unify_vocabs_with(other, "difference")
        nw = self.ctx.nworkers
        quota = quota or default_quota(left.capacity, nw)
        capacity = capacity or left.capacity
        out, info = operators.dist_difference(self.ctx.comm(), left.table(), right.table(),
                                              on, quota, capacity, num_chunks=num_chunks)
        return self._ddf(out, merged), info

    def sort_values(self, by: str, descending: bool = False, quota: int | None = None,
                    capacity: int | None = None, num_chunks: int = 1):
        """Global sample sort by ``by``; worker i gets the i-th key range.

        Returns (DDF, {"overflow_shuffle": (P,), "pivots": (P, P-1)})."""
        nw = self.ctx.nworkers
        quota = quota or default_quota(self.capacity, nw, safety=3.0)
        capacity = capacity or 2 * self.capacity
        out, info = operators.dist_sort(self.ctx.comm(), self.table(), by, quota, capacity,
                                        descending=descending, num_chunks=num_chunks)
        return self._ddf(out, self.vocabs), info

    # -- Globally-Reduce (paper §5.3.5) ------------------------------------------
    def agg(self, column: str, op: str):
        """Column aggregate (sum | min | max | mean | count) as a numpy
        scalar; min/max of a dict-encoded column come back decoded."""
        if column in self.vocabs and op not in ("min", "max", "count"):
            raise TypeError(
                f"agg: {op!r} over dict-encoded string column {column!r} — "
                f"codes have order but no arithmetic; only min/max/count "
                f"apply to strings")
        out = operators.dist_column_agg(self.ctx.comm(), self.table(), column, op)
        val = out[0].cpu().numpy()[()]  # replicated; worker 0's copy
        if column in self.vocabs and op in ("min", "max"):
            return self.vocabs[column].words[int(val)]
        return val

    def length(self) -> int:
        return int(operators.dist_length(self.ctx.comm(), self.table())[0].item())

    # -- Halo Exchange (paper §5.3.6) ---------------------------------------------
    def rolling_sum(self, column: str, window: int):
        """Rolling-window sum: (DDF with ``<col>_rollsum`` and
        ``window_valid``, {"halo_short": (P,) bool})."""
        out, info = operators.dist_window_sum(self.ctx.comm(), self.table(), column, window)
        return self._ddf(out), info

    def rolling(self, column: str, window: int, op: str = "sum"):
        """Rolling window aggregate: sum | mean | min | max (halo exchange)."""
        out, info = operators.dist_window_agg(self.ctx.comm(), self.table(), column,
                                              window, op)
        return self._ddf(out), info

    def transpose(self) -> "DDF":
        """Distributed transpose (gather-based; for matrix-shaped tables)."""
        return self._ddf(operators.dist_transpose(self.ctx.comm(), self.table()))

    # -- Partitioned I/O (paper §5.3.8) -------------------------------------------
    def rebalance(self, quota: int | None = None, num_chunks: int = 1):
        """Evenly redistribute rows across workers, preserving global order.

        Returns (DDF, {"overflow_shuffle"})."""
        quota = quota or self.capacity
        out, info = operators.rebalance(self.ctx.comm(), self.table(), quota,
                                        num_chunks=num_chunks)
        return self._ddf(out, self.vocabs), info

    def head(self, k: int) -> "DDF":
        """The first ``k`` rows in global order (stays partitioned)."""
        return self._ddf(operators.dist_head(self.ctx.comm(), self.table(), k), self.vocabs)

    # -- plan layers ------------------------------------------------------------------
    def lazy(self):
        """Lazy handle over this DDF: a ``repro_torch.plan.LazyDDF`` whose
        methods build a logical plan; ``.collect()`` optimizes the whole
        pipeline and runs it as one composed callable. Cached per instance,
        so a pipeline rebuilt from the same DDF hits the plan and op
        caches."""
        if self._lazy_cache is None:
            from ..plan.frame import LazyDDF
            self._lazy_cache = LazyDDF.from_ddf(self)
        return self._lazy_cache

    def eager(self) -> "DDF":
        """This DDF itself (the eager handle)."""
        return self
