"""``LazyDDF``: the lazy distributed-dataframe handle.

Operator methods mirror the eager ``DDF`` surface but only *build* logical
nodes (``repro_torch.plan.logical``); nothing touches the card until a
terminal call:

- ``.collect()`` / ``.eager()`` — optimize + execute, returning an eager
  ``DDF`` (``.collect_with_info()`` also returns the aux counters);
- ``.to_numpy()`` — collect and gather to host;
- ``.explain()`` — render the (optimized) plan without executing
  (``analyze=True`` also runs it under profiling);
- ``.collect_stream()`` / ``.to_batches()`` — the out-of-core streaming
  engine (``repro_torch.stream``), the only way to run plans with ``SCAN``
  leaves (``scan_dataset`` / ``scan_csv``); ``.collect()`` routes them
  there.

Schema validation happens at graph-build time: unknown columns raise
``KeyError`` carrying the available schema immediately, with the
reference's exception types. Select predicates and map functions are probed
on a tiny host table to learn which columns they read (enabling
predicate/projection pushdown) and the map output schema.
"""

from __future__ import annotations

import itertools
from typing import Callable, Mapping, Sequence

from .. import expr as _expr
from ..core.api import DDF, DDFContext, callable_signature
from ..core.promotion import dtype_name
from . import executor
from .logical import (
    Difference,
    GroupBy,
    Join,
    MapColumns,
    Node,
    Project,
    Rebalance,
    Recode,
    Rename,
    Select,
    Sort,
    Source,
    Union,
    Unique,
    WithColumn,
    format_plan,
    probe_columns,
    schema_names,
    schema_of,
)

__all__ = ["LazyDDF"]

_SIDS = itertools.count()


class LazyDDF:
    """Lazy distributed dataframe: a logical-plan root + its source tables.

    Build pipelines by chaining operator methods (each returns a new
    ``LazyDDF``; plans are immutable and shareable), then call a terminal
    (``collect`` / ``to_numpy`` / ``explain``). Obtain one via
    ``DDF.lazy()`` or ``DDF.from_numpy(..., mode="lazy")``.

    Over a process group every rank builds the same pipeline and calls the
    same terminals in the same order: the plan is optimized from global row
    counts, so each rank runs the same steps on its block of the workers,
    and ``last_info``'s counters are every worker's, ``(P,)`` on every rank.
    """

    def __init__(self, root: Node, ctx: DDFContext, sources: Mapping,
                 scans: Mapping | None = None, vocabs: Mapping | None = None):
        self._root = root
        self._ctx = ctx
        self._sources = dict(sources)
        # scan sid -> DatasetManifest (out-of-core leaves, repro_torch.stream)
        self._scans = dict(scans or {})
        # host-side vocabularies of dict-encoded string columns of the
        # plan's OUTPUT (name -> repro_torch.core.vocab.DictVocab); the
        # device plan only ever sees their int32 code columns
        self._vocabs = dict(vocabs or {})
        self.last_info: dict | None = None
        self.last_profile = None  # obs.Profile after collect(profile=True)

    @classmethod
    def from_ddf(cls, ddf: DDF) -> "LazyDDF":
        """Wrap a materialized eager DDF as a plan source."""
        sid = next(_SIDS)
        schema = tuple(sorted(
            (n, dtype_name(v.dtype), tuple(v.shape[2:])) for n, v in ddf.columns.items()))
        return cls(Source(sid, schema, ddf.capacity), ddf.ctx, {sid: ddf},
                   vocabs=dict(ddf.vocabs))

    # -- introspection ----------------------------------------------------------
    @property
    def schema(self) -> tuple:
        """Propagated output schema: ((name, dtype, trailing shape), ...)."""
        return schema_of(self._root)

    @property
    def column_names(self) -> tuple:
        return schema_names(self.schema)

    @property
    def plan(self) -> Node:
        """The (unoptimized) logical-plan root."""
        return self._root

    def _check(self, names: Sequence[str], op: str) -> None:
        have = set(self.column_names)
        missing = [n for n in names if n not in have]
        if missing:
            raise KeyError(f"{op}: unknown column(s) {missing}; "
                           f"available schema: {sorted(have)}")

    def _derive(self, node: Node, other: "LazyDDF | None" = None,
                vocabs: Mapping | None = None) -> "LazyDDF":
        srcs = dict(self._sources)
        scans = dict(self._scans)
        if other is not None:
            if other._ctx is not self._ctx and other._ctx != self._ctx:
                raise ValueError("cannot combine LazyDDFs from different contexts")
            srcs.update(other._sources)
            scans.update(other._scans)
        return LazyDDF(node, self._ctx, srcs, scans,
                       vocabs=self._vocabs if vocabs is None else vocabs)

    def _unify(self, other: "LazyDDF", op: str):
        """Vocab unification at a binary plan boundary: merge each shared
        dict column's vocabs host-side and wrap either input in an explicit
        ``RECODE`` node when its codes must move into the merged space —
        visible in ``explain()`` and charged by the cost model. Returns
        ``(left_root, right_root, merged_vocabs)``."""
        lv = {n: v for n, v in self._vocabs.items() if n in self.column_names}
        rv = {n: v for n, v in other._vocabs.items()
              if n in other.column_names}
        mixed = sorted((set(lv) ^ set(rv))
                       & set(self.column_names) & set(other.column_names))
        if mixed:
            raise TypeError(
                f"{op}: column(s) {mixed} are dict-encoded strings on one "
                f"side but plain numerics on the other — codes and raw "
                f"values are not comparable; encode both sides or neither")
        merged = {**rv, **lv}
        lmaps, rmaps = [], []
        for n in sorted(set(lv) & set(rv)):
            if lv[n].words == rv[n].words:
                continue
            mv = lv[n].merge(rv[n])
            merged[n] = mv
            if not lv[n].is_identity_into(mv):
                lmaps.append((n, tuple(int(c) for c in lv[n].recode_map(mv))))
            if not rv[n].is_identity_into(mv):
                rmaps.append((n, tuple(int(c) for c in rv[n].recode_map(mv))))
        lroot = Recode(self._root, tuple(lmaps)) if lmaps else self._root
        rroot = Recode(other._root, tuple(rmaps)) if rmaps else other._root
        return lroot, rroot, merged

    @staticmethod
    def _coerce(other) -> "LazyDDF":
        return other.lazy() if isinstance(other, DDF) else other

    def _probe(self, fn: Callable, op: str):
        """Probe a user callable, converting a missing-column KeyError into
        the build-time schema error the frame contract promises."""
        try:
            return probe_columns(fn, self.schema)
        except KeyError as e:
            raise KeyError(f"{op}: callable references unknown column(s) "
                           f"[{e.args[0] if e.args else e}]; available "
                           f"schema: {sorted(self.column_names)}") from e

    # -- embarrassingly parallel -------------------------------------------------
    def select(self, pred, name: str = "pred") -> "LazyDDF":
        """Filter rows by a boolean expression: ``select(col("a") > 3)``.

        The expression's exact referenced-column set drives predicate and
        projection pushdown; unknown column references raise ``KeyError``
        at build time; the constant-folded tree itself is the node's
        structural identity, so equal pipelines hit the plan and op
        caches.

        Passing a Python callable over the column dict is deprecated
        (one-shot ``DeprecationWarning``) but bit-identical: the callable
        is probed host-side to learn which columns it reads, under the
        legacy contract that its column-access pattern is data-independent
        (dict iteration / ``in``-membership disable pushdown)."""
        if isinstance(pred, (_expr.Expr, bool)) or _expr.is_when_builder(pred):
            pred = _expr.prepare_row_expr(pred, self.column_names, "select",
                                          vocabs=self._vocabs or None)
            return self._derive(Select(
                self._root, _expr.to_torch_fn(pred), name,
                tuple(sorted(_expr.referenced_columns(pred))), expr=pred))
        _expr.warn_callable_deprecated("select")
        used, _ = self._probe(pred, f"select '{name}'")
        return self._derive(Select(self._root, pred, name, used,
                                   fn_sig=callable_signature(pred)))

    def with_column(self, name: str, value) -> "LazyDDF":
        """Add (or overwrite) column ``name`` from an expression:
        ``with_column("c", col("a") + col("b"))``. Scalars coerce to
        literals. The output dtype/shape is inferred from the tree (the
        reference's promotion rules) for schema propagation; unknown column references
        raise ``KeyError`` at build time."""
        e = _expr.prepare_row_expr(value, self.column_names, "with_column",
                                   vocabs=self._vocabs or None)
        return self._derive(
            WithColumn(self._root, str(name), e, fn=_expr.to_torch_fn(e)),
            vocabs={n: v for n, v in self._vocabs.items() if n != name})

    def project(self, names: Sequence[str]) -> "LazyDDF":
        """Keep only ``names`` (validated against the propagated schema)."""
        names = tuple(names)
        self._check(names, "project")
        return self._derive(
            Project(self._root, names),
            vocabs={n: v for n, v in self._vocabs.items() if n in set(names)})

    def drop(self, names: Sequence[str]) -> "LazyDDF":
        """Drop columns — inverse of :meth:`project`."""
        names = tuple(names)
        self._check(names, "drop")
        keep = tuple(n for n in self.column_names if n not in set(names))
        return self._derive(
            Project(self._root, keep),
            vocabs={n: v for n, v in self._vocabs.items() if n in set(keep)})

    def rename(self, mapping: Mapping[str, str]) -> "LazyDDF":
        """Rename columns (old -> new). Colliding targets raise ValueError
        (matching eager ``DDF.rename``; a silent overwrite drops a column)."""
        self._check(tuple(mapping), "rename")
        targets = [mapping.get(n, n) for n in self.column_names]
        dup = {t for t in targets if targets.count(t) > 1}
        if dup:
            raise ValueError(f"rename: duplicate target column(s) {sorted(dup)}")
        return self._derive(
            Rename(self._root, tuple(sorted(mapping.items()))),
            vocabs={mapping.get(n, n): v for n, v in self._vocabs.items()})

    def map_columns(self, fn: Callable, name: str = "map") -> "LazyDDF":
        """Legacy column-wise map over the raw column dict (deprecated —
        use expression-based :meth:`with_column` / :meth:`project`); output
        schema is probed host-side at build time."""
        _expr.warn_callable_deprecated("map_columns")
        used, out_schema = self._probe(fn, f"map_columns '{name}'")
        if out_schema is None:
            raise TypeError(
                f"map_columns '{name}': fn must return a column mapping when "
                "probed on a tiny table (needed for schema propagation)")
        return self._derive(MapColumns(self._root, fn, name, used, out_schema,
                                       fn_sig=callable_signature(fn)),
                            vocabs={})  # opaque map: code semantics unknown

    # -- keyed / shuffle ops ------------------------------------------------------
    def join(self, other, on: Sequence[str], strategy: str = "auto",
             quota: int | None = None, capacity: int | None = None,
             num_chunks: int | None = None) -> "LazyDDF":
        """Equi-join; the optimizer picks hash-shuffle vs broadcast and the
        pipeline depth for the whole pipeline unless pinned here."""
        other = self._coerce(other)
        on = tuple(on)
        self._check(on, "join")
        other._check(on, "join(right)")
        lroot, rroot, merged = self._unify(other, "join")
        return self._derive(Join(lroot, rroot, on, strategy,
                                 quota, capacity, num_chunks), other,
                            vocabs=merged)

    def groupby(self, by: Sequence[str], aggs,
                pre_combine: bool | None = None,
                cardinality_hint: float | None = None,
                quota: int | None = None, capacity: int | None = None,
                num_chunks: int | None = None) -> "LazyDDF":
        """GroupBy-aggregate; strategy/pipelining planned from DAG estimates
        (and elided entirely when the input is already co-partitioned).
        ``aggs`` is either the canonical ``{value_col: (op, ...)}`` mapping
        or a sequence of aggregation expressions (``[col("v").sum(),
        col("v").mean().alias("avg")]``); aliases become a RENAME node on
        top of the GROUPBY."""
        by = tuple(by)
        renames: tuple = ()
        if not isinstance(aggs, Mapping):
            aggs, renames = _expr.parse_agg_specs(aggs)
        self._check(by, "groupby")
        self._check(tuple(aggs), "groupby(aggs)")
        aggs_t = tuple(sorted((k, tuple(v)) for k, v in aggs.items()))
        bad = sorted(f"{c}.{o}" for c, ops_ in aggs_t for o in ops_
                     if c in self._vocabs and o in ("sum", "mean"))
        if bad:
            raise TypeError(
                f"groupby: aggregation(s) {bad} are arithmetic over a "
                f"dict-encoded string column — codes have order but no "
                f"arithmetic; only min/max/count apply to strings")
        out_vocabs = {n: v for n, v in self._vocabs.items() if n in set(by)}
        for c, ops_ in aggs_t:
            if c in self._vocabs:  # ordered aggs of a dict column stay dict
                for o in ops_:
                    if o in ("min", "max"):
                        out_vocabs[f"{c}_{o}"] = self._vocabs[c]
        out = self._derive(GroupBy(self._root, by, aggs_t, pre_combine,
                                   cardinality_hint, quota, capacity,
                                   num_chunks),
                           vocabs=out_vocabs)
        return out.rename(dict(renames)) if renames else out

    def unique(self, subset: Sequence[str], quota: int | None = None,
               capacity: int | None = None,
               num_chunks: int | None = None) -> "LazyDDF":
        """Distinct rows by ``subset`` key columns."""
        subset = tuple(subset)
        self._check(subset, "unique")
        return self._derive(Unique(self._root, subset, quota, capacity, num_chunks))

    def union(self, other, on: Sequence[str], quota: int | None = None,
              capacity: int | None = None,
              num_chunks: int | None = None) -> "LazyDDF":
        """Set union by key (both inputs must share a schema)."""
        other = self._coerce(other)
        on = tuple(on)
        self._check(on, "union")
        if set(self.column_names) != set(other.column_names):
            raise ValueError(
                f"union: schema mismatch {sorted(self.column_names)} vs "
                f"{sorted(other.column_names)}")
        lroot, rroot, merged = self._unify(other, "union")
        return self._derive(Union(lroot, rroot, on, quota,
                                  capacity, num_chunks), other, vocabs=merged)

    def difference(self, other, on: Sequence[str], quota: int | None = None,
                   capacity: int | None = None,
                   num_chunks: int | None = None) -> "LazyDDF":
        """Set difference by key (rows of self whose key is absent in other)."""
        other = self._coerce(other)
        on = tuple(on)
        self._check(on, "difference")
        other._check(on, "difference(right)")
        lroot, rroot, merged = self._unify(other, "difference")
        return self._derive(Difference(lroot, rroot, on, quota,
                                       capacity, num_chunks), other,
                            vocabs=merged)

    def sort_values(self, by: str, descending: bool = False,
                    quota: int | None = None, capacity: int | None = None,
                    num_chunks: int | None = None) -> "LazyDDF":
        """Global sample sort by ``by``."""
        self._check((by,), "sort_values")
        return self._derive(Sort(self._root, by, descending, quota,
                                 capacity, num_chunks))

    def rebalance(self, quota: int | None = None,
                  num_chunks: int | None = None) -> "LazyDDF":
        """Evenly redistribute rows across workers, preserving global order."""
        return self._derive(Rebalance(self._root, quota, num_chunks))

    # -- terminals ---------------------------------------------------------------
    def _rows(self) -> dict:
        rows = executor.source_row_counts(self._sources)
        rows.update({sid: m.num_rows for sid, m in self._scans.items()})
        return rows

    def collect(self, level: str = "all", profile: bool = False) -> DDF:
        """Optimize + execute the pipeline; returns an eager DDF on the
        context's device.

        Aux outputs (overflow counters etc., one entry per worker: all P
        on every rank of a group) land in ``self.last_info``.
        ``level="plan-only"`` skips the rewrite passes (A/B baseline).
        Plans with ``SCAN`` leaves (built via ``repro_torch.stream.scan_csv`` /
        ``scan_dataset``) route through :meth:`collect_stream` — the
        out-of-core engine is the only way to run them (and it always runs
        the full optimizer, so ``level`` overrides are rejected there).

        ``profile=True`` runs the query with tracing enabled for its
        duration and stores a ``repro_torch.obs.Profile`` (spans plus the cost
        model's predicted-vs-observed samples) in ``self.last_profile``.
        Profiling never changes results — it only adds a device sync per
        dispatched program (on the card) for honest wall times."""
        if profile:
            from .. import obs as _obs
            with _obs.profiled() as prof:
                out = self.collect(level=level)
            self.last_profile = prof
            return out
        if self._scans:
            if level != "all":
                raise ValueError(
                    f"collect(level={level!r}) is not supported for "
                    "scan-bearing plans; the streaming engine always runs "
                    "the full optimizer")
            return self.collect_stream()
        out, info = executor.execute(self._root, self._ctx, self._sources,
                                     src_rows=self._rows(), level=level)
        self.last_info = info
        out.vocabs = {n: v for n, v in self._vocabs.items()
                      if n in out.columns}
        return out

    def collect_stream(self, batch_rows: int | None = None,
                       prefetch: bool = True, **opts) -> DDF:
        """Run the pipeline through the out-of-core streaming engine
        (``repro_torch.stream``): SCAN leaves are sliced into cost-model-sized
        batches, each batch runs through the optimized plan, and non-EP
        tails finalize via carry-state merges (groupby/unique) or host-side
        spill + merge (sort, scan×scan joins). Returns the final eager DDF;
        per-batch aux counters land in ``self.last_info``."""
        from ..stream import runner as _runner
        out, info = _runner.collect(self, batch_rows=batch_rows,
                                    prefetch=prefetch, **opts)
        self.last_info = info
        out.vocabs = {n: v for n, v in self._vocabs.items()
                      if n in out.columns}
        return out

    def to_batches(self, batch_rows: int | None = None,
                   prefetch: bool = True, **opts):
        """Stream the pipeline's result as host column-dict batches.

        For fully streamable plans this is true out-of-core iteration —
        each yielded batch is one morsel through the optimized plan and the
        full result never materializes. Plans whose tail needs carry/spill
        finalization finalize first, then yield the result in
        ``batch_rows``-sized slices. Dict-encoded string columns are
        decoded per batch — consumers see strings, never codes."""
        from ..stream import runner as _runner
        batches = _runner.to_batches(self, batch_rows=batch_rows,
                                     prefetch=prefetch, **opts)
        if not self._vocabs:
            return batches
        vocabs = dict(self._vocabs)

        def decoded():
            for b in batches:
                yield {n: (vocabs[n].decode(v) if n in vocabs else v)
                       for n, v in b.items()}

        return decoded()

    def collect_with_info(self, level: str = "all"):
        """Like :meth:`collect` but returns ``(DDF, info dict)``."""
        out = self.collect(level=level)
        return out, self.last_info

    def eager(self) -> DDF:
        """Materialize to an eager DDF (the eager escape hatch)."""
        return self.collect()

    def to_numpy(self) -> dict:
        """Collect and gather live rows to host, in partition order."""
        return self.collect().to_numpy()

    def explain(self, optimized: bool = True, analyze: bool = False) -> str:
        """Render the logical plan (post-optimizer by default) with row
        estimates and a shuffle count — no device execution beyond the one
        copy of the source row counts.

        Scan-bearing queries whose dataset manifests carry chunk sketches
        show sketch-estimated predicate selectivity next to the fixed
        ratio on each SCAN line (``sel~0.08 (fixed 0.25)``), and their row
        estimates/shuffle plans use the sketch numbers — the same stats
        the streaming runner plans with.

        ``analyze=True`` additionally *executes* the query under profiling
        (the EXPLAIN ANALYZE idiom) and appends the measured per-operator
        profile — predicted vs observed milliseconds per op and the
        per-pattern cost-model error — to the rendered plan. The analyzed
        result is bit-identical to a plain :meth:`collect` and lands in
        ``self.last_info`` as usual."""
        from ..stats import plan_stats as _plan_stats

        rows = self._rows()
        stats = _plan_stats(self._scans)
        if not optimized:
            text = format_plan(self._root, rows, stats=stats)
        else:
            plan = executor.optimized_plan(self._root, self._ctx, rows,
                                           stats=stats)
            text = format_plan(plan, rows, stats=stats)
        if not analyze:
            return text
        self.collect(profile=True)
        return text + "\n\n" + self.last_profile.render()

    def __repr__(self) -> str:
        return (f"LazyDDF(cols={list(self.column_names)}, "
                f"plan={type(self._root).__name__})")
