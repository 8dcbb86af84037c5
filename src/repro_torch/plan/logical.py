"""Logical-plan node types for the lazy DDF API (paper §2, Fig. 2b).

The reference's ``repro.plan.logical``, node for node: the same nodes,
schemas, estimates and ``format_plan`` text for the same plan. Probes run
on tiny CPU torch tables where the reference's use ``jnp.ones``.

The lazy layer represents a whole dataframe pipeline as an immutable DAG of
logical nodes *before* anything executes, so the cost-model-driven optimizer
(``repro_torch.plan.optimizer``) can see the entire query — the design argued for
by Modin's dataframe algebra and Cylon's execution plans. Each node mirrors
one ``DDF`` operator; node classes are frozen dataclasses, hashable and
structurally comparable, which is what lets optimized plans key the plan
cache.

Alongside the node types this module implements the *property propagation*
the optimizer relies on:

- :func:`schema_of` — output schema (name, dtype, trailing shape) per node.
- :func:`capacity_of` — static output capacity, mirroring the eager
  operator defaults exactly (bit-exactness contract).
- :func:`partitioning_of` — the hash-partition key tuple the node's output
  is co-partitioned on, or None; drives shuffle elision (paper Table 2
  co-partition reuse).
- :func:`estimate_rows` — global row-count estimates propagated from source
  counts, feeding the cost model's strategy/chunk-depth selection.

Operator bodies arrive in two forms. The first-class form is a
``repro_torch.expr`` expression tree stored *on the node* (``Select.expr``,
``WithColumn.expr``, ``Scan.pred_sigs`` entries): immutable, structurally
hashable, with exact referenced-column sets — plan equality and the plan and
op caches key on the tree itself. The legacy form is an opaque callable
(``Select``/``MapColumns`` with ``expr=None``) compared by its
user-supplied ``name`` plus a callable fingerprint
(``repro_torch.core.api.callable_signature``: code location, bytecode,
hashable closure/default values) rather than the function object itself, so
structurally-identical plans hit the caches while different predicates
never alias.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, ClassVar, Mapping, Sequence

import numpy as np
import torch

from .. import expr as _expr
from ..core import promotion

__all__ = [
    "Node",
    "Source",
    "Scan",
    "Select",
    "Project",
    "Rename",
    "MapColumns",
    "WithColumn",
    "Join",
    "GroupBy",
    "Unique",
    "Union",
    "Difference",
    "Sort",
    "Rebalance",
    "Recode",
    "Fused",
    "Schema",
    "schema_of",
    "schema_names",
    "capacity_of",
    "partitioning_of",
    "estimate_rows",
    "row_bytes_of",
    "probe_columns",
    "count_shuffles",
    "format_plan",
    "plan_signature",
    "walk",
]

# ((column name, dtype string, trailing shape), ...) sorted by name.
Schema = tuple

SELECT_SELECTIVITY = 0.5   # default filter selectivity when nothing is known
UNKNOWN_CARDINALITY = 0.5  # default key-cardinality fraction for dedup ops
JOIN_SUFFIX = "_r"


@dataclasses.dataclass(frozen=True)
class Node:
    """Base class for logical-plan nodes (immutable, hashable, comparable)."""

    _CHILD_FIELDS: ClassVar[tuple] = ()

    @property
    def children(self) -> tuple:
        """Input nodes, in argument order."""
        return tuple(getattr(self, f) for f in self._CHILD_FIELDS)

    def with_children(self, new: Sequence["Node"]) -> "Node":
        """Copy of this node with its input nodes replaced."""
        return dataclasses.replace(self, **dict(zip(self._CHILD_FIELDS, new)))


@dataclasses.dataclass(frozen=True)
class Source(Node):
    """Leaf: one materialized eager DDF, identified by a stable source id."""

    sid: int
    schema: Schema
    capacity: int


@dataclasses.dataclass(frozen=True)
class Scan(Node):
    """Leaf: a chunked on-disk dataset streamed in cost-model-sized batches.

    ``sid`` keys the ``DatasetManifest`` held by the owning ``LazyDDF`` /
    streaming runner (manifests stay out of the node so plans remain
    hashable). ``schema`` is the full on-disk schema; ``columns`` is the
    projection pushed into the scan (None = all — only these ``.npz``
    members are decompressed per batch). ``pred_names``/``pred_sigs``
    identify predicates pushed into the scan for plan equality and the
    caches: a ``pred_sigs`` entry is the predicate's *expression tree*
    when it came from the expression API (structural identity, and the
    runner may decode extra referenced columns beyond ``columns`` for it)
    or a callable fingerprint for the legacy probed form. The host
    evaluators themselves, ``pred_fns``, are compare-excluded, mirroring
    :class:`Select`; the runner applies them host-side per batch *before*
    rows are admitted to the device. ``capacity`` is the per-worker batch
    capacity the runner slices the manifest into (``repro_torch.stream``'s
    ``scan_dataset`` / ``scan_csv`` build it)."""

    sid: int
    schema: Schema
    capacity: int
    columns: tuple | None = None
    pred_names: tuple = ()
    pred_sigs: tuple = ()
    pred_fns: tuple = dataclasses.field(compare=False, default=())


@dataclasses.dataclass(frozen=True)
class Select(Node):
    """Row filter (embarrassingly parallel). ``used`` lists the columns the
    predicate reads — exact when ``expr`` carries the predicate's
    expression tree (the first-class form; ``fn`` is then its lowered torch
    body and node identity comes from the tree itself), probed at build
    time for legacy callables (None means unknown/all, and ``fn_sig`` — the
    ``api.callable_signature`` fingerprint — keeps structurally-equal nodes
    with different predicates distinct)."""

    child: Node
    fn: Callable = dataclasses.field(compare=False)
    name: str = "pred"
    used: tuple | None = None
    fn_sig: tuple = ()
    expr: object | None = None

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Project(Node):
    """Column projection. ``synthetic`` marks optimizer-inserted pushdowns."""

    child: Node
    names: tuple
    synthetic: bool = False

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Rename(Node):
    """Column rename; ``mapping`` is ((old, new), ...) sorted."""

    child: Node
    mapping: tuple

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class MapColumns(Node):
    """Column-wise map (embarrassingly parallel). Output schema is probed at
    build time (``out_schema``); ``used`` and ``fn_sig`` as in
    :class:`Select`."""

    child: Node
    fn: Callable = dataclasses.field(compare=False)
    name: str = "map"
    used: tuple | None = None
    out_schema: Schema | None = None
    fn_sig: tuple = ()

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class WithColumn(Node):
    """Add (or overwrite) one column from an expression (embarrassingly
    parallel): all child columns pass through, plus ``name`` computed by
    ``expr``. ``expr`` is compare-included — node identity and cache keys
    are the expression's structural hash; ``fn`` is its lowered torch body
    (compare-excluded). The output dtype/shape is derived from the tree via
    ``repro_torch.expr.infer_schema_entry``, never probed."""

    child: Node
    name: str
    expr: object = None
    fn: Callable = dataclasses.field(compare=False, default=None)

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Join(Node):
    """Equi-join. ``strategy``: "auto" (planner decides) | "shuffle" |
    "broadcast" (planner picks the gathered side) | "broadcast_left" /
    "broadcast_right" (that side is replicated) | "local" (co-partition
    reuse: shuffle elided)."""

    left: Node
    right: Node
    on: tuple
    strategy: str = "auto"
    quota: int | None = None
    capacity: int | None = None
    num_chunks: int | None = None

    _CHILD_FIELDS: ClassVar[tuple] = ("left", "right")


@dataclasses.dataclass(frozen=True)
class GroupBy(Node):
    """GroupBy-aggregate; ``aggs`` is ((value_col, (op, ...)), ...) sorted.

    ``emit_partials=True`` makes the node emit mergeable partial aggregates
    (``<col>_sum``/``<col>_count``/... — mean stays decomposed, no
    finalization) — the per-batch form the streaming runner's carry state
    merges across batches before one final ``finalize_groupby``."""

    child: Node
    by: tuple
    aggs: tuple
    pre_combine: bool | None = None
    cardinality_hint: float | None = None
    quota: int | None = None
    capacity: int | None = None
    num_chunks: int | None = None
    elide_shuffle: bool = False
    emit_partials: bool = False

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Unique(Node):
    """Distinct rows by ``subset`` key columns."""

    child: Node
    subset: tuple
    quota: int | None = None
    capacity: int | None = None
    num_chunks: int | None = None
    elide_shuffle: bool = False

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Union(Node):
    """Set union by key (concat + distinct); both inputs share a schema."""

    left: Node
    right: Node
    on: tuple
    quota: int | None = None
    capacity: int | None = None
    num_chunks: int | None = None
    elide_shuffle: bool = False

    _CHILD_FIELDS: ClassVar[tuple] = ("left", "right")


@dataclasses.dataclass(frozen=True)
class Difference(Node):
    """Set difference by key (co-partition + local anti-join)."""

    left: Node
    right: Node
    on: tuple
    quota: int | None = None
    capacity: int | None = None
    num_chunks: int | None = None
    elide_shuffle: bool = False

    _CHILD_FIELDS: ClassVar[tuple] = ("left", "right")


@dataclasses.dataclass(frozen=True)
class Sort(Node):
    """Global sample sort by one key column (range shuffle)."""

    child: Node
    by: str
    descending: bool = False
    quota: int | None = None
    capacity: int | None = None
    num_chunks: int | None = None

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Rebalance(Node):
    """Even redistribution of rows across workers, preserving global order."""

    child: Node
    quota: int | None = None
    num_chunks: int | None = None

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Recode(Node):
    """Vocab-unification recode of dict-encoded code columns
    (embarrassingly parallel). Inserted at Join/Union/Difference boundaries
    where the two inputs carry *different* vocabularies for a shared string
    column: the merged vocab is computed host-side at plan-build time and
    ``mappings`` holds the per-column monotone gather maps into the merged
    code space — ``((name, (new_code_for_old_code_i, ...)), ...)`` sorted
    by name. Execution is one ``int32`` gather per column
    (``new = map[old]``).

    Deliberately *not* fused into EP chains: it stays a standalone node so
    ``explain()`` shows the RECODE step and the cost model charges it
    individually (``repro_torch.obs.model_check``)."""

    child: Node
    mappings: tuple

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


@dataclasses.dataclass(frozen=True)
class Fused(Node):
    """A chain of embarrassingly-parallel steps run as one pass over the
    (P, capacity) table (the optimizer's fusion pass). ``steps`` apply in order to the
    child's output; each step is an EP node whose own child link is only
    used for schema propagation."""

    child: Node
    steps: tuple

    _CHILD_FIELDS: ClassVar[tuple] = ("child",)


# -- build-time probing -------------------------------------------------------

class _RecordingColumns(dict):
    """Column dict that records which keys a probed callable reads."""

    def __init__(self, cols):
        super().__init__(cols)
        self.accessed: set = set()
        self.touched_all = False

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.accessed.add(k)
        return super().get(k, default)

    def _all(self):
        self.touched_all = True

    def keys(self):
        self._all()
        return super().keys()

    def values(self):
        self._all()
        return super().values()

    def items(self):
        self._all()
        return super().items()

    def __iter__(self):
        self._all()
        return super().__iter__()

    def __contains__(self, k):
        # membership tests make the callable's behavior depend on the full
        # column set, so pushdown must not narrow it (treat as touch-all)
        self._all()
        return super().__contains__(k)


def probe_columns(fn: Callable, schema: Schema):
    """Run ``fn`` on a tiny concrete table to learn (used columns, output
    schema). The probe sees a ones-valued table on the CPU, so callables
    whose column accesses depend on data *values* (not just the schema) can
    under-report ``used``; the API contract requires data-independent
    access patterns (iteration and ``in``-membership are detected and
    reported as touch-all). Returns ``(used, out_schema)`` where ``used`` is
    a sorted name tuple or None (unknown — the callable iterated the dict or
    raised) and ``out_schema`` is the probed output schema or None
    (non-dict result, e.g. a select predicate mask). A ``KeyError`` (the
    callable referenced a column absent from ``schema``) propagates so
    callers can surface it at build time."""
    cols = {n: torch.ones((2,) + tuple(tail), dtype=promotion.torch_dtype_of(dt))
            for n, dt, tail in schema}
    rec = _RecordingColumns(cols)
    try:
        out = fn(rec)
    except KeyError:
        raise
    except Exception:
        return None, None
    used = None if rec.touched_all else tuple(sorted(rec.accessed))
    out_schema = None
    if isinstance(out, Mapping):
        try:
            out_schema = tuple(sorted(
                (n, promotion.dtype_name(torch.as_tensor(v).dtype),
                 tuple(torch.as_tensor(v).shape[1:]))
                for n, v in dict(out).items()))
        except Exception:
            out_schema = None
    return used, out_schema


# -- property propagation -----------------------------------------------------

def schema_names(schema: Schema) -> tuple:
    """Column names of a schema, in schema order."""
    return tuple(n for n, _, _ in schema)


def _join_schema(ls: Schema, rs: Schema, on: tuple) -> Schema:
    lnames = set(schema_names(ls))
    out = list(ls)
    for n, dt, tail in rs:
        if n in on:
            continue
        out.append((n if n not in lnames else n + JOIN_SUFFIX, dt, tail))
    return tuple(sorted(out))


def _groupby_schema(child: Schema, by: tuple, aggs: tuple) -> Schema:
    d = {n: (dt, tail) for n, dt, tail in child}
    out = [(n, *d[n]) for n in by]
    for col, ops in aggs:
        for op in ops:
            if op == "count":
                out.append((f"{col}_count", "int32", ()))
            elif op == "mean":
                out.append((f"{col}_mean", "float32", d[col][1]))
            else:
                out.append((f"{col}_{op}", d[col][0], d[col][1]))
    return tuple(sorted(set(out)))


def _groupby_partial_schema(child: Schema, by: tuple, aggs: tuple) -> Schema:
    """Schema of the mergeable partial-aggregate form (``emit_partials``):
    mean decomposes into sum+count, nothing is finalized or dropped."""
    d = {n: (dt, tail) for n, dt, tail in child}
    out = [(n, *d[n]) for n in by]
    for col, ops in aggs:
        for op in ops:
            if op == "mean":
                out.append((f"{col}_sum", d[col][0], d[col][1]))
                out.append((f"{col}_count", "int32", ()))
            elif op == "count":
                out.append((f"{col}_count", "int32", ()))
            else:
                out.append((f"{col}_{op}", d[col][0], d[col][1]))
    return tuple(sorted(set(out)))


def schema_of(node: Node, memo: dict | None = None) -> Schema:
    """Output schema of a node: ((name, dtype, trailing shape), ...) sorted."""
    memo = {} if memo is None else memo
    if id(node) in memo:
        return memo[id(node)]
    if isinstance(node, Source):
        s = node.schema
    elif isinstance(node, Scan):
        if node.columns is None:
            s = node.schema
        else:
            keep = set(node.columns)
            s = tuple(x for x in node.schema if x[0] in keep)
    elif isinstance(node, (Select, Sort, Rebalance, Unique, Recode)):
        s = schema_of(node.child, memo)
    elif isinstance(node, Project):
        d = {n: (dt, tail) for n, dt, tail in schema_of(node.child, memo)}
        s = tuple(sorted((n, *d[n]) for n in node.names))
    elif isinstance(node, Rename):
        m = dict(node.mapping)
        s = tuple(sorted((m.get(n, n), dt, tail)
                         for n, dt, tail in schema_of(node.child, memo)))
    elif isinstance(node, MapColumns):
        if node.out_schema is None:
            raise ValueError(f"map '{node.name}': output schema unknown "
                             "(probe failed); cannot plan")
        s = node.out_schema
    elif isinstance(node, WithColumn):
        child_s = schema_of(node.child, memo)
        dt, tail = _expr.infer_schema_entry(node.expr, child_s)
        s = tuple(sorted([x for x in child_s if x[0] != node.name]
                         + [(node.name, dt, tail)]))
    elif isinstance(node, Join):
        s = _join_schema(schema_of(node.left, memo), schema_of(node.right, memo), node.on)
    elif isinstance(node, GroupBy):
        fn = _groupby_partial_schema if node.emit_partials else _groupby_schema
        s = fn(schema_of(node.child, memo), node.by, node.aggs)
    elif isinstance(node, (Union, Difference)):
        s = schema_of(node.left, memo)
    elif isinstance(node, Fused):
        s = schema_of(node.steps[-1], memo)
    else:
        raise TypeError(node)
    memo[id(node)] = s
    return s


def row_bytes_of(schema: Schema) -> float:
    """Bytes per row implied by a schema (drives the Hockney comm terms)."""
    total = 0.0
    for _, dt, tail in schema:
        total += np.dtype(dt).itemsize * float(np.prod(tail)) if tail else np.dtype(dt).itemsize
    return max(total, 1.0)


def capacity_of(node: Node, nworkers: int) -> int:
    """Static per-partition output capacity, mirroring the eager defaults."""
    if isinstance(node, (Source, Scan)):
        return node.capacity
    if isinstance(node, (Select, Project, Rename, MapColumns, WithColumn,
                         Recode, Fused)):
        return capacity_of(node.child, nworkers)
    if isinstance(node, Join):
        return node.capacity if node.capacity else 2 * capacity_of(node.left, nworkers)
    if isinstance(node, (GroupBy, Unique)):
        return node.capacity if node.capacity else capacity_of(node.child, nworkers)
    if isinstance(node, Union):
        return node.capacity if node.capacity else (
            capacity_of(node.left, nworkers) + capacity_of(node.right, nworkers))
    if isinstance(node, Difference):
        return node.capacity if node.capacity else capacity_of(node.left, nworkers)
    if isinstance(node, Sort):
        return node.capacity if node.capacity else 2 * capacity_of(node.child, nworkers)
    if isinstance(node, Rebalance):
        q = node.quota if node.quota else capacity_of(node.child, nworkers)
        return nworkers * q
    raise TypeError(node)


def partitioning_of(node: Node) -> tuple | None:
    """Hash-partition key tuple the node's output is co-partitioned on, or
    None. "Co-partitioned on K" means: rows with equal K-values live on the
    same worker, placed by ``hash_partition_ids`` over K in order — the
    property the shuffle-elision pass exploits (paper Table 2)."""
    if isinstance(node, (Source, Scan)):
        return None
    if isinstance(node, Select):
        return partitioning_of(node.child)
    if isinstance(node, Project):
        p = partitioning_of(node.child)
        return p if p and set(p) <= set(node.names) else None
    if isinstance(node, Rename):
        p = partitioning_of(node.child)
        m = dict(node.mapping)
        return tuple(m.get(c, c) for c in p) if p else None
    if isinstance(node, MapColumns):
        return None  # conservatively: the map may rewrite key columns
    if isinstance(node, WithColumn):
        p = partitioning_of(node.child)
        # overwriting a partition-key column breaks co-partitioning; a new
        # column leaves the child's hash placement intact
        return None if p and node.name in p else p
    if isinstance(node, Join):
        if node.strategy in ("shuffle",):
            return node.on
        if node.strategy == "local":
            return partitioning_of(node.left)
        if node.strategy == "broadcast_left":   # left replicated, right in place
            return partitioning_of(node.right)
        if node.strategy == "broadcast_right":
            return partitioning_of(node.left)
        return None  # "auto"/"broadcast": unknown until planned
    if isinstance(node, GroupBy):
        return partitioning_of(node.child) if node.elide_shuffle else node.by
    if isinstance(node, Unique):
        return partitioning_of(node.child) if node.elide_shuffle else node.subset
    if isinstance(node, (Union, Difference)):
        return partitioning_of(node.left) if node.elide_shuffle else node.on
    if isinstance(node, (Sort, Rebalance)):
        return None  # range/round-robin placement, not hash
    if isinstance(node, Recode):
        p = partitioning_of(node.child)
        # rows don't move, but a recoded key column's hash placement no
        # longer matches hash_partition_ids over its (new) values
        recoded = {n for n, _ in node.mappings}
        return None if p and (set(p) & recoded) else p
    if isinstance(node, Fused):
        p = partitioning_of(node.child)
        for step in node.steps:
            if p is None:
                return None
            if isinstance(step, Select):
                continue
            if isinstance(step, Project):
                p = p if set(p) <= set(step.names) else None
            elif isinstance(step, Rename):
                m = dict(step.mapping)
                p = tuple(m.get(c, c) for c in p)
            elif isinstance(step, WithColumn):
                p = None if step.name in p else p
            else:  # MapColumns
                p = None
        return p
    raise TypeError(node)


def estimate_rows(node: Node, src_rows: Mapping, memo: dict | None = None,
                  stats=None) -> float:
    """Estimated global row count, propagated from measured source counts.

    ``src_rows`` maps source id -> exact global rows (one host sync per
    pipeline, done by the executor). Estimates use the paper's planning
    inputs: filter selectivity, key cardinality, and join multiplicity
    default to conservative constants when no hint is available. With
    ``stats`` (a ``repro_torch.stats.PlanStats``), scan predicate selectivity
    and groupby/unique key cardinality come from the dataset's chunk
    sketches instead of the fixed ratios — any estimate the sketches
    cannot support falls back to the constants.
    """
    memo = {} if memo is None else memo
    if id(node) in memo:
        return memo[id(node)]
    if isinstance(node, Source):
        r = float(src_rows.get(node.sid, node.capacity))
    elif isinstance(node, Scan):
        # predicates pushed into the scan filter before admission
        sel = stats.scan_selectivity(node) if stats is not None else None
        if sel is None:
            sel = SELECT_SELECTIVITY ** len(node.pred_sigs)
        r = float(src_rows.get(node.sid, node.capacity)) * sel
    elif isinstance(node, Select):
        r = SELECT_SELECTIVITY * estimate_rows(node.child, src_rows, memo,
                                               stats)
    elif isinstance(node, (Project, Rename, MapColumns, WithColumn, Sort,
                           Rebalance, Recode)):
        r = estimate_rows(node.child, src_rows, memo, stats)
    elif isinstance(node, Join):
        r = max(estimate_rows(node.left, src_rows, memo, stats),
                estimate_rows(node.right, src_rows, memo, stats))
    elif isinstance(node, GroupBy):
        card = node.cardinality_hint
        if card is None and stats is not None:
            card = stats.groupby_cardinality(node)
        card = card if card is not None and 0.0 < card <= 1.0 else UNKNOWN_CARDINALITY
        r = card * estimate_rows(node.child, src_rows, memo, stats)
    elif isinstance(node, Unique):
        card = stats.unique_cardinality(node) if stats is not None else None
        card = card if card is not None and 0.0 < card <= 1.0 else UNKNOWN_CARDINALITY
        r = card * estimate_rows(node.child, src_rows, memo, stats)
    elif isinstance(node, Union):
        r = (estimate_rows(node.left, src_rows, memo, stats)
             + estimate_rows(node.right, src_rows, memo, stats))
    elif isinstance(node, Difference):
        r = estimate_rows(node.left, src_rows, memo, stats)
    elif isinstance(node, Fused):
        r = estimate_rows(node.child, src_rows, memo, stats)
        for step in node.steps:
            if isinstance(step, Select):
                r *= SELECT_SELECTIVITY
    else:
        raise TypeError(node)
    memo[id(node)] = r
    return r


# -- traversal / display ------------------------------------------------------

def walk(root: Node):
    """Post-order traversal of the DAG, visiting shared nodes once."""
    seen: set = set()
    out: list = []

    def rec(n: Node):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            rec(c)
        out.append(n)

    rec(root)
    return out


def count_shuffles(root: Node) -> int:
    """Number of all-to-all shuffle communication ops the plan will execute
    (a join's co-partitioning pair counts as one shuffle op, matching the
    pattern taxonomy; elided/broadcast ops count zero)."""
    n = 0
    for node in walk(root):
        if isinstance(node, Join) and node.strategy in ("auto", "shuffle"):
            n += 1
        elif isinstance(node, (GroupBy, Unique, Union, Difference)) and not node.elide_shuffle:
            n += 1
        elif isinstance(node, (Sort, Rebalance)):
            n += 1
    return n


def _describe(node: Node) -> str:
    def planned(n):
        parts = []
        if n.quota is not None:
            parts.append(f"quota={n.quota}")
        if getattr(n, "capacity", None) is not None:
            parts.append(f"capacity={n.capacity}")
        if n.num_chunks is not None:
            parts.append(f"num_chunks={n.num_chunks}")
        return (" " + " ".join(parts)) if parts else ""

    if isinstance(node, Source):
        return (f"SOURCE#{node.sid} cols={schema_names(node.schema)} "
                f"capacity={node.capacity}")
    if isinstance(node, Scan):
        cols = node.columns if node.columns is not None else schema_names(node.schema)
        preds = ""
        if node.pred_names:
            shown = tuple(
                str(sig) if isinstance(sig, _expr.Expr) else name
                for name, sig in zip(node.pred_names, node.pred_sigs))
            preds = f" absorbed preds=[{', '.join(shown)}]"
        return (f"SCAN#{node.sid} cols={tuple(cols)} "
                f"batch_capacity={node.capacity}{preds}")
    if isinstance(node, Select):
        if node.expr is not None:
            return f"SELECT[{node.expr}]"
        return f"SELECT {node.name} used={node.used}"
    if isinstance(node, Project):
        star = "*" if node.synthetic else ""
        return f"PROJECT{star} cols={node.names}"
    if isinstance(node, Rename):
        return f"RENAME {dict(node.mapping)}"
    if isinstance(node, MapColumns):
        return f"MAP {node.name}"
    if isinstance(node, WithColumn):
        return f"WITH_COLUMN {node.name} = {node.expr}"
    if isinstance(node, Join):
        return f"JOIN on={node.on} strategy={node.strategy}{planned(node)}"
    if isinstance(node, GroupBy):
        s = f"GROUPBY by={node.by} aggs={node.aggs} pre_combine={node.pre_combine}"
        s += planned(node)
        s += " partials" if node.emit_partials else ""
        return s + (" elide_shuffle" if node.elide_shuffle else "")
    if isinstance(node, Unique):
        return (f"UNIQUE subset={node.subset}{planned(node)}"
                + (" elide_shuffle" if node.elide_shuffle else ""))
    if isinstance(node, Union):
        return (f"UNION on={node.on}{planned(node)}"
                + (" elide_shuffle" if node.elide_shuffle else ""))
    if isinstance(node, Difference):
        return (f"DIFFERENCE on={node.on}{planned(node)}"
                + (" elide_shuffle" if node.elide_shuffle else ""))
    if isinstance(node, Sort):
        return (f"SORT by={node.by}"
                + (" desc" if node.descending else "") + planned(node))
    if isinstance(node, Rebalance):
        parts = []
        if node.quota is not None:
            parts.append(f"quota={node.quota}")
        if node.num_chunks is not None:
            parts.append(f"num_chunks={node.num_chunks}")
        return "REBALANCE" + ((" " + " ".join(parts)) if parts else "")
    if isinstance(node, Recode):
        shown = " ".join(f"{n}->|{len(m)}|" for n, m in node.mappings)
        return f"RECODE {shown}"
    if isinstance(node, Fused):
        inner = []
        for s in node.steps:
            if isinstance(s, Select):
                inner.append(f"select[{s.expr}]" if s.expr is not None
                             else f"select:{s.name}")
            elif isinstance(s, Project):
                inner.append(f"project{'*' if s.synthetic else ''}{s.names}")
            elif isinstance(s, Rename):
                inner.append(f"rename{dict(s.mapping)}")
            elif isinstance(s, WithColumn):
                inner.append(f"with_column:{s.name}={s.expr}")
            else:
                inner.append(f"map:{s.name}")
        return "EP[" + " -> ".join(inner) + "]"
    return repr(node)


def format_plan(root: Node, src_rows: Mapping | None = None,
                stats=None) -> str:
    """Indented textual rendering of a plan tree (the ``.explain()`` body).

    Children print below their parent at one extra indent level; with
    ``src_rows`` each line carries the propagated row estimate. With
    ``stats`` (a ``repro_torch.stats.PlanStats``) scan lines additionally show
    the sketch-estimated predicate selectivity next to the fixed ratio
    the planner would otherwise assume (``sel~0.08 (fixed 0.25)``).
    ``stats`` is never passed by :func:`plan_signature`, so identity keys
    are unaffected. A summary line reports the shuffle-op count.
    """
    memo: dict = {}
    lines: list = []

    def rec(n: Node, depth: int):
        extra = ""
        if src_rows is not None:
            extra = f"  rows~{estimate_rows(n, src_rows, memo, stats):.0f}"
        if stats is not None and isinstance(n, Scan) and n.pred_sigs:
            est = stats.scan_selectivity(n)
            if est is not None:
                fixed = SELECT_SELECTIVITY ** len(n.pred_sigs)
                extra += f"  sel~{est:.3g} (fixed {fixed:.3g})"
        lines.append("  " * depth + _describe(n) + extra)
        for c in n.children:
            rec(c, depth + 1)

    rec(root, 0)
    lines.append(f"shuffles: {count_shuffles(root)}")
    return "\n".join(lines)


def plan_signature(root: Node) -> str:
    """Process-stable text identity of a plan's *shape*.

    :func:`format_plan` output normalized so that re-building the same
    pipeline — in this process or after a restart — yields the same
    string: object addresses are stripped (legacy predicate closures print
    as ``<function ... at 0x...>``) and the process-global source/scan id
    counters (``#N`` / ``sid=N``) are renumbered by first appearance.

    The identity key for anything that must recognize "the same query
    again" across processes or rebuilds (in the reference: the streaming
    checkpoint's ``query_key`` and the admission controller).
    """
    text = re.sub(r"0x[0-9a-f]+", "0x", format_plan(root))
    seen: dict[str, int] = {}

    def renum(m):
        s = m.group(1)
        if s not in seen:
            seen[s] = len(seen)
        return f"#{seen[s]}"

    text = re.sub(r"#(\d+)", renum, text)
    return re.sub(r"sid=(\d+)", lambda m: "sid=" + renum(m)[1:], text)
