"""Rewrite passes over logical plans (the cost-model-driven query optimizer).

``optimize`` runs, in order:

0. :func:`normalize_predicates` — constant-fold expression predicates and
   AND-split boolean conjunctions into separate ``SELECT`` nodes, so each
   conjunct can sink independently (different join sides, into a SCAN).
1. :func:`pushdown_predicates` — sink ``SELECT`` below projections, sorts and
   (side-resolvable) joins so filters run before shuffles shrink payloads.
2. :func:`pushdown_projections` — thread the set of columns each ancestor
   actually needs down the DAG and insert minimal ``PROJECT*`` nodes below
   shuffle boundaries (shrinks shuffled bytes; paper §5: comm terms scale
   with bold-n in bytes).
3. :func:`plan_shuffles` — the single host-side planning pass: concretize
   every shuffle op's strategy, quota, capacity and pipeline depth
   ``num_chunks`` from DAG-propagated size estimates via the Hockney cost
   model (in place of eager mode's per-method planning).
4. :func:`elide_shuffles` — co-partition reuse (paper Table 2): drop a keyed
   op's shuffle when its input is already hash-partitioned on a subset of
   its keys (e.g. join→groupby on the same key runs the groupby locally).
5. :func:`fuse_elementwise` — collapse adjacent embarrassingly-parallel ops
   into one ``EP[...]`` stage that runs as one pass over the (P, capacity)
   table.

All passes are pure: nodes are immutable, so each pass rebuilds the DAG
bottom-up and returns a new root. Every pass is also exposed individually so
tests can assert on single rewrites via ``format_plan``. These are the
reference's passes (``repro.plan.optimizer``) with one difference: on one
card the pipeline depth is always 1 (``cost_model.choose_chunk_count``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .. import expr as _expr
from ..core import cost_model, patterns
from ..core.partition import default_quota
from .logical import (
    JOIN_SUFFIX,
    Difference,
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
    Union,
    Unique,
    WithColumn,
    capacity_of,
    estimate_rows,
    partitioning_of,
    row_bytes_of,
    schema_names,
    schema_of,
)

__all__ = [
    "optimize",
    "normalize_predicates",
    "pushdown_predicates",
    "pushdown_projections",
    "pushdown_scans",
    "plan_shuffles",
    "elide_shuffles",
    "fuse_elementwise",
]

_EP = (Select, Project, Rename, MapColumns, WithColumn)


def _rewrite_up(root: Node, fn) -> Node:
    """Bottom-up structural rewrite: children first, then ``fn`` per node."""
    memo: dict = {}

    def rec(orig: Node) -> Node:
        if id(orig) in memo:
            return memo[id(orig)]
        n = orig
        kids = tuple(rec(c) for c in n.children)
        if kids != n.children:
            n = n.with_children(kids)
        out = fn(n)
        memo[id(orig)] = out
        return out

    return rec(root)


# -- pass 0: expression-predicate normalization --------------------------------

def _expr_select(child: Node, e, name: str) -> Select:
    """Build a SELECT from an expression tree (lowered body, exact used
    set, identity = the tree itself)."""
    return Select(child, _expr.to_torch_fn(e), name,
                  tuple(sorted(_expr.referenced_columns(e))), expr=e)


def normalize_predicates(root: Node) -> Node:
    """Constant-fold expression predicates and split boolean conjunctions.

    ``SELECT[(a > 3) & (b < 7)]`` becomes two stacked SELECTs so each
    conjunct pushes down independently (one can sink to a join's left
    input, the other to its right, or into a SCAN). The split preserves
    bit-exact semantics: filtering twice keeps the same surviving rows in
    the same order, and ``&`` is only split when both sides are boolean
    over the child schema (it is also integer bitwise-AND). Legacy callable
    predicates pass through untouched — their structure is opaque.
    """

    def norm(node: Node) -> Node:
        if not (isinstance(node, Select) and node.expr is not None):
            return node
        e = _expr.fold_constants(node.expr)
        parts = _expr.split_conjuncts(e, schema_of(node.child))
        if len(parts) == 1 and parts[0] == node.expr:
            return node
        out = node.child
        for i, p in enumerate(parts):
            nm = node.name if len(parts) == 1 else f"{node.name}.{i}"
            out = _expr_select(out, p, nm)
        return out

    return _rewrite_up(root, norm)


# -- pass 1: predicate pushdown ----------------------------------------------

def _sink_select_once(sel: Select) -> Node:
    """Push one SELECT one level down when legal; returns ``sel`` unchanged
    otherwise. Legality needs the predicate's accessed columns (``used``)."""
    child = sel.child
    if sel.used is None:
        return sel
    used = set(sel.used)
    if isinstance(child, Project) and used <= set(child.names):
        return dataclasses.replace(
            child, child=dataclasses.replace(sel, child=child.child))
    if isinstance(child, WithColumn) and child.name not in used:
        # the filter does not read the computed column: filter first, so
        # fewer rows pay the expression (and the SELECT keeps sinking)
        return dataclasses.replace(
            child, child=dataclasses.replace(sel, child=child.child))
    if isinstance(child, Sort):
        # filter-then-sort: same rows in the same global order (sample-sort
        # pivots move, but equal keys stay co-located and ties stay stable).
        return dataclasses.replace(
            child, child=dataclasses.replace(sel, child=child.child))
    if isinstance(child, Join):
        lnames = set(schema_names(schema_of(child.left)))
        rnames = set(schema_names(schema_of(child.right)))
        on = set(child.on)
        if used <= lnames:
            return dataclasses.replace(
                child, left=dataclasses.replace(sel, child=child.left))
        # names clashing with the left side are suffixed in the join output,
        # so an un-suffixed name in `used` can only target the right side if
        # it does not collide with a left non-key column.
        if used <= (rnames | on) and not (used & (lnames - on)):
            return dataclasses.replace(
                child, right=dataclasses.replace(sel, child=child.right))
    return sel


def pushdown_predicates(root: Node) -> Node:
    """Sink SELECT nodes below projections, sorts and joins (to fixpoint)."""
    prev = None
    while prev != root:
        prev = root
        root = _rewrite_up(
            root, lambda n: _sink_select_once(n) if isinstance(n, Select) else n)
    return root


# -- pass 2: projection pushdown ----------------------------------------------

def _maybe_project(node: Node, needed: frozenset) -> Node:
    names = schema_names(schema_of(node))
    keep = tuple(sorted(n for n in names if n in needed))
    if keep and set(keep) < set(names):
        return Project(node, keep, synthetic=True)
    return node


def pushdown_projections(root: Node) -> Node:
    """Insert minimal PROJECT* nodes below shuffle boundaries.

    The required-column set flows top-down from the root schema; at every
    shuffle input (join/groupby/... child) and source, columns nobody above
    needs are dropped before they are shuffled.
    """

    def prune(node: Node, needed: frozenset) -> Node:
        if isinstance(node, Select):
            used = set(node.used) if node.used is not None else set(
                schema_names(schema_of(node.child)))
            return dataclasses.replace(
                node, child=prune(node.child, frozenset(needed | used)))
        if isinstance(node, Project):
            keep = tuple(n for n in node.names if n in needed) or node.names
            return dataclasses.replace(
                node, names=keep, child=prune(node.child, frozenset(keep)))
        if isinstance(node, Rename):
            inv = {new: old for old, new in node.mapping}
            child_needed = frozenset(inv.get(n, n) for n in needed)
            return dataclasses.replace(node, child=prune(node.child, child_needed))
        if isinstance(node, MapColumns):
            child_names = set(schema_names(schema_of(node.child)))
            used = set(node.used) if node.used is not None else child_names
            child = prune(node.child, frozenset(used))
            return dataclasses.replace(node, child=_maybe_project(child, frozenset(used)))
        if isinstance(node, WithColumn):
            if node.name not in needed:
                # dead computed column: nobody above reads it, drop the node
                return prune(node.child, needed)
            refs = _expr.referenced_columns(node.expr)
            child_needed = frozenset((needed - {node.name}) | refs)
            child = prune(node.child, child_needed)
            return dataclasses.replace(
                node, child=_maybe_project(child, child_needed))
        if isinstance(node, Join):
            lnames = set(schema_names(schema_of(node.left)))
            on = set(node.on)
            needed_l = set((needed & lnames) | on)
            needed_r = set(on)
            for rn, _, _ in schema_of(node.right):
                if rn in on:
                    continue
                out_name = rn if rn not in lnames else rn + JOIN_SUFFIX
                if out_name in needed:
                    needed_r.add(rn)
                    if out_name != rn:
                        # an ancestor references the suffixed name; keep the
                        # colliding left column so the suffix (and thus the
                        # output schema) survives pruning
                        needed_l.add(rn)
            needed_l = frozenset(needed_l)
            left = _maybe_project(prune(node.left, needed_l), needed_l)
            right = _maybe_project(prune(node.right, frozenset(needed_r)),
                                   frozenset(needed_r))
            return dataclasses.replace(node, left=left, right=right)
        if isinstance(node, GroupBy):
            child_needed = frozenset(set(node.by) | {c for c, _ in node.aggs})
            child = _maybe_project(prune(node.child, child_needed), child_needed)
            return dataclasses.replace(node, child=child)
        if isinstance(node, Unique):
            child_needed = frozenset(needed | set(node.subset))
            child = _maybe_project(prune(node.child, child_needed), child_needed)
            return dataclasses.replace(node, child=child)
        if isinstance(node, Union):
            child_needed = frozenset(needed | set(node.on))
            left = _maybe_project(prune(node.left, child_needed), child_needed)
            right = _maybe_project(prune(node.right, child_needed), child_needed)
            return dataclasses.replace(node, left=left, right=right)
        if isinstance(node, Difference):
            needed_l = frozenset(needed | set(node.on))
            needed_r = frozenset(node.on)  # anti-join reads only the keys
            left = _maybe_project(prune(node.left, needed_l), needed_l)
            right = _maybe_project(prune(node.right, needed_r), needed_r)
            return dataclasses.replace(node, left=left, right=right)
        if isinstance(node, Sort):
            child_needed = frozenset(needed | {node.by})
            child = _maybe_project(prune(node.child, child_needed), child_needed)
            return dataclasses.replace(node, child=child)
        if isinstance(node, Rebalance):
            child = _maybe_project(prune(node.child, needed), frozenset(needed))
            return dataclasses.replace(node, child=child)
        if isinstance(node, Recode):
            # keep only the gather maps for columns an ancestor reads; a
            # fully-pruned recode disappears (the merged-vocab metadata
            # lives on the LazyDDF, not the node)
            maps = tuple((n, m) for n, m in node.mappings if n in needed)
            child = prune(node.child, needed)
            if not maps:
                return child
            return dataclasses.replace(node, mappings=maps, child=child)
        # Source (and any leaf): narrowing happens at the consumer boundary.
        return node

    out_names = frozenset(schema_names(schema_of(root)))
    return prune(root, out_names)


# -- pass 2b: scan pushdown ----------------------------------------------------

def _host_pred_ok(fn, schema) -> bool:
    """Probe whether a select predicate can run host-side on numpy columns
    (the scan's pre-admission filter). Mirrors ``probe_columns`` but with a
    plain numpy table; any exception or a non-boolean/miss-shaped result
    means the predicate stays on the device."""
    cols = {n: np.ones((2,) + tuple(tail), dtype=np.dtype(dt))
            for n, dt, tail in schema}
    try:
        out = np.asarray(fn(dict(cols)))
    except Exception:
        return False
    return out.shape[:1] == (2,) and out.dtype in (np.dtype(bool),)


def pushdown_scans(root: Node) -> Node:
    """Absorb projections and predicates sitting on a ``SCAN`` into the scan.

    Three rewrites run to fixpoint:

    - ``PROJECT(SCAN)`` -> ``SCAN[columns]`` — only the referenced ``.npz``
      members are decompressed per batch;
    - ``SELECT(SCAN)`` -> ``SCAN[+pred]`` — the predicate runs host-side on
      the decoded chunk *before* rows are admitted to the device.
      Expression predicates absorb when host-portable
      (``repro_torch.expr.host_portable``: numpy and the device lowering
      provably agree — float *arithmetic* promotes differently and keeps
      the SELECT on device), compiling straight to numpy
      (``repro_torch.expr.to_numpy_fn``) with no trial probe; the tree
      becomes the scan's structural signature.
      Legacy callables are probed on a tiny numpy table first; ones that
      cannot run on numpy stay as device SELECTs;
    - ``PROJECT(SELECT(x))`` -> ``SELECT(PROJECT(x))`` when the predicate's
      accessed columns survive the projection, so projections keep sinking
      toward the scan.
    """

    def preds_survive_narrow(sc: Scan, restricted) -> bool:
        # expression preds always survive: the runner decodes their exact
        # referenced columns on top of the projected set; callables must
        # re-probe against the restricted schema
        return all(isinstance(sig, _expr.Expr) or _host_pred_ok(fn, restricted)
                   for sig, fn in zip(sc.pred_sigs, sc.pred_fns))

    def absorb(node: Node) -> Node:
        if isinstance(node, Project) and isinstance(node.child, Scan):
            sc = node.child
            narrowed = dataclasses.replace(sc, columns=tuple(sorted(node.names)))
            if sc.pred_fns and not preds_survive_narrow(sc, schema_of(narrowed)):
                return node
            return narrowed
        if isinstance(node, Select) and isinstance(node.child, Scan):
            sc = node.child
            if node.expr is not None:
                if _expr.host_portable(node.expr, schema_of(sc)):
                    return dataclasses.replace(
                        sc,
                        pred_names=sc.pred_names + (node.name,),
                        pred_sigs=sc.pred_sigs + (node.expr,),
                        pred_fns=sc.pred_fns + (_expr.to_numpy_fn(node.expr),))
                return node  # float-arith predicate: stays a device SELECT
            if node.fn_sig and _host_pred_ok(node.fn, schema_of(sc)):
                return dataclasses.replace(
                    sc,
                    pred_names=sc.pred_names + (node.name,),
                    pred_sigs=sc.pred_sigs + (node.fn_sig,),
                    pred_fns=sc.pred_fns + (node.fn,))
        if (isinstance(node, Project) and isinstance(node.child, Select)
                and node.child.used is not None
                and set(node.child.used) <= set(node.names)):
            sel = node.child
            return dataclasses.replace(
                sel, child=dataclasses.replace(node, child=sel.child))
        if isinstance(node, Project) and isinstance(node.child, Recode):
            # PROJECT(RECODE(x)) -> RECODE(PROJECT(x)): projections keep
            # sinking toward the scan; maps for projected-away columns drop
            rc = node.child
            keep = set(node.names)
            maps = tuple((n, m) for n, m in rc.mappings if n in keep)
            proj = dataclasses.replace(node, child=rc.child)
            if not maps:
                return proj
            return dataclasses.replace(rc, mappings=maps, child=proj)
        return node

    prev = None
    while prev != root:
        prev = root
        root = _rewrite_up(root, absorb)
    return root


# -- pass 3: cost-model shuffle planning ---------------------------------------

def plan_shuffles(root: Node, nworkers: int, src_rows: Mapping,
                  params: cost_model.CostParams | None = None,
                  stats=None) -> Node:
    """Concretize strategy / quota / capacity / ``num_chunks`` per shuffle op.

    One host-side pass over the whole DAG: row estimates propagate from the
    (single-sync) source counts, row widths come from the post-pushdown
    schemas, and the cost model picks the join strategy and the pipeline
    depth (``cost_model.choose_chunk_count``, 1 on one card). Explicit user
    overrides (non-None quota/capacity/num_chunks/strategy) are respected.
    With ``stats`` (``repro_torch.stats.PlanStats``), scan selectivities and
    groupby/unique key cardinalities come from the dataset sketches: a
    hint-free GroupBy gets its ``cardinality_hint`` pinned to the sketch
    estimate so ``patterns.plan_groupby`` and the cost model plan from a
    real cardinality instead of the unknown sentinel.
    """
    P = nworkers
    p = params or cost_model.CostParams()
    memo: dict = {}

    def rows(n: Node) -> float:
        return estimate_rows(n, src_rows, memo, stats)

    def chunks(node, n_rows_w: float, rb: float):
        if node.num_chunks is not None:
            return node.num_chunks
        return cost_model.choose_chunk_count(P, n_rows_w * rb, p)

    def plan(node: Node) -> Node:
        if isinstance(node, Join):
            cap_l = capacity_of(node.left, P)
            # the join shuffles BOTH relations with one quota, so size it
            # (and the output) from the larger side
            cap_m = max(cap_l, capacity_of(node.right, P))
            quota = node.quota or default_quota(cap_m, P)
            capacity = node.capacity or 2 * cap_m
            nl, nr = rows(node.left), rows(node.right)
            rb = (row_bytes_of(schema_of(node.left))
                  + row_bytes_of(schema_of(node.right))) / 2.0
            strategy = node.strategy
            if strategy == "auto":
                strategy = cost_model.choose_join_strategy(nl, nr, P, rb, p)
            if strategy == "broadcast":
                strategy = "broadcast_left" if nl <= nr else "broadcast_right"
            num_chunks = node.num_chunks or 1
            if strategy == "shuffle":
                num_chunks = chunks(node, (nl + nr) / max(P, 1), rb)
            return dataclasses.replace(node, strategy=strategy, quota=quota,
                                       capacity=capacity, num_chunks=num_chunks)
        if isinstance(node, GroupBy):
            cap = capacity_of(node.child, P)
            hint = node.cardinality_hint
            if hint is None and stats is not None:
                est = stats.groupby_cardinality(node)
                if est is not None:
                    hint = round(est, 3)
                    node = dataclasses.replace(node, cardinality_hint=hint)
            card = hint if hint is not None else 0.0
            plan_ = patterns.plan_groupby(card, P, node.capacity or cap,
                                          pre_combine=node.pre_combine)
            rb = row_bytes_of(schema_of(node.child))
            return dataclasses.replace(
                node,
                pre_combine=plan_.strategy == "combine_shuffle_reduce",
                quota=node.quota or default_quota(cap, P),
                capacity=node.capacity or cap,
                num_chunks=chunks(node, rows(node.child) / max(P, 1), rb))
        if isinstance(node, Unique):
            cap = capacity_of(node.child, P)
            rb = row_bytes_of(schema_of(node.child))
            return dataclasses.replace(
                node, quota=node.quota or default_quota(cap, P),
                capacity=node.capacity or cap,
                num_chunks=chunks(node, rows(node.child) / max(P, 1), rb))
        if isinstance(node, Union):
            cap = capacity_of(node.left, P) + capacity_of(node.right, P)
            rb = row_bytes_of(schema_of(node.left))
            n_w = (rows(node.left) + rows(node.right)) / max(P, 1)
            return dataclasses.replace(
                node, quota=node.quota or default_quota(cap, P),
                capacity=node.capacity or cap,
                num_chunks=chunks(node, n_w, rb))
        if isinstance(node, Difference):
            cap = capacity_of(node.left, P)
            # both relations shuffle with one quota (see Join above)
            cap_q = max(cap, capacity_of(node.right, P))
            rb = row_bytes_of(schema_of(node.left))
            return dataclasses.replace(
                node, quota=node.quota or default_quota(cap_q, P),
                capacity=node.capacity or cap,
                num_chunks=chunks(node, rows(node.left) / max(P, 1), rb))
        if isinstance(node, Sort):
            cap = capacity_of(node.child, P)
            rb = row_bytes_of(schema_of(node.child))
            return dataclasses.replace(
                node, quota=node.quota or default_quota(cap, P, safety=3.0),
                capacity=node.capacity or 2 * cap,
                num_chunks=chunks(node, rows(node.child) / max(P, 1), rb))
        if isinstance(node, Rebalance):
            cap = capacity_of(node.child, P)
            rb = row_bytes_of(schema_of(node.child))
            return dataclasses.replace(
                node, quota=node.quota or cap,
                num_chunks=chunks(node, rows(node.child) / max(P, 1), rb))
        return node

    return _rewrite_up(root, plan)


# -- pass 4: shuffle elision (co-partition reuse) ------------------------------

def elide_shuffles(root: Node) -> Node:
    """Drop shuffles whose input is already co-partitioned on the op's key.

    A keyed op needs rows with equal keys co-located. If the input is
    hash-partitioned on tuple T and T's columns are a subset of the op's
    keys, equal op-keys imply equal T — already co-located, so the op runs
    locally (paper Table 2's co-partition column). Binary set ops and joins
    additionally need both inputs partitioned by the *same* tuple (same hash
    placement). Runs after :func:`plan_shuffles` so join strategies are
    concrete.
    """

    def elide(node: Node) -> Node:
        if isinstance(node, GroupBy) and not node.elide_shuffle:
            p = partitioning_of(node.child)
            if p and set(p) <= set(node.by):
                return dataclasses.replace(node, elide_shuffle=True)
        if isinstance(node, Unique) and not node.elide_shuffle:
            p = partitioning_of(node.child)
            if p and set(p) <= set(node.subset):
                return dataclasses.replace(node, elide_shuffle=True)
        if isinstance(node, Join) and node.strategy == "shuffle":
            pl, pr = partitioning_of(node.left), partitioning_of(node.right)
            if pl and pl == pr and set(pl) <= set(node.on):
                return dataclasses.replace(node, strategy="local")
        if isinstance(node, (Union, Difference)) and not node.elide_shuffle:
            pl, pr = partitioning_of(node.left), partitioning_of(node.right)
            if pl and pl == pr and set(pl) <= set(node.on):
                return dataclasses.replace(node, elide_shuffle=True)
        return node

    return _rewrite_up(root, elide)


# -- pass 5: embarrassingly-parallel fusion ------------------------------------

def fuse_elementwise(root: Node) -> Node:
    """Fuse chains of adjacent EP ops into single ``Fused`` stages."""

    def fuse(node: Node) -> Node:
        if isinstance(node, _EP):
            c = node.child
            if isinstance(c, Fused):
                return Fused(c.child, c.steps + (node,))
            if isinstance(c, _EP):
                return Fused(c.child, (c, node))
        return node

    return _rewrite_up(root, fuse)


# -- the full pipeline ---------------------------------------------------------

def optimize(root: Node, nworkers: int, src_rows: Mapping,
             params: cost_model.CostParams | None = None,
             stats=None) -> Node:
    """Run all rewrite passes and return the optimized, fully-planned root.

    ``stats`` (an optional ``repro_torch.stats.PlanStats``) feeds
    sketch-derived selectivities/cardinalities into the shuffle-planning
    pass; omitted, the planner keeps its fixed conservative ratios."""
    root = normalize_predicates(root)
    root = pushdown_predicates(root)
    root = pushdown_projections(root)
    root = pushdown_scans(root)
    root = plan_shuffles(root, nworkers, src_rows, params, stats=stats)
    root = elide_shuffles(root)
    root = fuse_elementwise(root)
    return root
