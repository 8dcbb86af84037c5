"""Whole-pipeline executor for optimized logical plans.

The reference lowers an optimized DAG into one ``fn(comm, *tables)`` and
compiles it as a single jitted shard_map program. On one card there is no
program to compile: the executor composes the port's distributed operators
(``repro_torch.core.operators``) and local operators (``local_ops``) into
the same one callable over the (P, capacity) tables, with no
``torch.compile`` and no CUDA graph (the JAX package has neither). A fused
``EP[...]`` stage runs its steps in one pass, with no materialization
between plan nodes beyond what each PyTorch call makes.

Two host-side caches sit in front of execution:

- the optimized-plan cache (:data:`_PLAN_CACHE`), keyed as the
  reference's is (workers, structural plan, source row counts, kernel
  routing; the device stands where the mesh axes and fabric stand) --
  skips re-running the optimizer for repeated collects;
- the op cache (``repro_torch.core.api._OP_CACHE``), keyed by the fully
  planned DAG + argument schemas -- holds the composed callable.

Source row counts are fetched with a single device-to-host copy per
pipeline (:func:`source_row_counts`) and memoized on the source DDFs.

Over a process group (``DDFContext(group=...)``) the composed callable runs
on every rank over its block of the workers: each operator it calls goes
through the Communicator, and an elided shuffle is worker-local. What
decides the plan is global: the source row counts are gathered over the
group, so every rank optimizes the same plan, and the aux counters come
back as every worker's, ``(P,)`` on every rank. The cache keys stay the
reference's: a plan names its sources, and a DDF belongs to one context,
so a group and one device never share a plan or a callable they should
not (the callable takes the Communicator as an argument).
"""

from __future__ import annotations

import time
from typing import Mapping

import torch

from ..core import cost_model, operators
from ..core.api import DDF, DDFContext, _LRUCache, _schema_sig, cached_op
from ..core.dataframe import Table, concat
from ..core.local_ops import (
    finalize_groupby,
    local_anti_join,
    local_groupby,
    local_join,
    local_unique,
)
from ..core.local_ops import select as local_select
from ..core.local_ops import with_column as local_with_column
from ..obs import model_check as _model
from ..obs import trace as _trace
from . import optimizer
from .logical import (
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
    Source,
    Union,
    Unique,
    WithColumn,
    walk,
)

__all__ = ["execute", "run_planned", "optimized_plan", "source_row_counts",
           "cache_stats", "sync"]

_PLAN_CACHE = _LRUCache(maxsize=128)


def cache_stats() -> dict:
    """Telemetry snapshot of the two host-side caches:
    ``{"plan": {hits, misses, evictions, size, maxsize}, "op": {...}}``.
    Counters are cumulative for the process."""
    from ..core.api import _OP_CACHE

    return {"plan": _PLAN_CACHE.stats(), "op": _OP_CACHE.stats()}


def source_row_counts(sources: Mapping) -> dict:
    """Global row count per source id, with ONE device-to-host copy.

    The count vectors of every source whose row count is not known yet are
    concatenated on the device (over a group: gathered from every rank in
    one collective) and copied to the host in one ``.cpu()``; the results
    are memoized on the source DDFs (``DDF.num_rows``'s cache), so repeated
    collects over the same tables copy nothing."""
    out: dict = {}
    pending = []
    for s in sorted(sources):
        d = sources[s]
        if d._nrows is not None:
            out[s] = d._nrows
        else:
            pending.append(s)
    if pending:
        blk = sources[pending[0]].ctx.workers
        if blk.group is None:
            allc = torch.cat([sources[s].counts.reshape(-1) for s in pending]).cpu()
        else:
            mine = torch.stack([sources[s].counts for s in pending], dim=1)
            allc = blk.gather_workers(mine).T.reshape(-1).cpu()
        off, n = 0, blk.nworkers
        for s in pending:
            val = int(allc[off:off + n].sum())
            off += n
            out[s] = val
            sources[s]._nrows = val
    return out


def optimized_plan(root: Node, ctx: DDFContext, src_rows: Mapping,
                   level: str = "all", stats=None) -> Node:
    """Optimize (and fully plan) a logical DAG, with caching.

    ``level``: "all" runs every rewrite pass; "plan-only" runs just the
    cost-model shuffle planning (for A/B-ing the optimizer; execution always
    needs concrete quotas/capacities). The cost model is the card's
    (``cost_model.params_for_fabric``, the on-card ``DEVICE`` fabric). When
    ``stats`` (``repro_torch.stats.PlanStats``) inform the plan, its content
    hash keys the cache too, so re-sketched datasets never reuse stale
    plans."""
    from ..kernels import registry as _kernel_registry

    key = (ctx.nworkers, str(ctx.device), level, root,
           tuple(sorted(src_rows.items())),
           _kernel_registry.dispatch_signature(),
           stats.cache_key if stats is not None else None)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        params = cost_model.params_for_fabric()
        if level == "all":
            plan = optimizer.optimize(root, ctx.nworkers, src_rows, params,
                                      stats=stats)
        else:
            plan = optimizer.plan_shuffles(root, ctx.nworkers, src_rows,
                                           params, stats=stats)
        _PLAN_CACHE.put(key, plan)
    return plan


def _apply_ep(step: Node, t: Table) -> Table:
    """Apply one embarrassingly-parallel step to every worker's partition."""
    if isinstance(step, Select):
        return local_select(t, step.fn)
    if isinstance(step, Project):
        return Table({n: t.columns[n] for n in step.names}, t.nvalid)
    if isinstance(step, Rename):
        m = dict(step.mapping)
        return Table({m.get(k, k): v for k, v in t.columns.items()}, t.nvalid)
    if isinstance(step, MapColumns):
        return Table(dict(step.fn(t.columns)), t.nvalid)
    if isinstance(step, WithColumn):
        return local_with_column(t, step.name, step.fn)
    if isinstance(step, Recode):
        # vocabulary unification: one int32 gather per recoded column into
        # the merged code space; codes index as jax indexes, negatives from
        # the end, then clamped (padding slots may hold any int32)
        cols = dict(t.columns)
        for name, m in step.mappings:
            lut = torch.tensor(m, dtype=torch.int32, device=t.device)
            codes = cols[name].to(torch.int64)
            codes = torch.where(codes < 0, codes + len(lut), codes)
            cols[name] = lut[codes.clamp(0, len(lut) - 1)]
        return Table(cols, t.nvalid)
    raise TypeError(step)


def _make_plan_fn(root: Node, ordered_sids: tuple):
    """Compose the whole plan into one callable ``fn(comm, *tables) ->
    (Table, aux)``. A node's output is kept only while a parent still needs
    it: a node with one parent frees its output when that parent is done,
    so the plan peaks no higher than the eager steps would."""
    nodes = walk(root)
    order = {n: i for i, n in enumerate(nodes)}
    parents: dict = {}
    for n in nodes:
        for c in n.children:
            parents[c] = parents.get(c, 0) + 1

    def fn(comm, *tables):
        env = dict(zip(ordered_sids, tables))
        memo: dict = {}
        uses: dict = {}
        aux: dict = {}

        def put_aux(node, info: dict):
            i = order[node]
            for k, v in info.items():
                aux[f"n{i}:{k}"] = v

        def lower(node: Node) -> Table:
            if node in memo:
                out = memo[node]
                uses[node] -= 1
                if not uses[node]:
                    del memo[node], uses[node]
                return out
            if isinstance(node, (Source, Scan)):
                out = env[node.sid]
            elif isinstance(node, Fused):
                out = lower(node.child)
                for step in node.steps:
                    out = _apply_ep(step, out)
            elif isinstance(node, (Select, Project, Rename, MapColumns,
                                   WithColumn, Recode)):
                out = _apply_ep(node, lower(node.child))
            elif isinstance(node, Join):
                l, r = lower(node.left), lower(node.right)
                if node.strategy == "shuffle":
                    out, info = operators.dist_join_shuffle(
                        comm, l, r, node.on, node.quota, node.capacity,
                        num_chunks=node.num_chunks or 1)
                    put_aux(node, info)
                elif node.strategy == "local":
                    out, ov = local_join(l, r, node.on, node.capacity)
                    put_aux(node, {"overflow_join": ov})
                elif node.strategy == "broadcast_right":
                    out, info = operators.dist_join_broadcast(
                        comm, l, r, node.on, node.capacity)
                    put_aux(node, info)
                elif node.strategy == "broadcast_left":
                    out, info = operators.dist_join_broadcast(
                        comm, l, r, node.on, node.capacity, gather="left")
                    put_aux(node, info)
                else:
                    raise ValueError(f"unplanned join strategy {node.strategy!r}")
            elif isinstance(node, GroupBy):
                t = lower(node.child)
                aggs = {k: v for k, v in node.aggs}
                if node.elide_shuffle:
                    red, ov_agg = local_groupby(t, node.by, aggs,
                                                capacity=node.capacity,
                                                merge=False, with_overflow=True)
                    put_aux(node, {"overflow_agg": ov_agg})
                    out = red if node.emit_partials else finalize_groupby(red, aggs)
                else:
                    out, info = operators.dist_groupby(
                        comm, t, node.by, aggs, node.quota, node.capacity,
                        bool(node.pre_combine), num_chunks=node.num_chunks or 1,
                        finalize=not node.emit_partials)
                    put_aux(node, info)
            elif isinstance(node, Unique):
                t = lower(node.child)
                if node.elide_shuffle:
                    out, ov_agg = local_unique(t, node.subset,
                                               capacity=node.capacity,
                                               with_overflow=True)
                    put_aux(node, {"overflow_agg": ov_agg})
                else:
                    out, info = operators.dist_unique(
                        comm, t, node.subset, node.quota, node.capacity,
                        num_chunks=node.num_chunks or 1)
                    put_aux(node, info)
            elif isinstance(node, Union):
                l, r = lower(node.left), lower(node.right)
                if node.elide_shuffle:
                    out, ov_agg = local_unique(concat(l, r), node.on,
                                               capacity=node.capacity,
                                               with_overflow=True)
                    put_aux(node, {"overflow_agg": ov_agg})
                else:
                    out, info = operators.dist_union(
                        comm, l, r, node.on, node.quota, node.capacity,
                        num_chunks=node.num_chunks or 1)
                    put_aux(node, info)
            elif isinstance(node, Difference):
                l, r = lower(node.left), lower(node.right)
                if node.elide_shuffle:
                    out = local_anti_join(l, r, node.on, capacity=node.capacity)
                else:
                    out, info = operators.dist_difference(
                        comm, l, r, node.on, node.quota, node.capacity,
                        num_chunks=node.num_chunks or 1)
                    put_aux(node, info)
            elif isinstance(node, Sort):
                out, info = operators.dist_sort(
                    comm, lower(node.child), node.by, node.quota, node.capacity,
                    descending=node.descending, num_chunks=node.num_chunks or 1)
                put_aux(node, {"overflow_shuffle": info["overflow_shuffle"]})
            elif isinstance(node, Rebalance):
                out, info = operators.rebalance(
                    comm, lower(node.child), node.quota,
                    num_chunks=node.num_chunks or 1)
                put_aux(node, info)
            else:
                raise TypeError(node)
            if parents.get(node, 0) > 1:  # shared: later parents reuse it
                memo[node] = out
                uses[node] = parents[node] - 1
            return out

        try:
            return lower(root), aux
        finally:
            # ``lower`` refers to itself, a reference cycle that would keep
            # ``env`` (a streamed batch's table, say) on the card until the
            # cyclic collector runs
            del lower

    return fn


def execute(root: Node, ctx: DDFContext, sources: Mapping,
            src_rows: Mapping | None = None, level: str = "all"):
    """Optimize and run a logical plan.

    Args:
      root: the logical DAG to evaluate.
      ctx: execution environment (P workers on one device or over a group).
      sources: source id -> eager DDF backing each ``Source`` leaf.
      src_rows: optional pre-fetched source row counts (else one copy).
      level: optimizer level, see :func:`optimized_plan`.

    Returns:
      (result DDF, info dict) where info maps ``"n<i>:<counter>"`` aux keys
      (overflow counters etc., one entry per worker, all P of them on
      every rank of a group) per plan node.

    While tracing is on, the row counts and the optimized plan are built in
    a ``plan.build`` span, the run sits in a ``plan.execute`` span that
    ends in a synchronize, so the span's wall time covers the card's work
    too, and the plan's modeled operators get predicted-vs-observed samples
    (``repro_torch.obs.model_check``). Results are the same either way.
    """
    with _trace.span("plan.build"):
        src_rows = dict(src_rows) if src_rows is not None else source_row_counts(sources)
        plan = optimized_plan(root, ctx, src_rows, level=level)
    if not _trace.enabled():
        return run_planned(plan, ctx, sources)
    preds = _model.predict_plan(plan, ctx.nworkers, src_rows,
                                cost_model.params_for_fabric())
    with _trace.span("plan.execute", ops=len(preds), workers=ctx.nworkers,
                     nodes=len(walk(plan))) as sp:
        t0 = time.perf_counter()
        out, aux = run_planned(plan, ctx, sources)
        sync(out.counts)
        dt = time.perf_counter() - t0
        rows = out.num_rows()
        sp.set(wall_s=dt, out_rows=rows)
    _model.record_program(preds, dt, observed_rows=rows)
    return out, aux


def sync(t: torch.Tensor | torch.device) -> None:
    """Wait for the card's queued work on ``t``'s device, or on the device
    ``t`` (nothing on the CPU): the reference's ``jax.block_until_ready``
    for wall times."""
    dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_planned(plan: Node, ctx: DDFContext, sources: Mapping):
    """Run an already-optimized/planned DAG -- no optimizer pass.

    ``sources`` must bind every ``Source``/``Scan`` sid in ``plan``.
    Returns ``(result DDF, aux info dict)`` like :func:`execute`."""
    ordered_sids = tuple(sorted(sources))
    ddfs = [sources[s] for s in ordered_sids]
    arg_schemas = tuple(_schema_sig(d) for d in ddfs)
    op = cached_op(ctx, ("plan", plan), lambda: _make_plan_fn(plan, ordered_sids),
                   arg_schemas)
    out, aux = op(ctx.comm(), *(d.table() for d in ddfs))
    if ctx.group is not None:  # every worker's counters, on every rank
        aux = {k: ctx.workers.gather_workers(v) for k, v in aux.items()}
    return DDF(dict(out.columns), out.nvalid, ctx), dict(aux)
