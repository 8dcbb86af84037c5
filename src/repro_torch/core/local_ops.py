"""Core local operators (paper §4.1, Table 4), batched over workers.

Every operator works on the ``(P, capacity)`` columns of all workers at
once: sorts along dim 1, batched ``searchsorted``, ``take_along_dim``
gathers and ``cumsum(dim=1)``. Outputs are capacity-bounded with an
explicit ``nvalid`` and, where the true output can exceed the capacity, an
overflow counter -- the reference's contract.

- Rows are matched on a 32-bit key hash and checked against the key columns
  on emission, so hash collisions cost capacity, never correctness.
- Multi-column keys sort lexicographically by (valid, hash, col1, col2,
  ...), with chained stable sorts in place of ``jnp.lexsort``.
- Integer reductions stay in the column's dtype and wrap, as jax's do with
  64-bit mode off (torch would widen an int32 sum to int64).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from ..obs import trace as _trace
from . import promotion
from .dataframe import (Table, canonical_numpy, compact, max_sentinel, min_sentinel,
                        narrow_u32, resize_rows, take_rows, valid_mask, where_rows, wide)
from .partition import hash_columns

__all__ = [
    "agg_schema",
    "local_sort",
    "local_join",
    "local_groupby",
    "finalize_groupby",
    "local_unique",
    "local_anti_join",
    "select",
    "project",
    "with_column",
    "row_aggregate",
    "column_aggregate_local",
]

_AGG_OPS = ("sum", "count", "min", "max", "mean")

_INVALID_HASH_LEFT = 0xFFFFFFFF
_INVALID_HASH_RIGHT = 0xFFFFFFFE


def _sort_key(v: torch.Tensor) -> torch.Tensor:
    """A tensor that ``torch.sort`` orders as the reference orders ``v``."""
    if v.dtype == torch.bool:
        return v.to(torch.uint8)
    return wide(v)


def _lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """(P, n) int64 order sorting by ``keys``, the LAST key primary (as
    ``jnp.lexsort``), stable: chained stable sorts, least significant
    first."""
    order = None
    for k in keys:
        k = _sort_key(k)
        if order is not None:
            k = torch.take_along_dim(k, order, dim=1)
        idx = torch.sort(k, dim=1, stable=True).indices
        order = idx if order is None else torch.take_along_dim(order, idx, dim=1)
    return order


def _sorted_by_key_hash(table: Table, key_columns: Sequence[str]):
    """Sort every worker's rows by (valid first, key hash, key columns...).
    Returns (sorted_table, sorted_hash, order); invalid rows sit at the tail
    with hash 0xFFFFFFFF."""
    h = hash_columns(table, key_columns)
    m = valid_mask(table)
    h = torch.where(m, h, _INVALID_HASH_LEFT)
    # (invalid, hash) as one int64 key: the two most significant sort keys
    primary = (~m).to(torch.int64) << 32 | h
    keys = [table.columns[n] for n in reversed(key_columns)] + [primary]
    order = _lexsort(keys)
    cols = {k: take_rows(v, order) for k, v in table.columns.items()}
    return Table(cols, table.nvalid), torch.take_along_dim(h, order, dim=1), order


def _adjacent_new_group(sorted_table: Table, key_columns: Sequence[str]) -> torch.Tensor:
    """is_new[w, i]: row i of worker w starts a new key group."""
    P, cap = sorted_table.nworkers, sorted_table.capacity
    is_new = torch.zeros((P, cap), dtype=torch.bool, device=sorted_table.device)
    is_new[:, 0] = True
    for name in key_columns:
        v = sorted_table.columns[name]
        is_new[:, 1:] |= v[:, 1:] != v[:, :-1]
    return is_new


# -- embarrassingly-parallel primitives (paper §5.3.1) -------------------------

def _as_tensor(v, table: Table) -> torch.Tensor:
    """A callable's result as a tensor on the table's device; a Python or
    numpy scalar takes the dtype ``jnp.asarray`` gives it (x64 off)."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(canonical_numpy(np.asarray(v))))
    return v.to(table.device)


def _broadcast(v: torch.Tensor, table: Table) -> torch.Tensor:
    if v.dim() == 0:
        return v.expand(table.nworkers, table.capacity).contiguous()
    return v


def select(table: Table, pred) -> Table:
    """Filter rows by a predicate over the column dict. O(n)."""
    keep = _broadcast(_as_tensor(pred(table.columns), table), table)
    if keep.dtype != torch.bool:
        raise TypeError(f"select: the predicate must be boolean, got {keep.dtype}")
    return compact(table, keep)


def project(table: Table, names: Sequence[str]) -> Table:
    """Column projection: zero-copy column selection."""
    return Table({n: table.columns[n] for n in names}, table.nvalid)


def with_column(table: Table, name: str, fn) -> Table:
    """Add (or overwrite) one column computed by ``fn`` over the column
    dict; a scalar result broadcasts to the capacity."""
    v = _broadcast(_as_tensor(fn(table.columns), table), table)
    return table.replace(**{name: v})


def row_aggregate(table: Table, names: Sequence[str], out: str, op: str = "sum") -> Table:
    """Per-row aggregate across columns -> new column ``out`` (paper §5.3.1),
    in jax's dtypes: the columns promote to one dtype; a sum of bool or
    narrow signed ints is int32; a mean is float32."""
    dt, _ = promotion.result_type(*((promotion.dtype_name(table.columns[n].dtype), False)
                                    for n in names))
    stack = torch.stack([promotion.convert(table.columns[n], dt) for n in names], dim=0)
    if op == "sum":
        # jax sums bool and narrow signed ints in int32, uint8 in uint32
        if dt in ("uint8", "uint32"):
            v = narrow_u32(wide(stack).to(torch.int64).sum(dim=0))
        else:
            acc = promotion.torch_dtype_of("int32" if dt in ("bool", "int8", "int16") else dt)
            v = stack.sum(dim=0, dtype=acc)
    elif op in ("min", "max"):
        v = wide(stack).amin(dim=0) if op == "min" else wide(stack).amax(dim=0)
        v = narrow_u32(v) if stack.dtype == torch.uint32 else v
    elif op == "mean":
        v = stack.to(torch.float32).sum(dim=0) / len(names)
    else:
        raise ValueError(op)
    return table.replace(**{out: v})


def column_aggregate_local(table: Table, name: str, op: str):
    """Local leg of the Globally-Reduce pattern (paper §5.3.5): per worker,
    (value, live-row count), both (P,). Sums and means add in float32, as
    the reference does, so they are exact only while every partial sum is
    (integer values under 2**24)."""
    v = table.columns[name]
    if v.dtype == torch.bool and op in ("min", "max"):
        raise TypeError(f"agg {op}: a bool column has no {op} sentinel (the reference "
                        "fails the same way)")
    m = valid_mask(table)
    cnt = m.sum(dim=1, dtype=torch.int32)
    if op in ("sum", "mean"):
        return where_rows(m, v, 0).to(v.dtype).to(torch.float32).sum(dim=1), cnt
    if op in ("min", "max"):
        w = where_rows(m, v, max_sentinel(v.dtype) if op == "min" else min_sentinel(v.dtype))
        r = wide(w).amin(dim=1) if op == "min" else wide(w).amax(dim=1)
        r = narrow_u32(r) if v.dtype == torch.uint32 else r
        if v.dtype.is_floating_point:
            # a worker holding a NaN keeps the NaN the reference's fold keeps,
            # the groupby's rule (kernels.segment_reduce): max the first NaN
            # with the sign bit set, min the first with it clear, else the
            # last NaN; without a host sync
            nan = w.isnan()
            neg = w.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[w.element_size()]) < 0
            prefer = nan & (neg if op == "max" else ~neg)
            first = prefer.to(torch.uint8).argmax(dim=1)
            last = w.shape[1] - 1 - nan.flip(1).to(torch.uint8).argmax(dim=1)
            pick = torch.where(prefer.any(dim=1), first, last)
            r = torch.where(r.isnan(), w.gather(1, pick[:, None])[:, 0], r)
        return r, cnt
    if op == "count":
        return cnt, cnt
    raise ValueError(op)


# -- sorting -------------------------------------------------------------------

def local_sort(table: Table, key_columns: Sequence[str], descending: bool = False) -> Table:
    """Sort every worker's rows by ``key_columns``; invalid rows stay at the
    tail and equal keys keep their order (stable). Descending maps each key
    by an order-reversing map: -x for floats, ~x for ints (exact, no INT_MIN
    overflow)."""
    with _trace.span("local.sort"):
        keys = []
        for name in reversed(key_columns):
            k = _sort_key(table.columns[name])
            if descending:
                k = -k if k.is_floating_point() else ~k
            keys.append(k)
        keys.append(~valid_mask(table))  # primary: invalid rows last
        order = _lexsort(keys)
        cols = {k: take_rows(v, order) for k, v in table.columns.items()}
        return Table(cols, table.nvalid)


# -- unique (hash dedup, paper Table 4) ---------------------------------------

def local_unique(table: Table, key_columns: Sequence[str],
                 capacity: int | None = None, with_overflow: bool = False):
    """Deduplicate each worker's rows by key columns (first occurrence in
    hash order wins). ``with_overflow=True`` also returns (P,) int32 counts
    of distinct rows that did not fit in ``capacity``."""
    with _trace.span("local.unique"):
        st, _, _ = _sorted_by_key_hash(table, key_columns)
        keep = _adjacent_new_group(st, key_columns) & valid_mask(st)
        out = compact(st, keep, capacity=capacity)
        if not with_overflow:
            return out
        cap_out = st.capacity if capacity is None else capacity
        ov = torch.clamp(keep.sum(dim=1, dtype=torch.int32) - cap_out, min=0)
        return out, ov


# -- groupby (combine / reduce legs, paper §5.3.4) ------------------------------

def _seg_reduce_dispatch(vals: torch.Tensor, seg: torch.Tensor, nseg: int,
                         op: str) -> torch.Tensor:
    """One segment reduction for all workers in one kernel call.

    ``vals`` is (P, cap), already masked or sentinel-filled; ``seg`` is
    (P, cap) dense non-decreasing ids with ``nseg - 1`` the invalid bucket.
    Worker w's ids are offset by ``w * nseg``, which keeps the flattened ids
    sorted; they must fit in int32. Returns (P, nseg)."""
    P, cap = vals.shape
    if P * nseg >= 2**31:
        raise ValueError(
            f"{P} workers x {nseg} segments overflow the kernel's int32 segment "
            f"ids; use fewer workers or a smaller capacity")
    offs = torch.arange(P, dtype=torch.int32, device=vals.device)[:, None] * nseg
    flat_seg = (seg + offs).reshape(P * cap)
    out = kernel_ops.segment_reduce(vals.reshape(P * cap, 1), flat_seg, P * nseg, op=op)
    return out.view(P, nseg)


def agg_schema(aggs: Mapping[str, Sequence[str]]) -> list[tuple[str, str, str]]:
    """[(value_col, op, out_col)]."""
    out = []
    for col, ops in aggs.items():
        for op in ops:
            if op not in _AGG_OPS:
                raise ValueError(f"unsupported agg {op}")
            out.append((col, op, f"{col}_{op}"))
    return out


def local_groupby(
    table: Table,
    key_columns: Sequence[str],
    aggs: Mapping[str, Sequence[str]],
    capacity: int | None = None,
    merge: bool = False,
    with_overflow: bool = False,
):
    """Groupby via sort + segment reduction, on every worker.

    merge=False: input is raw rows; emits key columns + <col>_<op> partials
    (mean contributes <col>_sum and <col>_count).
    merge=True: input columns are partials named <col>_<op>; re-reduces
    them (sum of sums, min of mins, ...).
    with_overflow=True: also return (P,) int32 groups that did not fit in
    ``capacity``.
    """
    with _trace.span("local.groupby"):
        P, cap = table.nworkers, table.capacity
        dev = table.device
        cap_out = cap if capacity is None else capacity
        st, _, _ = _sorted_by_key_hash(table, key_columns)
        m = valid_mask(st)
        is_new = _adjacent_new_group(st, key_columns) & m
        gid = torch.cumsum(is_new.to(torch.int32), dim=1, dtype=torch.int32) - 1
        seg = torch.where(m, gid, cap)  # invalid -> overflow bucket
        nseg = cap + 1

        out_cols: dict[str, torch.Tensor] = {}
        # group representative (first row of each group) for the key columns;
        # groups past the last one point at row cap - 1, as the reference's
        # clipped segment_min does
        rows = torch.arange(cap, dtype=torch.int64, device=dev).expand(P, cap)
        first_idx = torch.full((P, nseg), cap - 1, dtype=torch.int64, device=dev)
        first_idx.scatter_(1, torch.where(is_new, gid, cap).to(torch.int64), rows)
        first_idx = first_idx[:, :cap]
        for name in key_columns:
            out_cols[name] = take_rows(st.columns[name], first_idx)

        def seg_reduce(vals, op):
            if op == "min":
                vals = where_rows(m, vals, max_sentinel(vals.dtype))
            elif op == "max":
                vals = where_rows(m, vals, min_sentinel(vals.dtype))
            elif op != "sum":
                raise ValueError(op)
            return _seg_reduce_dispatch(vals, seg, nseg, op)[:, :cap]

        needed: dict[str, tuple[str, str]] = {}  # out partial -> (source, merge op)
        for col, op, out_name in agg_schema(aggs):
            if op == "mean":
                needed[f"{col}_sum"] = (f"{col}_sum" if merge else col, "sum")
                needed[f"{col}_count"] = (f"{col}_count" if merge else col, "count")
            elif op == "count":
                needed[f"{col}_count"] = (f"{col}_count" if merge else col, "count")
            else:
                needed[out_name] = (out_name if merge else col, op)

        for out_name, (src, op) in needed.items():
            if st.columns[src].dim() > 2 and (merge or op != "count"):
                # the reference masks a vector column's rows with a (n,) mask,
                # which does not broadcast against them
                raise ValueError(f"Incompatible shapes for broadcasting: {op} of {src!r}, "
                                 f"whose rows have shape {tuple(st.columns[src].shape[2:])}")
            if op == "count":
                if merge:
                    vals = st.columns[src]
                    out_cols[out_name] = seg_reduce(where_rows(m, vals, 0).to(vals.dtype), "sum")
                else:
                    ones = m.to(torch.int32)
                    out_cols[out_name] = _seg_reduce_dispatch(ones, seg, nseg, "sum")[:, :cap]
            else:
                base = st.columns[src]
                vals = where_rows(m, base, 0).to(base.dtype) if op == "sum" else base
                out_cols[out_name] = seg_reduce(vals, op)

        ngroups = is_new.sum(dim=1, dtype=torch.int32)
        # groups are already at the front in order: compaction is a resize
        out = Table({k: resize_rows(v, cap_out) for k, v in out_cols.items()},
                    torch.clamp(ngroups, max=cap_out))
        if not with_overflow:
            return out
        return out, torch.clamp(ngroups - cap_out, min=0)


def finalize_groupby(table: Table, aggs: Mapping[str, Sequence[str]]) -> Table:
    """Compute mean = sum / count and drop helper partials not requested."""
    cols = dict(table.columns)
    requested = set()
    for col, op, out_name in agg_schema(aggs):
        if op == "mean":
            s = cols[f"{col}_sum"]
            c = torch.clamp(cols[f"{col}_count"], min=1)
            cols[out_name] = s.to(torch.float32) / c.to(torch.float32)
        requested.add(out_name)
    helpers = {f"{c}_{o}" for c in aggs for o in _AGG_OPS}
    keep_names = {n for n in table.columns if n not in helpers} | requested
    return Table({k: v for k, v in cols.items() if k in keep_names}, table.nvalid)


# -- join (sort-based hash join, paper Table 4) --------------------------------

def local_join(
    left: Table,
    right: Table,
    key_columns: Sequence[str],
    capacity: int,
    suffix: str = "_r",
) -> tuple[Table, torch.Tensor]:
    """Inner equi-join of every worker's partitions. Returns (result,
    (P,) int32 overflow = pairs beyond capacity).

    Left is sorted by key hash; each right row binary-searches its hash run;
    pairs are expanded to ``capacity`` slots; emitted pairs are checked
    against the key columns (collision-exact)."""
    with _trace.span("local.join"):
        dev = left.device
        ls, lh, _ = _sorted_by_key_hash(left, key_columns)
        rm = valid_mask(right)
        rh = hash_columns(right, key_columns)
        rh = torch.where(rm, rh, _INVALID_HASH_RIGHT)  # differs from left's pad
        lo = torch.searchsorted(lh, rh, side="left")
        hi = torch.searchsorted(lh, rh, side="right")
        counts = (hi - lo).to(torch.int32)
        incl = torch.cumsum(counts, dim=1, dtype=torch.int32)
        offs = incl - counts  # exclusive prefix
        total = incl[:, -1]

        cap_l, cap_r = left.capacity, right.capacity
        out_pos = torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]
        # jnp.repeat(arange(cap_r), counts, total_repeat_length=capacity): the
        # right row of output slot j is the first row whose inclusive prefix
        # passes j; slots past the total repeat the last row
        out_r = torch.searchsorted(incl, out_pos.expand(left.nworkers, capacity).contiguous(),
                                   right=True)
        out_r = torch.clamp(out_r, max=cap_r - 1)
        within = out_pos - torch.take_along_dim(offs, out_r, dim=1)
        out_l = torch.clamp(torch.take_along_dim(lo, out_r, dim=1) + within, 0, cap_l - 1)

        emit = out_pos < total[:, None]
        # check true key equality (hash-collision guard) + validity
        for name in key_columns:
            emit &= take_rows(ls.columns[name], out_l) == take_rows(right.columns[name], out_r)
        lvalid = valid_mask(ls)
        emit &= torch.take_along_dim(lvalid, out_l, dim=1) & torch.take_along_dim(rm, out_r, dim=1)

        cols: dict[str, torch.Tensor] = {}
        for name in key_columns:
            cols[name] = take_rows(ls.columns[name], out_l)
        for name, v in ls.columns.items():
            if name not in key_columns:
                cols[name] = take_rows(v, out_l)
        for name, v in right.columns.items():
            if name not in key_columns:
                out_name = name if name not in cols else f"{name}{suffix}"
                cols[out_name] = take_rows(v, out_r)

        full = torch.full((left.nworkers,), capacity, dtype=torch.int32, device=dev)
        res = compact(Table(cols, full), emit, capacity=capacity)
        overflow = torch.clamp(total - capacity, min=0)
        return res, overflow


def local_anti_join(left: Table, right: Table, key_columns: Sequence[str],
                    capacity: int | None = None, dedup_left: bool = True) -> Table:
    """Rows of ``left`` whose key is not in ``right`` (the set-difference
    leg), in key-hash order.

    Exact under hash collisions: the deduplicated keys are joined with
    :func:`local_join` (whose emitted pairs are checked against the key
    columns) and the hits are scattered back onto the left rows by index.
    Both sides are deduplicated, so the pairs fit the left capacity."""
    with _trace.span("local.anti_join"):
        lu = local_unique(left, key_columns) if dedup_left else left
        ru = local_unique(right, key_columns)
        ls, _, _ = _sorted_by_key_hash(lu, key_columns)
        P, cap = ls.nworkers, ls.capacity
        lidx = torch.arange(cap, dtype=torch.int32, device=ls.device).expand(P, cap)
        pairs, _ = local_join(
            Table({**{n: ls.columns[n] for n in key_columns}, "__lidx": lidx}, ls.nvalid),
            Table({n: ru.columns[n] for n in key_columns}, ru.nvalid),
            key_columns, capacity=cap)
        hit = valid_mask(pairs)
        slot = torch.where(hit, pairs.columns["__lidx"], cap).to(torch.int64)
        member = torch.zeros((P, cap + 1), dtype=torch.bool, device=ls.device)
        member.scatter_(1, slot, True)
        keep = valid_mask(ls) & ~member[:, :cap]
        return compact(ls, keep, capacity=capacity)
