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

Not ported yet (ROADMAP queue A item 3): ``local_sort``,
``local_anti_join`` and the embarrassingly-parallel operators.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..kernels import ops as kernel_ops
from .dataframe import Table, compact, max_sentinel, min_sentinel, resize_rows, valid_mask
from .partition import hash_columns

__all__ = [
    "agg_schema",
    "local_join",
    "local_groupby",
    "finalize_groupby",
    "local_unique",
]

_AGG_OPS = ("sum", "count", "min", "max", "mean")

_INVALID_HASH_LEFT = 0xFFFFFFFF
_INVALID_HASH_RIGHT = 0xFFFFFFFE


def _sort_key(v: torch.Tensor) -> torch.Tensor:
    """A tensor that ``torch.sort`` orders as the reference orders ``v``."""
    if v.dtype == torch.bool:
        return v.to(torch.uint8)
    if v.dtype == torch.uint32:
        return v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return v


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
    cols = {k: torch.take_along_dim(v, order, dim=1) for k, v in table.columns.items()}
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


# -- unique (hash dedup, paper Table 4) ---------------------------------------

def local_unique(table: Table, key_columns: Sequence[str],
                 capacity: int | None = None, with_overflow: bool = False):
    """Deduplicate each worker's rows by key columns (first occurrence in
    hash order wins). ``with_overflow=True`` also returns (P,) int32 counts
    of distinct rows that did not fit in ``capacity``."""
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
        out_cols[name] = torch.take_along_dim(st.columns[name], first_idx, dim=1)

    def seg_reduce(vals, op):
        if op == "min":
            vals = torch.where(m, vals, max_sentinel(vals.dtype))
        elif op == "max":
            vals = torch.where(m, vals, min_sentinel(vals.dtype))
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
        if op == "count":
            if merge:
                vals = st.columns[src]
                out_cols[out_name] = seg_reduce(torch.where(m, vals, 0).to(vals.dtype), "sum")
            else:
                ones = m.to(torch.int32)
                out_cols[out_name] = _seg_reduce_dispatch(ones, seg, nseg, "sum")[:, :cap]
        else:
            base = st.columns[src]
            vals = torch.where(m, base, 0).to(base.dtype) if op == "sum" else base
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
        emit &= (torch.take_along_dim(ls.columns[name], out_l, dim=1)
                 == torch.take_along_dim(right.columns[name], out_r, dim=1))
    lvalid = valid_mask(ls)
    emit &= torch.take_along_dim(lvalid, out_l, dim=1) & torch.take_along_dim(rm, out_r, dim=1)

    cols: dict[str, torch.Tensor] = {}
    for name in key_columns:
        cols[name] = torch.take_along_dim(ls.columns[name], out_l, dim=1)
    for name, v in ls.columns.items():
        if name not in key_columns:
            cols[name] = torch.take_along_dim(v, out_l, dim=1)
    for name, v in right.columns.items():
        if name not in key_columns:
            out_name = name if name not in cols else f"{name}{suffix}"
            cols[out_name] = torch.take_along_dim(v, out_r, dim=1)

    full = torch.full((left.nworkers,), capacity, dtype=torch.int32, device=dev)
    res = compact(Table(cols, full), emit, capacity=capacity)
    overflow = torch.clamp(total - capacity, min=0)
    return res, overflow
