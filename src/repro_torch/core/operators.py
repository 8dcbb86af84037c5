"""Distributed dataframe operators: the paper's parallel processing patterns.

Each function is the distributed promotion of a core local operator (paper
§4, Table 2): local op + auxiliary ops (partition / compact) + a
communication op, here over the workers a process holds, as the leading
tensor dimension: all P of one card, or a rank's block of a process group.
Every cross-worker step goes through the ``Communicator``. Callers pass
``quota`` and output ``capacity``; operators return one int32 overflow
counter per worker held, zero for well-sized quotas.

The shuffle build side (``hash_partition_ids``) runs the hash-partition
kernel and the groupby legs run the segment-reduce kernel on the card: a
join or a difference launches the first twice, a union once. The sort, the
windows, the global reductions, rebalance, head and transpose launch no
kernel of the port.

Per-worker auxiliary outputs (overflow counters, pivots, flags) come back
with a leading worker dimension, as the reference's do.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from . import promotion
from .comm.communicator import Communicator
from .dataframe import (Table, compact, concat, max_sentinel, min_sentinel, take_rows,
                        valid_mask, where_rows, wide)
from .local_ops import (column_aggregate_local, finalize_groupby, local_anti_join,
                        local_groupby, local_join, local_sort, local_unique)
from .partition import hash_partition_ids, range_partition_ids

__all__ = [
    "dist_join_shuffle",
    "dist_join_broadcast",
    "dist_groupby",
    "dist_unique",
    "dist_union",
    "dist_difference",
    "dist_sort",
    "dist_column_agg",
    "dist_length",
    "dist_window_sum",
    "dist_window_agg",
    "dist_transpose",
    "rebalance",
    "dist_head",
]


# -- Shuffle-Compute (paper §5.3.2) --------------------------------------------

def dist_join_shuffle(comm: Communicator, left: Table, right: Table,
                      key_columns: Sequence[str], quota: int, capacity: int,
                      num_chunks: int = 1) -> tuple[Table, dict]:
    """Hash-shuffle join: co-partition both relations by key hash, then join
    locally. Returns (joined table, {"overflow_left", "overflow_right",
    "overflow_join"})."""
    P = comm.size()
    dl = hash_partition_ids(left, key_columns, P)
    dr = hash_partition_ids(right, key_columns, P)
    lsh, ovl = comm.shuffle(left, dl, quota, num_chunks=num_chunks)
    del dl
    rsh, ovr = comm.shuffle(right, dr, quota, num_chunks=num_chunks)
    del dr
    out, ovj = local_join(lsh, rsh, key_columns, capacity)
    return out, {"overflow_left": ovl, "overflow_right": ovr, "overflow_join": ovj}


# -- Broadcast-Compute (paper §5.3.7) -------------------------------------------

def dist_join_broadcast(comm: Communicator, left: Table, right: Table,
                        key_columns: Sequence[str], capacity: int,
                        gather: str = "right") -> tuple[Table, dict]:
    """Broadcast join: replicate the small relation (``gather`` names it) on
    every worker and join it against the other side's partitions. Column
    roles are the same either way."""
    if gather == "left":
        out, ovj = local_join(comm.allgather(left), right, key_columns, capacity)
    else:
        out, ovj = local_join(left, comm.allgather(right), key_columns, capacity)
    return out, {"overflow_join": ovj}


# -- Combine-Shuffle-Reduce (paper §5.3.4) --------------------------------------

def dist_groupby(comm: Communicator, table: Table, key_columns: Sequence[str],
                 aggs: Mapping[str, Sequence[str]], quota: int, capacity: int,
                 pre_combine: bool = True, num_chunks: int = 1,
                 finalize: bool = True) -> tuple[Table, dict]:
    """GroupBy-aggregate. ``pre_combine=True`` is Combine-Shuffle-Reduce;
    False is plain Shuffle-Compute (paper §5.4.1). ``finalize=False`` keeps
    the mergeable partials (``<col>_sum`` / ``<col>_count`` / ...).

    Returns (aggregated table, {"overflow_shuffle": rows dropped at the
    shuffle, "overflow_agg": groups dropped at the reduce-side capacity})."""
    P = comm.size()
    partial = local_groupby(table, key_columns, aggs, merge=False) if pre_combine else table
    dest = hash_partition_ids(partial, key_columns, P)
    shuf, ov = comm.shuffle(partial, dest, quota, num_chunks=num_chunks)
    del partial, dest
    red, ov_agg = local_groupby(shuf, key_columns, aggs, capacity=capacity,
                                merge=pre_combine, with_overflow=True)
    out = finalize_groupby(red, aggs) if finalize else red
    return out, {"overflow_shuffle": ov, "overflow_agg": ov_agg}


def dist_unique(comm: Communicator, table: Table, key_columns: Sequence[str],
                quota: int, capacity: int, pre_combine: bool = True,
                num_chunks: int = 1) -> tuple[Table, dict]:
    """Distinct rows by key (Combine-Shuffle-Reduce): local dedup, hash
    shuffle by key, dedup of the merged rows. Returns (table,
    {"overflow_shuffle", "overflow_agg"})."""
    P = comm.size()
    t = local_unique(table, key_columns) if pre_combine else table
    dest = hash_partition_ids(t, key_columns, P)
    shuf, ov = comm.shuffle(t, dest, quota, num_chunks=num_chunks)
    del t, dest
    out, ov_agg = local_unique(shuf, key_columns, capacity=capacity, with_overflow=True)
    return out, {"overflow_shuffle": ov, "overflow_agg": ov_agg}


def dist_union(comm: Communicator, left: Table, right: Table, key_columns: Sequence[str],
               quota: int, capacity: int, num_chunks: int = 1) -> tuple[Table, dict]:
    """Set union = concat + distributed unique (paper Table 2)."""
    both = concat(left, right)
    return dist_unique(comm, both, key_columns, quota, capacity, num_chunks=num_chunks)


def dist_difference(comm: Communicator, left: Table, right: Table,
                    key_columns: Sequence[str], quota: int, capacity: int,
                    num_chunks: int = 1) -> tuple[Table, dict]:
    """Set difference: co-partition both sides by key hash, then a local
    anti-join. Returns (table, {"overflow_left", "overflow_right"})."""
    P = comm.size()
    dl = hash_partition_ids(left, key_columns, P)
    dr = hash_partition_ids(right, key_columns, P)
    lsh, ovl = comm.shuffle(left, dl, quota, num_chunks=num_chunks)
    del dl
    rsh, ovr = comm.shuffle(right, dr, quota, num_chunks=num_chunks)
    del dr
    out = local_anti_join(lsh, rsh, key_columns, capacity=capacity)
    return out, {"overflow_left": ovl, "overflow_right": ovr}


# -- Sample-Shuffle-Compute (paper §5.3.3) ---------------------------------------

def dist_sort(comm: Communicator, table: Table, key_column: str, quota: int,
              capacity: int, descending: bool = False,
              samples_per_worker: int | None = None,
              num_chunks: int = 1) -> tuple[Table, dict]:
    """Sample sort with regular sampling (Li et al., paper §5.3.3): local
    sort -> regular sample -> allgather samples -> pivots -> range
    partition -> shuffle -> local sort. Worker i ends with the i-th key
    range, sorted.

    The sample positions and pivot ranks are computed in float32 and an
    empty worker contributes a max sentinel, in either direction, exactly
    as the reference does, so the pivots are the reference's.

    Returns (sorted table, {"overflow_shuffle": (P,), "pivots": (P, P-1)})."""
    P = comm.size()
    if table.columns[key_column].dtype == torch.bool:
        raise TypeError(f"sort: bool key {key_column!r} has no max sentinel for the "
                        "samples of empty workers (the reference fails the same way)")
    s = samples_per_worker or max(P, 2)
    st = local_sort(table, [key_column], descending=descending)
    keys = st.columns[key_column]
    n = st.nvalid
    dev = keys.device
    pos = ((torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
           * n.to(torch.float32)[:, None]).to(torch.int32)
    pos = torch.minimum(torch.clamp(pos, min=0), torch.clamp(n - 1, min=0)[:, None])
    samp = take_rows(keys, pos.to(torch.int64))
    samp = where_rows((n > 0)[:, None], samp, max_sentinel(keys.dtype))
    all_samp = comm.allgather_array(samp, tiled=True)[0]  # the same on every worker
    total = torch.where(comm.allgather_array(n)[0] > 0, s, 0).sum(dtype=torch.int32)
    sort_key = wide(all_samp)  # uint32 orders as its int64 values
    if descending:
        sort_key = -sort_key if sort_key.is_floating_point() else ~sort_key
    ranks = (torch.arange(1, P, dtype=torch.float32, device=dev) / P
             * total.to(torch.float32)).to(torch.int32)
    at = torch.sort(sort_key, stable=True).indices[torch.clamp(ranks, 0, P * s - 1).to(torch.int64)]
    pivots = take_rows(all_samp[None], at[None])[0]
    dest = range_partition_ids(st, key_column, pivots, P, descending=descending)
    shuf, ov = comm.shuffle(st, dest, quota, capacity=capacity, num_chunks=num_chunks)
    del st, dest
    out = local_sort(shuf, [key_column], descending=descending)
    return out, {"overflow_shuffle": ov,
                 "pivots": pivots.expand(table.nworkers, P - 1)}


# -- Globally-Reduce (paper §5.3.5) ----------------------------------------------

def dist_column_agg(comm: Communicator, table: Table, name: str, op: str) -> torch.Tensor:
    """Column aggregation -> (P,) replicated value (local reduce +
    AllReduce)."""
    local_val, local_cnt = column_aggregate_local(table, name, op)
    if op in ("sum", "count"):
        return comm.allreduce(local_val, "sum")
    if op == "mean":
        s = comm.allreduce(local_val, "sum")
        c = comm.allreduce(local_cnt, "sum")
        return s / torch.clamp(c, min=1).to(s.dtype)
    if op in ("min", "max"):
        return comm.allreduce(local_val, op)
    raise ValueError(op)


def dist_length(comm: Communicator, table: Table) -> torch.Tensor:
    """Distributed length (paper §5.3.5): (P,) replicated int32."""
    return comm.allreduce(table.nvalid, "sum")


def _exclusive_prefix_count(comm: Communicator, n: torch.Tensor) -> torch.Tensor:
    """(local,) int32: the live rows of the workers before each one."""
    n_all = comm.allgather_array(n)[0]
    ex = torch.cumsum(n_all, dim=0, dtype=torch.int32) - n_all
    return ex[comm.workers.lo: comm.workers.hi]


def _global_index(comm: Communicator, table: Table) -> torch.Tensor:
    """(local, capacity) int32: each slot's index in the global row order."""
    return (_exclusive_prefix_count(comm, table.nvalid)[:, None]
            + torch.arange(table.capacity, dtype=torch.int32, device=table.device)[None, :])


# -- Halo Exchange (paper §5.3.6) -------------------------------------------------

def _halo_ext(comm: Communicator, table: Table, vz: torch.Tensor, window: int, fill):
    """[halo | vz]: every worker's rows after the last ``window - 1`` live
    rows of the worker before it (``fill`` where it has fewer, and on
    worker 0)."""
    w1 = window - 1
    n = table.nvalid
    dev = vz.device
    ar = torch.arange(w1, dtype=torch.int32, device=dev)
    tail_idx = torch.clamp(n[:, None] - w1 + ar[None, :], 0, table.capacity - 1)
    tail = torch.take_along_dim(vz, tail_idx.to(torch.int64), dim=1)
    tail = torch.where(ar[None, :] >= torch.clamp(w1 - n, min=0)[:, None], tail, fill)
    halo = comm.shift(tail, offset=1)
    halo = torch.where((comm.rank() > 0)[:, None], halo, fill)
    return torch.cat([halo.to(vz.dtype), vz], dim=1)


def _check_window(window: int) -> None:
    # the reference returns meaningless columns for these; the port refuses
    if window < 1:
        raise ValueError(f"rolling window must be at least 1, got {window}")


def _window_flags(comm: Communicator, table: Table, window: int):
    wvalid = (_global_index(comm, table) >= window - 1) & valid_mask(table)
    halo_short = (table.nvalid < window - 1) & (comm.rank() > 0)
    return wvalid, halo_short


def dist_window_sum(comm: Communicator, table: Table, value_column: str,
                    window: int) -> tuple[Table, dict]:
    """Rolling-window sum over the global row order (partition order =
    global order). Boundary windows take the previous worker's tail by a
    halo exchange. Emits ``<col>_rollsum`` (float32: differences of a
    float32 prefix sum, as the reference computes them) and
    ``window_valid`` (False for the first window-1 global rows).
    ``halo_short`` (P,) flags workers holding fewer than window-1 rows."""
    _check_window(window)
    w = window
    v = table.columns[value_column]
    vz = torch.where(valid_mask(table), v, 0).to(v.dtype)
    ext = _halo_ext(comm, table, vz, w, 0)  # (P, w-1 + cap)
    cs = torch.cumsum(ext.to(torch.float32), dim=1)
    cap = table.capacity
    upper = cs[:, w - 1: w - 1 + cap]
    lower = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)[:, :cap]
    wvalid, halo_short = _window_flags(comm, table, w)
    out = table.replace(**{f"{value_column}_rollsum": upper - lower, "window_valid": wvalid})
    return out, {"halo_short": halo_short}


def dist_window_agg(comm: Communicator, table: Table, value_column: str, window: int,
                    op: str = "sum") -> tuple[Table, dict]:
    """Rolling window aggregate over the global row order: sum | mean | min
    | max (paper §5.3.6 halo exchange). Each output row reduces the ``w``
    values ending at it (a ``unfold`` view of the extended rows); sums and
    means add in float32. Emits ``<col>_roll<op>`` (float32) and
    ``window_valid``."""
    _check_window(window)
    w = window
    v = table.columns[value_column]
    if v.dtype == torch.bool and op in ("min", "max"):
        raise TypeError(f"rolling {op}: a bool column has no {op} sentinel (the "
                        "reference fails the same way)")
    if op in ("sum", "mean"):
        fill = 0
    elif op == "min":
        fill = max_sentinel(v.dtype)
    elif op == "max":
        fill = min_sentinel(v.dtype)
    else:
        raise ValueError(op)
    vz = torch.where(valid_mask(table), v, fill).to(v.dtype)
    windows = _halo_ext(comm, table, vz, w, fill).unfold(1, w, 1)  # (P, cap, w)
    if op == "sum":
        roll = windows.to(torch.float32).sum(dim=2)
    elif op == "mean":
        # jnp.mean multiplies by the float32 reciprocal of the count
        roll = windows.to(torch.float32).sum(dim=2) * float(np.float32(1) / np.float32(w))
    elif op == "min":
        roll = windows.amin(dim=2).to(torch.float32)
    else:
        roll = windows.amax(dim=2).to(torch.float32)
    wvalid, halo_short = _window_flags(comm, table, w)
    out = table.replace(**{f"{value_column}_roll{op}": roll, "window_valid": wvalid})
    return out, {"halo_short": halo_short}


# -- Partitioned I/O / rebalance (paper §5.3.8, §8) --------------------------------

def rebalance(comm: Communicator, table: Table, quota: int, capacity: int | None = None,
              num_chunks: int = 1) -> tuple[Table, dict]:
    """Evenly redistribute rows across workers, keeping the global order:
    worker i ends with floor(n/P) rows, one more for the first n mod P."""
    P = comm.size()
    total = comm.allgather_array(table.nvalid)[0].sum(dtype=torch.int32)
    base, rem = total // P, total % P
    ranks = torch.arange(P, dtype=torch.int32, device=table.device)
    targets = base + (ranks < rem).to(torch.int32)
    cum_targets = torch.cumsum(targets, dim=0, dtype=torch.int32)
    dest = torch.searchsorted(cum_targets, _global_index(comm, table),
                              right=True).to(torch.int32)
    dest = torch.where(valid_mask(table), torch.clamp(dest, 0, P - 1), P)
    out, ov = comm.shuffle(table, dest, quota, capacity=capacity, num_chunks=num_chunks)
    return out, {"overflow_shuffle": ov}


def dist_head(comm: Communicator, table: Table, k: int) -> Table:
    """Global head(k): keep the rows with global index < k (stays
    partitioned)."""
    return compact(table, _global_index(comm, table) < k)


def dist_transpose(comm: Communicator, table: Table, capacity: int | None = None) -> Table:
    """Distributed transpose (paper Table 2): every worker gathers all rows
    and emits the c columns as c rows under ``r0 .. r{N-1}``, one per slot
    of the gathered capacity (padding slots included), with ``__col`` the
    column's index in sorted-name order. The columns promote to one dtype
    as ``jnp.stack`` promotes them. For tables whose transposed width fits
    a partition."""
    L = table.nworkers
    gathered = comm.allgather(table, capacity=capacity)
    names = sorted(gathered.columns)
    dt, _ = promotion.result_type(
        *((promotion.dtype_name(gathered.columns[k].dtype), False) for k in names))
    # every worker holds the same gathered rows: stack worker 0's
    mat = torch.stack([promotion.convert(gathered.columns[k][0], dt) for k in names])
    c = len(names)
    cols = {"__col": torch.arange(c, dtype=torch.int32, device=mat.device).expand(L, c)}
    for i in range(gathered.capacity):
        cols[f"r{i}"] = mat[:, i].expand(L, c)
    return Table(cols, torch.full((L,), c, dtype=torch.int32, device=mat.device))
