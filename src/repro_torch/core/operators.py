"""Distributed dataframe operators: the paper's parallel processing patterns.

Each function is the distributed promotion of a core local operator (paper
§4, Table 2): local op + auxiliary ops (partition / compact) + a
communication op, here over the P workers of one card held as the leading
tensor dimension. Callers pass ``quota`` and output ``capacity``; operators
return (P,) int32 overflow counters that are zero for well-sized quotas.

The shuffle build side (``hash_partition_ids``) runs the hash-partition
kernel and the groupby legs run the segment-reduce kernel on the card.

Not ported yet (ROADMAP queue A item 6): ``dist_sort``, ``dist_union``,
``dist_difference``, ``dist_column_agg``, the window operators,
``rebalance``, ``dist_head`` and ``dist_transpose``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from .comm.communicator import Communicator
from .dataframe import Table
from .local_ops import finalize_groupby, local_groupby, local_join, local_unique
from .partition import hash_partition_ids

__all__ = [
    "dist_join_shuffle",
    "dist_join_broadcast",
    "dist_groupby",
    "dist_unique",
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
