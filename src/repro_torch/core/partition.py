"""Auxiliary partition operators (paper §4.2), batched over workers.

Hash partitioning and the shuffle-buffer builder: every live row gets a
destination partition, and rows are laid into fixed per-destination
``(P, quota)`` buffers with explicit overflow accounting, so the
all-to-all is a fixed-shape exchange (``comm.collectives``).

Hashes are int64 tensors holding uint32 values: torch has no uint32
shifts, adds or remainders on the CPU, and int32 storage would turn hashes
above 2**31 negative and change the sort orders built on them.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import ops as kernel_ops
from ..kernels import registry
from ..kernels.hash_partition import MASK32, combine_hash, lowbias32
from ..obs import trace as _trace
from .dataframe import Table, put_rows, take_rows, valid_mask, wide

__all__ = [
    "u32_normalize",
    "hash32",
    "hash_columns",
    "hash_partition_ids",
    "range_partition_ids",
    "build_shuffle_buffers",
    "ShuffleBuffers",
    "default_quota",
]


def u32_normalize(x: torch.Tensor) -> torch.Tensor:
    """The uint32 key bits of any column, as an int32 tensor.

    64-bit ints fold hi ^ lo, bools widen, floats bitcast (equal floats hash
    equal), narrower ints sign-extend -- as the reference's ``u32_normalize``
    gives them. Shared by the plain hash chain and the kernel build side."""
    if x.dtype in (torch.int64, torch.uint64):
        u = x.view(torch.int64)
        return ((u ^ (u >> 32)) & MASK32).to(torch.int32)
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.dtype.is_floating_point:
        return x.to(torch.float32).view(torch.int32)
    return x.to(torch.int32)


def hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 of any column: int64 tensor of uint32 values."""
    return lowbias32(u32_normalize(x).to(torch.int64) & MASK32)


def hash_columns(table: Table, key_columns: Sequence[str]) -> torch.Tensor:
    """(P, capacity) int64 combined uint32 hash over the key columns."""
    h = torch.zeros((table.nworkers, table.capacity), dtype=torch.int64,
                    device=table.device)
    for name in key_columns:
        h = combine_hash(h, hash32(table.columns[name]))
    return h


def hash_partition_ids(table: Table, key_columns: Sequence[str],
                       num_partitions: int) -> torch.Tensor:
    """(P, capacity) int32 destination per row; invalid rows get
    ``num_partitions`` (a drop bucket).

    The shuffle build side of every shuffle-based operator. On the card one
    kernel launch hashes the rows of all workers; on the CPU the plain hash
    chain runs. Both give the same destinations."""
    P, cap = table.nworkers, table.capacity
    with _trace.span("partition.hash"):
        mode = registry.resolve("hash_partition", table.nvalid)
        if mode == "cuda":
            keys = torch.stack([u32_normalize(table.columns[n]).reshape(P * cap)
                                for n in key_columns], dim=1)
            dest, _ = kernel_ops.hash_partition(keys, num_partitions, force="cuda",
                                                with_hist=False)
            dest = dest.view(P, cap)
        else:
            dest = (hash_columns(table, key_columns) % num_partitions).to(torch.int32)
        return torch.where(valid_mask(table), dest, num_partitions)


def range_partition_ids(table: Table, key_column: str, pivots: torch.Tensor,
                        num_partitions: int, descending: bool = False) -> torch.Tensor:
    """(P, capacity) int32 ordered destinations from one (P-1,) pivot vector
    (sample sort, paper §5.3.3); invalid rows get ``num_partitions``.

    Ascending, a key goes past every pivot <= it; descending negates pivots
    and keys (integers too, wrapping at INT_MIN, and uint32 modulo 2**32,
    as the reference does) and goes past every pivot > it. uint32 keys
    compare as their int64 values."""
    keys = table.columns[key_column]
    with _trace.span("partition.range"):
        unsigned = keys.dtype == torch.uint32
        keys, pivots = wide(keys), wide(pivots)
        if descending:
            neg = (lambda x: -x & 0xFFFFFFFF) if unsigned else (lambda x: -x)  # noqa: E731
            dest = torch.searchsorted(neg(pivots), neg(keys), right=False)
        else:
            dest = torch.searchsorted(pivots, keys, right=True)
        dest = torch.clamp(dest.to(torch.int32), 0, num_partitions - 1)
        return torch.where(valid_mask(table), dest, num_partitions)


class ShuffleBuffers(dict):
    """columns: name -> (P_src, P_dst, quota, *tail) buffers; counts: (P_src, P_dst)
    int32 rows per destination; overflow: (P_src,) int32 rows dropped because
    a destination exceeded quota."""

    def __init__(self, columns, counts, overflow):
        super().__init__(columns)
        self.columns = columns
        self.counts = counts
        self.overflow = overflow


def build_shuffle_buffers(table: Table, dest: torch.Tensor, num_partitions: int,
                          quota: int) -> ShuffleBuffers:
    """Lay every worker's live rows into fixed (P, quota) per-destination
    buffers, stable within each destination.

    Rows whose destination bucket is full are counted in ``overflow`` and
    dropped; callers size ``quota`` so that overflow is zero in practice."""
    P, cap = num_partitions, table.capacity
    W = table.nworkers
    dev = table.device
    with _trace.span("shuffle.buffers"):
        dest = dest.to(torch.int32)
        order = torch.argsort(dest, dim=1, stable=True)
        sdest = torch.take_along_dim(dest, order, dim=1)
        # rank of each row within its destination group
        group_start = torch.searchsorted(sdest, sdest, side="left")
        rank = torch.arange(cap, dtype=torch.int64, device=dev)[None, :] - group_start
        is_row = sdest < P  # the drop bucket (== P) is excluded
        keep = is_row & (rank < quota)
        # raw per-destination counts (including overflowing rows), from the
        # group boundaries of the sorted destinations
        bounds = torch.arange(P + 1, dtype=torch.int32, device=dev).expand(W, P + 1)
        edges = torch.searchsorted(sdest, bounds.contiguous(), side="left")
        raw = (edges[:, 1:] - edges[:, :-1]).to(torch.int32)
        counts = torch.clamp(raw, max=quota)
        overflow = (raw - counts).sum(dim=1, dtype=torch.int32)

        # flat slot per kept row; dropped rows go to a dump slot past the end
        slot = torch.where(keep, sdest.to(torch.int64) * quota + rank, P * quota)
        cols = {}
        for name, col in table.columns.items():
            tail = tuple(col.shape[2:])
            buf = torch.zeros((W, P * quota + 1) + tail, dtype=col.dtype, device=dev)
            put_rows(buf, slot, take_rows(col, order))
            cols[name] = buf[:, : P * quota].view((W, P, quota) + tail)
        return ShuffleBuffers(cols, counts, overflow)


def default_quota(capacity: int, num_partitions: int, safety: float = 2.0) -> int:
    """Quota for uniformly distributed keys: E[rows/dest] x safety (+8),
    clipped to the capacity."""
    base = -(-capacity // num_partitions)  # ceil
    q = int(base * safety) + 8
    return min(q, capacity)
