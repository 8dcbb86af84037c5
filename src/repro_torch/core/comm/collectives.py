"""Table collectives over the P workers of one card (paper §3, Table 1).

The reference runs each collective inside ``shard_map`` over a mesh of P
devices. Here the P workers are the leading dimension of every tensor, so
the all-to-all of the ``(P_src, P_dst, quota)`` shuffle buffers is
``transpose(0, 1)``: worker ``d`` receives slab ``[s, d]`` from every source
``s``. Received rows are compacted source-major and stable within each
source, the reference's order exactly.

Not ported yet (ROADMAP queue A item 4): the Bruck all-to-all, gather,
broadcast, scatter, the array allreduce and the ``channels`` module.
"""

from __future__ import annotations

import torch

from ..dataframe import Table, compact
from ..partition import build_shuffle_buffers

__all__ = ["shuffle_table", "shuffle_table_pipelined", "allgather_table"]


def shuffle_table(table: Table, dest: torch.Tensor, quota: int,
                  capacity: int | None = None) -> tuple[Table, torch.Tensor]:
    """All-to-all shuffle of live rows to their ``dest`` workers.

    Args:
      table: the P workers' partitions.
      dest: (P, capacity) int32 destination per row; invalid rows carry P.
      quota: slots per (source, destination) pair.
      capacity: output capacity per worker (default ``P * quota``).

    Returns:
      (received table, (P,) int32 overflow per source worker).
    """
    P = table.nworkers
    bufs = build_shuffle_buffers(table, dest, P, quota)
    recv_counts = bufs.counts.transpose(0, 1)  # [dst, src]
    keep = (torch.arange(quota, dtype=torch.int32, device=table.device)[None, None, :]
            < recv_counts[:, :, None]).reshape(P, P * quota)
    cols = {k: v.transpose(0, 1).reshape(P, P * quota) for k, v in bufs.columns.items()}
    full = torch.full((P,), P * quota, dtype=torch.int32, device=table.device)
    out = compact(Table(cols, full), keep, capacity=capacity)
    return out, bufs.overflow


def shuffle_table_pipelined(table: Table, dest: torch.Tensor, quota: int,
                            num_chunks: int,
                            capacity: int | None = None) -> tuple[Table, torch.Tensor]:
    """K-chunk shuffle with the contract of :func:`shuffle_table`.

    The quota slots of every (source, destination) buffer are split into
    ``num_chunks`` chunks; chunk k's rows land at their final position
    ``src_offset[s] + q`` straight away, so the output is bit-identical to
    the monolithic shuffle's live rows (the tail is zero padding). On one
    card the chunks do not overlap a transfer; the contract is kept for the
    callers and the planner.
    """
    P = table.nworkers
    dev = table.device
    K = max(min(int(num_chunks), quota), 1)
    cq = -(-quota // K)  # per-chunk quota (ceil)
    bufs = build_shuffle_buffers(table, dest, P, quota)
    cap_out = (P * quota) if capacity is None else capacity

    recv_counts = bufs.counts.transpose(0, 1)  # [dst, src]
    src_offset = torch.cumsum(recv_counts, dim=1, dtype=torch.int32) - recv_counts

    out_cols = {k: torch.zeros((P, cap_out + 1), dtype=v.dtype, device=dev)
                for k, v in bufs.columns.items()}
    for k in range(K):
        lo, hi = k * cq, min((k + 1) * cq, quota)
        if lo >= hi:
            break
        q = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        valid = q[None, None, :] < recv_counts[:, :, None]  # (dst, src, chunk)
        pos = src_offset[:, :, None] + q[None, None, :]
        pos = torch.where(valid & (pos < cap_out), pos, cap_out)
        pos = pos.reshape(P, -1).to(torch.int64)
        for name, v in bufs.columns.items():
            chunk = v[:, :, lo:hi].transpose(0, 1).reshape(P, -1)
            out_cols[name].scatter_(1, pos, chunk)
    out = {k: v[:, :cap_out] for k, v in out_cols.items()}
    nvalid = torch.clamp(recv_counts.sum(dim=1, dtype=torch.int32), max=cap_out)
    return Table(out, nvalid), bufs.overflow


def allgather_table(table: Table, capacity: int | None = None) -> Table:
    """Every worker ends with all live rows, in worker order."""
    P, cap = table.nworkers, table.capacity
    cols = {k: v.reshape(1, P * cap).expand(P, P * cap) for k, v in table.columns.items()}
    keep = (torch.arange(cap, dtype=torch.int32, device=table.device)[None, :]
            < table.nvalid[:, None]).reshape(1, P * cap).expand(P, P * cap)
    full = torch.full((P,), P * cap, dtype=torch.int32, device=table.device)
    return compact(Table(cols, full), keep, capacity=capacity)
