"""Table collectives over the P workers (paper §3, Table 1).

The reference runs each collective inside ``shard_map`` over a mesh of P
devices. Here the workers a process holds are the leading dimension of
every tensor: all P on one card, or a rank's block of a process group
(``group.WorkerBlock``). Every cross-worker step goes through the block's
three exchanges. The all-to-all of the ``(local_src, P_dst, quota)``
shuffle buffers is ``exchange``, which on one card is ``transpose(0, 1)``:
worker ``d`` receives slab ``[s, d]`` from every source ``s``. Received
rows are compacted source-major and stable within each source, the
reference's order exactly.

Array collectives take and return ``(local, ...)`` tensors, one slice per
worker held: a reduction gathers every worker's slice and reduces them
with one card's code, so every worker gets the same result, as the
reference's replicated ``psum`` does, and a group gives one card's bits by
construction. Integer sums wrap in the input's dtype (jax sums int32 in
int32; torch would widen to int64).
"""

from __future__ import annotations

import torch

from ...obs import trace as _trace
from ..dataframe import Table, compact, narrow_u32, put_rows, take_rows, wide
from ..partition import build_shuffle_buffers
from .group import WorkerBlock, block_of

__all__ = [
    "shuffle_table",
    "shuffle_table_pipelined",
    "allgather_table",
    "gather_table",
    "broadcast_table",
    "scatter_table",
    "allreduce_array",
    "reduce_scatter_array",
    "allgather_array",
    "barrier",
]


# -- array collectives ------------------------------------------------------------

def allreduce_array(x: torch.Tensor, op: str = "sum",
                    workers: WorkerBlock | None = None) -> torch.Tensor:
    """AllReduce over the workers (paper Table 1): sum | max | min of the
    (P, ...) slices, the same result on every worker."""
    local = x.shape[0]
    x = block_of(workers, x).gather_workers(x)
    if op == "sum":
        r = x.sum(dim=0, dtype=x.dtype)
    elif x.shape[0] == 1 and op in ("max", "min"):
        r = x[0]  # one worker's value as it is (a reduction would remake its NaN)
    elif op in ("max", "min"):
        r = wide(x).amax(dim=0) if op == "max" else wide(x).amin(dim=0)
        r = narrow_u32(r) if x.dtype == torch.uint32 else r
    else:
        raise ValueError(f"unknown reduce op {op}")
    return r.unsqueeze(0).expand((local,) + tuple(r.shape))


def reduce_scatter_array(x: torch.Tensor, workers: WorkerBlock | None = None) -> torch.Tensor:
    """Sum over the workers, then worker i keeps tile i: (P, n, ...) ->
    (P, n / P, ...)."""
    block = block_of(workers, x)
    x = block.gather_workers(x)
    P, n = x.shape[0], x.shape[1]
    if n % P:
        raise ValueError(f"reduce_scatter: {n} rows do not split over {P} workers")
    tiles = x.sum(dim=0, dtype=x.dtype).reshape((P, n // P) + tuple(x.shape[2:]))
    return tiles[block.lo: block.hi]


def allgather_array(x: torch.Tensor, tiled: bool = False,
                    workers: WorkerBlock | None = None) -> torch.Tensor:
    """Every worker receives all slices: (P, n, ...) -> (P, P, n, ...), or
    with ``tiled`` concatenated along the first axis, (P, P * n, ...)."""
    local = x.shape[0]
    x = block_of(workers, x).gather_workers(x)
    g = x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:])) if tiled else x
    return g.unsqueeze(0).expand((local,) + tuple(g.shape))


def barrier(workers: WorkerBlock | None = None) -> None:
    """Explicit barrier (paper Table 1). The P workers of one card run as
    one program in stream order, so every operation is already a BSP
    superstep boundary: nothing to wait for. A group's ranks wait for each
    other."""
    if workers is not None:
        workers.barrier()


# -- table collectives ----------------------------------------------------------

def _bruck_all_to_all(columns: dict, counts: torch.Tensor, workers: WorkerBlock):
    """Bruck all-to-all (Bruck et al. 1997; paper Table 3) over the
    (local_src, P_dst, quota) buffers, as the reference's ppermute rounds:
    the blocks are rotated to relative order (slot j = the block for rank +
    j), round k moves every slot with bit k set to rank + 2^k, and a final
    inverse rotation restores source order. Returns ([dst, src] columns,
    [dst, src] counts), equal to the native exchange's."""
    P = workers.nworkers
    dev = counts.device
    ar = torch.arange(P, device=dev)
    me = torch.arange(workers.lo, workers.hi, device=dev)  # the global ranks held here
    rot = (ar[None, :] + me[:, None]) % P  # [rank, slot] -> destination

    def gather(v, idx):
        return take_rows(v, idx)

    cols = {k: gather(v, rot) for k, v in columns.items()}
    cnts = gather(counts, rot)
    for k in range(max((P - 1).bit_length(), 1)):
        bit = 1 << k
        slots = [j for j in range(P) if j & bit]  # the same slot set on every rank
        if not slots:
            continue
        for v in list(cols.values()) + [cnts]:
            v[:, slots] = workers.permute_workers(v[:, slots], bit)  # rank i -> i + bit
    inv = (me[:, None] - ar[None, :]) % P  # out[rank, s] = slot (rank - s)
    return {k: gather(v, inv) for k, v in cols.items()}, gather(cnts, inv)


def shuffle_table(table: Table, dest: torch.Tensor, quota: int,
                  capacity: int | None = None,
                  algorithm: str = "native",
                  workers: WorkerBlock | None = None) -> tuple[Table, torch.Tensor]:
    """All-to-all shuffle of live rows to their ``dest`` workers.

    Args:
      table: the partitions of the workers held here.
      dest: (local, capacity) int32 destination per row; invalid rows
        carry P.
      quota: slots per (source, destination) pair.
      capacity: output capacity per worker (default ``P * quota``).
      algorithm: "native" (one all-to-all) or "bruck" (log2 P rounds of
        neighbour moves, paper §6.1.1); both give the same rows.
      workers: the block of workers held here (default: all of one card).

    Returns:
      (received table, (local,) int32 overflow per source worker).

    While tracing is on, the ``shuffle`` span holds ``slots`` (the L x P x
    quota slots sent and compacted) and ``rows`` (the live rows sent, a
    0-dim tensor on the table's device, read only after the run). The
    recorder keeps that tensor, and its device memory, until it is reset.
    """
    workers = block_of(workers, table.nvalid)
    P, L = workers.nworkers, table.nworkers
    with _trace.span("shuffle") as sp:
        bufs = build_shuffle_buffers(table, dest, P, quota)
        if _trace.enabled():
            sp.set(slots=L * P * quota, rows=bufs.counts.sum())
        if algorithm == "bruck":
            recv_cols, recv_counts = _bruck_all_to_all(bufs.columns, bufs.counts, workers)
        elif algorithm == "native":
            # each buffer is dropped once sent: over a group what arrives is
            # new memory, and keeping every sent buffer would double the
            # shuffle's peak
            send, recv_cols = bufs.columns, {}
            bufs.clear()
            for k in list(send):
                recv_cols[k] = workers.exchange(send.pop(k))
            recv_counts = workers.exchange(bufs.counts)  # [dst, src]
        else:
            raise ValueError(f"unknown all-to-all algorithm {algorithm!r}")
        keep = (torch.arange(quota, dtype=torch.int32, device=table.device)[None, None, :]
                < recv_counts[:, :, None]).reshape(L, P * quota)
        cols = {k: v.reshape((L, P * quota) + tuple(v.shape[3:]))
                for k, v in recv_cols.items()}
        full = torch.full((L,), P * quota, dtype=torch.int32, device=table.device)
        out = compact(Table(cols, full), keep, capacity=capacity)
        return out, bufs.overflow


def shuffle_table_pipelined(table: Table, dest: torch.Tensor, quota: int,
                            num_chunks: int,
                            capacity: int | None = None,
                            workers: WorkerBlock | None = None
                            ) -> tuple[Table, torch.Tensor]:
    """K-chunk shuffle with the contract of :func:`shuffle_table`.

    The quota slots of every (source, destination) buffer are split into
    ``num_chunks`` chunks; chunk k's rows land at their final position
    ``src_offset[s] + q`` straight away, so the output is bit-identical to
    the monolithic shuffle's live rows (the tail is zero padding). The
    chunks do not overlap a transfer; the contract is kept for the callers
    and the planner.
    """
    workers = block_of(workers, table.nvalid)
    P, L = workers.nworkers, table.nworkers
    dev = table.device
    K = max(min(int(num_chunks), quota), 1)
    cq = -(-quota // K)  # per-chunk quota (ceil)
    cap_out = (P * quota) if capacity is None else capacity
    with _trace.span("shuffle") as sp:
        bufs = build_shuffle_buffers(table, dest, P, quota)
        if _trace.enabled():
            sp.set(slots=L * P * quota, rows=bufs.counts.sum())
        recv_counts = workers.exchange(bufs.counts)  # [dst, src]
        src_offset = torch.cumsum(recv_counts, dim=1, dtype=torch.int32) - recv_counts

        out_cols = {k: torch.zeros((L, cap_out + 1) + tuple(v.shape[3:]), dtype=v.dtype,
                                   device=dev)
                    for k, v in bufs.columns.items()}
        for k in range(K):
            lo, hi = k * cq, min((k + 1) * cq, quota)
            if lo >= hi:
                break
            q = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            valid = q[None, None, :] < recv_counts[:, :, None]  # (dst, src, chunk)
            pos = src_offset[:, :, None] + q[None, None, :]
            pos = torch.where(valid & (pos < cap_out), pos, cap_out)
            pos = pos.reshape(L, -1).to(torch.int64)
            for name, v in bufs.columns.items():
                chunk = workers.exchange(v[:, :, lo:hi])
                put_rows(out_cols[name], pos, chunk.reshape((L, -1) + tuple(v.shape[3:])))
        out = {k: v[:, :cap_out] for k, v in out_cols.items()}
        nvalid = torch.clamp(recv_counts.sum(dim=1, dtype=torch.int32), max=cap_out)
        return Table(out, nvalid), bufs.overflow


def allgather_table(table: Table, capacity: int | None = None,
                    workers: WorkerBlock | None = None) -> Table:
    """Every worker ends with all live rows, in worker order."""
    workers = block_of(workers, table.nvalid)
    P, L, cap = workers.nworkers, table.nworkers, table.capacity
    cols = {k: workers.gather_workers(v).reshape((1, P * cap) + tuple(v.shape[2:]))
            .expand((L, P * cap) + tuple(v.shape[2:]))
            for k, v in table.columns.items()}
    keep = (torch.arange(cap, dtype=torch.int32, device=table.device)[None, :]
            < workers.gather_workers(table.nvalid)[:, None]).reshape(1, P * cap).expand(L, P * cap)
    full = torch.full((L,), P * cap, dtype=torch.int32, device=table.device)
    return compact(Table(cols, full), keep, capacity=capacity)


def gather_table(table: Table, root: int = 0, capacity: int | None = None,
                 workers: WorkerBlock | None = None) -> Table:
    """Gather to ``root``; the other workers receive an empty table."""
    workers = block_of(workers, table.nvalid)
    out = allgather_table(table, capacity, workers=workers)
    return Table(out.columns, torch.where(workers.local_ids() == root, out.nvalid, 0))


def broadcast_table(table: Table, root: int = 0,
                    workers: WorkerBlock | None = None) -> Table:
    """Every worker receives ``root``'s partition (paper Table 1). The
    reference sums the root's values with zeros from every other worker;
    so does this for floats, which turns a -0.0 into +0.0 when P > 1."""
    workers = block_of(workers, table.nvalid)
    P, L = workers.nworkers, table.nworkers
    cols = {}
    for k, v in table.columns.items():
        r = workers.gather_workers(v)[root]
        if P > 1 and v.is_floating_point():
            r = r + 0.0
        cols[k] = r.unsqueeze(0).expand((L,) + tuple(r.shape)).contiguous()
    return Table(cols, workers.gather_workers(table.nvalid)[root].expand(L).contiguous())


def scatter_table(table: Table, root: int = 0, quota: int | None = None,
                  workers: WorkerBlock | None = None) -> tuple[Table, torch.Tensor]:
    """Deal ``root``'s live rows round-robin over the workers (partitioned
    I/O); the other workers contribute nothing."""
    workers = block_of(workers, table.nvalid)
    P = workers.nworkers
    quota = quota if quota is not None else -(-table.capacity // P)
    n = torch.where(workers.local_ids() == root, table.nvalid, 0)
    idx = torch.arange(table.capacity, dtype=torch.int32, device=table.device)[None, :]
    dest = torch.where(idx < n[:, None], idx % P, P)
    return shuffle_table(Table(table.columns, n), dest, quota, workers=workers)
