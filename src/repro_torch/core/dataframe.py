"""Row partitions of a distributed dataframe, batched over workers.

The reference keeps one fixed-capacity partition per device. Here all P
workers live on one card, so a ``Table`` holds every worker's partition at
once: each column has shape ``(P, capacity)`` and ``nvalid`` has shape
``(P,)``. Rows ``[0, nvalid[w])`` of worker ``w`` are live, the rest is
padding. Every helper below works on all workers in one batched call.

Dtypes follow the reference with jax's 64-bit mode off: int64 columns
become int32 (wrapping), uint64 become uint32 and float64 become float32
(:func:`canonical_dtype`). Counters (``nvalid``, destinations, overflow)
are int32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

__all__ = [
    "Table",
    "canonical_dtype",
    "canonical_numpy",
    "torch_dtype",
    "concat",
    "compact",
    "head",
    "valid_mask",
    "max_sentinel",
    "min_sentinel",
    "from_numpy",
    "to_numpy",
    "resize_rows",
]

_CANONICAL = {np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.float64): np.dtype(np.float32)}

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
}


def canonical_dtype(dtype) -> np.dtype:
    """The dtype jax gives ``dtype`` with x64 off: 64-bit types narrow to
    their 32-bit counterparts, everything else is kept."""
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


def canonical_numpy(v) -> np.ndarray:
    """``v`` as a numpy array of its canonical dtype (int64 wraps to int32,
    as ``jnp.asarray`` does with x64 off)."""
    v = np.asarray(v)
    with np.errstate(over="ignore"):  # the wrap is the intended result
        return v.astype(canonical_dtype(v.dtype), copy=False)


def torch_dtype(dtype) -> torch.dtype:
    """Torch dtype of a canonical numpy dtype."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"unsupported column dtype {np.dtype(dtype)}") from None


def max_sentinel(dtype: torch.dtype):
    """Largest value of ``dtype`` (+inf for floats): the identity of
    ``min`` reductions, shared by the local operators and the
    segment-reduce kernel so that both fill masked rows alike."""
    if dtype.is_floating_point:
        return float("inf")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).max


def min_sentinel(dtype: torch.dtype):
    """Smallest value of ``dtype`` (-inf for floats): the identity of
    ``max`` reductions; see :func:`max_sentinel`."""
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


@dataclasses.dataclass
class Table:
    """The row partitions of all P workers.

    columns: name -> tensor of shape (P, capacity); all share P and capacity.
    nvalid:  (P,) int32 -- worker w's rows [0, nvalid[w]) are live.
    """

    columns: dict[str, torch.Tensor]
    nvalid: torch.Tensor

    @property
    def nworkers(self) -> int:
        return self.nvalid.shape[0]

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[1]

    @property
    def device(self) -> torch.device:
        return self.nvalid.device


def valid_mask(table: Table) -> torch.Tensor:
    """(P, capacity) bool -- True for live rows."""
    idx = torch.arange(table.capacity, dtype=torch.int32, device=table.device)
    return idx[None, :] < table.nvalid[:, None]


def resize_rows(v: torch.Tensor, cap_out: int) -> torch.Tensor:
    """First ``cap_out`` rows of each worker, zero-padded when longer."""
    cap = v.shape[1]
    if cap_out <= cap:
        return v[:, :cap_out]
    pad = torch.zeros((v.shape[0], cap_out - cap), dtype=v.dtype, device=v.device)
    return torch.cat([v, pad], dim=1)


def stable_partition_order(keep: torch.Tensor) -> torch.Tensor:
    """(P, n) int64 permutation that moves ``keep`` rows to the front, each
    group in its original order -- ``argsort(~keep, stable=True)`` computed
    in O(n) from two prefix sums."""
    k = keep.to(torch.int32)
    nkeep = k.sum(dim=1, dtype=torch.int32)
    pos_keep = torch.cumsum(k, dim=1, dtype=torch.int32) - 1
    pos_drop = nkeep[:, None] + torch.cumsum(1 - k, dim=1, dtype=torch.int32) - 1
    pos = torch.where(keep, pos_keep, pos_drop).to(torch.int64)
    n = keep.shape[1]
    rows = torch.arange(n, dtype=torch.int64, device=keep.device).expand_as(pos)
    return torch.empty_like(pos).scatter_(1, pos, rows)


def _gather_rows(cols: Mapping[str, torch.Tensor], order: torch.Tensor):
    return {k: torch.take_along_dim(v, order, dim=1) for k, v in cols.items()}


def compact(table: Table, keep: torch.Tensor, capacity: int | None = None) -> Table:
    """Stable-move rows with ``keep & valid`` to the front of each worker;
    new nvalid = their count, clipped to the output capacity."""
    keep = keep & valid_mask(table)
    cap_out = table.capacity if capacity is None else capacity
    order = stable_partition_order(keep)
    cols = _gather_rows(table.columns, order[:, :cap_out])
    if cap_out > table.capacity:
        cols = {k: resize_rows(v, cap_out) for k, v in cols.items()}
    n = torch.clamp(keep.sum(dim=1, dtype=torch.int32), max=cap_out)
    return Table(cols, n)


def head(table: Table, n: int) -> Table:
    """First n rows of every worker's partition (capacity shrinks to n)."""
    cols = {k: v[:, :n] for k, v in table.columns.items()}
    return Table(cols, torch.clamp(table.nvalid, max=n))


def concat(a: Table, b: Table, capacity: int | None = None) -> Table:
    """Per worker, the live rows of ``a`` then of ``b`` (same schema),
    compacted. Output capacity defaults to cap_a + cap_b."""
    if set(a.columns) != set(b.columns):
        raise ValueError("schema mismatch in concat")
    cap_out = (a.capacity + b.capacity) if capacity is None else capacity
    cols = {k: torch.cat([a.columns[k], b.columns[k]], dim=1) for k in a.columns}
    keep = torch.cat([valid_mask(a), valid_mask(b)], dim=1)
    order = stable_partition_order(keep)[:, :cap_out]
    cols = _gather_rows(cols, order)
    if cap_out > a.capacity + b.capacity:
        cols = {k: resize_rows(v, cap_out) for k, v in cols.items()}
    n = torch.clamp(keep.sum(dim=1, dtype=torch.int32), max=cap_out)
    return Table(cols, n)


# -- host-side helpers (tests / examples) -------------------------------------

def from_numpy(data: Mapping[str, np.ndarray], nworkers: int = 1,
               capacity: int | None = None, device="cpu") -> Table:
    """Split rows contiguously over ``nworkers`` partitions of ``capacity``
    rows (default ceil(n / nworkers)), as ``DDF.from_numpy`` does."""
    n = len(next(iter(data.values())))
    per = -(-n // nworkers) if n else 0
    cap = max(per, 1) if capacity is None else capacity
    cols = {}
    for k, v in data.items():
        v = canonical_numpy(v)
        if v.ndim != 1:
            raise ValueError(f"column {k!r}: only 1-D columns are supported")
        buf = np.zeros((nworkers, cap), v.dtype)
        for w in range(nworkers):
            chunk = v[w * per: (w + 1) * per][:cap]
            buf[w, : len(chunk)] = chunk
        cols[k] = torch.from_numpy(buf).to(device)
    counts = np.minimum(np.maximum(n - per * np.arange(nworkers), 0),
                        min(per, cap)).astype(np.int32)
    return Table(cols, torch.from_numpy(counts).to(device))


def to_numpy(table: Table) -> dict[str, np.ndarray]:
    """Live rows of all workers in worker order, as numpy (host)."""
    counts = table.nvalid.cpu().numpy()
    out = {}
    for k, v in table.columns.items():
        v = v.cpu().numpy()
        out[k] = np.concatenate([v[w, : counts[w]] for w in range(len(counts))])
    return out
