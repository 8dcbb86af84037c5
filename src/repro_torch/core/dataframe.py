"""Row partitions of a distributed dataframe, batched over workers.

The reference keeps one fixed-capacity partition per device. Here all P
workers live on one card, so a ``Table`` holds every worker's partition at
once: each column has shape ``(P, capacity, *tail)`` (``tail`` empty for
a plain column, the row's own shape for a vector column) and ``nvalid``
has shape ``(P,)``. Rows ``[0, nvalid[w])`` of worker ``w`` are live, the
rest is padding. Every helper below works on all workers in one batched
call.

Dtypes follow the reference with jax's 64-bit mode off: int64 columns
become int32 (wrapping), uint64 become uint32 and float64 become float32
(:func:`canonical_dtype`). Counters (``nvalid``, destinations, overflow)
are int32. A uint32 column keeps its 4 bytes a row: torch moves and
selects its rows only as int32 bits (:func:`take_rows`, :func:`put_rows`,
:func:`where_rows`, :func:`cat_rows`; on the card torch has no uint32
gather, scatter, ``where`` or ``cat``), and orders and computes on it in
int64 (:func:`wide`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..obs import trace as _trace

__all__ = [
    "Table",
    "canonical_dtype",
    "canonical_numpy",
    "torch_dtype",
    "concat",
    "compact",
    "head",
    "gather_rows",
    "map_rows",
    "valid_mask",
    "max_sentinel",
    "min_sentinel",
    "from_numpy",
    "from_arrays",
    "empty",
    "to_numpy",
    "resize_rows",
    "take_rows",
    "put_rows",
    "where_rows",
    "cat_rows",
    "wide",
    "narrow_u32",
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


MASK32 = 0xFFFFFFFF


def wide(v: torch.Tensor) -> torch.Tensor:
    """A uint32 tensor's values as int64 (torch has no uint32 ordering or
    arithmetic on the CPU); any other tensor as it is."""
    if v.dtype == torch.uint32:
        return v.view(torch.int32).to(torch.int64) & MASK32
    return v


def narrow_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values -> uint32, modulo 2**32 (the wrap of uint32 arithmetic)."""
    v = v & MASK32
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32).view(torch.uint32)


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.view(torch.int32) if v.dtype == torch.uint32 else v


def take_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (P, k) int64 of every worker of a ``(P, n, *tail)``
    column -> ``(P, k, *tail)``, in any dtype (uint32 moves as int32
    bits)."""
    b = _bits(v)
    if b.dim() > 2:
        flat = b.reshape(b.shape[0], b.shape[1], -1)
        out = torch.take_along_dim(flat, idx[:, :, None].expand(-1, -1, flat.shape[2]), dim=1)
        out = out.reshape(tuple(idx.shape) + tuple(b.shape[2:]))
    else:
        out = torch.take_along_dim(b, idx, dim=1)
    return out.view(v.dtype)


def put_rows(buf: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``buf[w, idx[w, i]] = src[w, i]`` for ``(P, n, *tail)`` columns, in
    place, in any dtype; returns ``buf``."""
    b, s = _bits(buf), _bits(src)
    if b.dim() > 2:
        b = b.view(b.shape[0], b.shape[1], -1)
        s = s.reshape(s.shape[0], s.shape[1], -1)
        b.scatter_(1, idx[:, :, None].expand(-1, -1, b.shape[2]), s)
    else:
        b.scatter_(1, idx, s)
    return buf


def where_rows(cond: torch.Tensor, v: torch.Tensor, fill) -> torch.Tensor:
    """``torch.where(cond, v, fill)`` for a column ``v`` of any dtype and a
    Python scalar or tensor ``fill`` (uint32 selects among int32 bits)."""
    if v.dtype != torch.uint32:
        return torch.where(cond, v, fill)
    if isinstance(fill, torch.Tensor):
        fill = fill.view(torch.int32)
    else:
        fill = int(fill) - (1 << 32) if int(fill) > 0x7FFFFFFF else int(fill)
    return torch.where(cond, v.view(torch.int32), fill).view(torch.uint32)


def cat_rows(tensors, dim: int = 1) -> torch.Tensor:
    """``torch.cat`` of columns of one dtype, uint32 as int32 bits."""
    dtype = tensors[0].dtype
    return torch.cat([_bits(t) for t in tensors], dim=dim).view(dtype)


@dataclasses.dataclass
class Table:
    """The row partitions of all P workers.

    columns: name -> tensor of shape (P, capacity, *tail); all share P and
             capacity.
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

    def replace(self, **columns) -> "Table":
        """The same rows with ``columns`` added or overwritten."""
        return Table({**self.columns, **columns}, self.nvalid)


def valid_mask(table: Table) -> torch.Tensor:
    """(P, capacity) bool -- True for live rows."""
    idx = torch.arange(table.capacity, dtype=torch.int32, device=table.device)
    return idx[None, :] < table.nvalid[:, None]


def resize_rows(v: torch.Tensor, cap_out: int) -> torch.Tensor:
    """First ``cap_out`` rows of each worker, zero-padded when longer."""
    cap = v.shape[1]
    if cap_out <= cap:
        return v[:, :cap_out]
    pad = v.new_zeros((v.shape[0], cap_out - cap) + tuple(v.shape[2:]))
    return cat_rows([v, pad])


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
    return {k: take_rows(v, order) for k, v in cols.items()}


def compact(table: Table, keep: torch.Tensor, capacity: int | None = None) -> Table:
    """Stable-move rows with ``keep & valid`` to the front of each worker;
    new nvalid = their count, clipped to the output capacity."""
    with _trace.span("compact"):
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
    cols = {k: cat_rows([a.columns[k], b.columns[k]]) for k in a.columns}
    keep = torch.cat([valid_mask(a), valid_mask(b)], dim=1)
    order = stable_partition_order(keep)[:, :cap_out]
    cols = _gather_rows(cols, order)
    if cap_out > a.capacity + b.capacity:
        cols = {k: resize_rows(v, cap_out) for k, v in cols.items()}
    n = torch.clamp(keep.sum(dim=1, dtype=torch.int32), max=cap_out)
    return Table(cols, n)


def gather_rows(table: Table, idx: torch.Tensor, nvalid) -> Table:
    """Rows ``idx`` (P, k) of every worker, with ``nvalid`` live rows."""
    cols = _gather_rows(table.columns, idx.to(torch.int64))
    n = torch.as_tensor(nvalid, dtype=torch.int32, device=table.device)
    return Table(cols, n.expand(table.nworkers).contiguous() if n.dim() == 0 else n)


def map_rows(table: Table, fn: Callable[[dict], dict]) -> Table:
    """Embarrassingly-parallel map over the columns (paper §5.3.1)."""
    return Table(dict(fn(table.columns)), table.nvalid)


# -- host-side helpers (tests / examples) -------------------------------------

def from_numpy(data: Mapping[str, np.ndarray], nworkers: int = 1,
               capacity: int | None = None, device=None,
               workers: range | None = None) -> Table:
    """Split rows contiguously over ``nworkers`` partitions of ``capacity``
    rows (default ceil(n / nworkers)), as ``DDF.from_numpy`` does, on
    ``device`` (default: the card). ``data`` holds the global rows;
    ``workers`` (default: all) are the global ids of the partitions kept,
    a rank's block of a process group."""
    device = resolve_device(device)
    workers = range(nworkers) if workers is None else workers
    n = len(next(iter(data.values())))
    per = -(-n // nworkers) if n else 0
    cap = max(per, 1) if capacity is None else capacity
    cols = {}
    for k, v in data.items():
        v = canonical_numpy(v)
        buf = np.zeros((len(workers), cap) + v.shape[1:], v.dtype)
        for i, w in enumerate(workers):
            chunk = v[w * per: (w + 1) * per][:cap]
            buf[i, : len(chunk)] = chunk
        cols[k] = torch.from_numpy(buf).to(device)
    counts = np.minimum(np.maximum(n - per * np.asarray(workers), 0),
                        min(per, cap)).astype(np.int32)
    return Table(cols, torch.from_numpy(counts).to(device))


def from_arrays(columns: Mapping[str, object], nvalid=None, device=None) -> Table:
    """A Table of same-capacity ``(P, capacity, ...)`` arrays (numpy or
    tensors), on ``device`` (default: the card); ``nvalid`` (P,) defaults
    to the capacity. Columns that disagree on the capacity (or on P) raise
    ``ValueError``, as the reference's ``from_arrays`` does."""
    device = resolve_device(device)
    cols = {}
    for k, v in columns.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(canonical_numpy(v)))
        if t.dim() < 2:
            raise ValueError(f"column {k!r}: expected (P, capacity, ...), got {tuple(t.shape)}")
        cols[k] = t.to(device)
    shapes = {tuple(v.shape[:2]) for v in cols.values()}
    if len(shapes) != 1:
        raise ValueError(f"columns disagree on capacity: {shapes}")
    P, cap = shapes.pop()
    if nvalid is None:
        nvalid = cap
    n = torch.as_tensor(nvalid, dtype=torch.int32).to(device)
    return Table(cols, n.expand(P).contiguous() if n.dim() == 0 else n)


def empty(schema: Mapping[str, object], capacity: int, nworkers: int = 1,
          device=None) -> Table:
    """An all-padding Table (nvalid 0) of ``nworkers`` partitions of
    ``capacity`` rows, with ``schema``'s dtypes (numpy or torch), on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    cols = {k: torch.zeros((nworkers, capacity),
                           dtype=d if isinstance(d, torch.dtype)
                           else torch_dtype(canonical_dtype(d)), device=device)
            for k, d in schema.items()}
    return Table(cols, torch.zeros((nworkers,), dtype=torch.int32, device=device))


def to_numpy(table: Table) -> dict[str, np.ndarray]:
    """Live rows of all workers in worker order, as numpy (host)."""
    counts = table.nvalid.cpu().numpy()
    out = {}
    for k, v in table.columns.items():
        v = v.cpu().numpy()
        out[k] = np.concatenate([v[w, : counts[w]] for w in range(len(counts))])
    return out
