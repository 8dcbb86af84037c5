"""User-facing distributed dataframe API (paper §2.1, Fig. 2b).

``DDF`` is the virtual collection of row partitions. In the reference its
columns are sharded over a mesh of P devices; here all P partitions live on
one card as ``(P, capacity)`` tensors with per-worker live counts ``(P,)``,
and every method runs eagerly, so no compiled-operator cache is needed.
Planning (quota / capacity / strategy) is host-side via ``patterns``.

Auxiliary outputs (overflow counters) come back as (P,) int32 tensors, one
entry per worker, as the reference's leading per-worker axis.

Not ported yet (ROADMAP queue A): the lazy plan layer, expressions,
dict-encoded string columns (``vocab``), and the DDF methods other than
``join``, ``groupby`` and ``unique``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from . import operators, patterns
from .comm.communicator import Communicator, make_communicator
from .dataframe import Table, canonical_numpy, from_numpy, to_numpy, torch_dtype
from .partition import default_quota

__all__ = ["DDFContext", "DDF"]


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DDFContext: no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class DDFContext:
    """Execution environment: P workers on one device (the card unless the
    caller asks for the CPU)."""

    nworkers: int = 1
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.nworkers < 1:
            raise ValueError(f"nworkers must be >= 1, got {self.nworkers}")
        object.__setattr__(self, "device", _resolve_device(self.device))

    def comm(self) -> Communicator:
        return make_communicator(self.nworkers)


def _check_column(name: str, v: np.ndarray) -> np.ndarray:
    if v.dtype.kind in ("U", "S", "O"):
        raise TypeError(
            f"column {name!r}: string columns are not ported yet "
            "(dict-encoded strings, core/vocab.py, ROADMAP queue A)")
    v = canonical_numpy(v)
    if v.dtype == np.uint32:
        raise TypeError(f"column {name!r}: uint32 columns are not ported yet "
                        "(ROADMAP queue A)")
    torch_dtype(v.dtype)  # raises on dtypes the port has no tensor type for
    return v


@dataclasses.dataclass
class DDF:
    """Distributed dataframe: columns (P, capacity) + counts (P,) int32."""

    columns: dict[str, torch.Tensor]
    counts: torch.Tensor
    ctx: DDFContext
    _nrows: int | None = dataclasses.field(default=None, repr=False, compare=False)

    # -- metadata --------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[1]

    def table(self) -> Table:
        """The partitions as a batched :class:`Table`."""
        return Table(self.columns, self.counts)

    def num_rows(self) -> int:
        """Global live-row count (a device->host sync; cached)."""
        if self._nrows is None:
            self._nrows = int(self.counts.sum().item())
        return self._nrows

    # -- construction ------------------------------------------------------------
    @classmethod
    def from_numpy(cls, data: Mapping[str, np.ndarray], ctx: DDFContext,
                   capacity: int | None = None) -> "DDF":
        """Partitioned input: rows split contiguously across workers
        (paper §5.3.8), ceil(n / P) per worker unless ``capacity`` is given."""
        checked = {k: _check_column(k, np.asarray(v)) for k, v in data.items()}
        t = from_numpy(checked, ctx.nworkers, capacity, ctx.device)
        return cls(t.columns, t.nvalid, ctx)

    @classmethod
    def from_partitions(cls, columns: Mapping[str, np.ndarray], counts: np.ndarray,
                        ctx: DDFContext) -> "DDF":
        """The partition layout of a reference DDF: its padded global columns
        (P * capacity,) and per-worker counts (P,), as
        ``np.asarray(ddf.columns[k])`` and ``np.asarray(ddf.counts)`` give
        them."""
        nw = ctx.nworkers
        counts = np.asarray(counts).astype(np.int32)
        if counts.shape != (nw,):
            raise ValueError(f"counts must have shape ({nw},), got {counts.shape}")
        cols = {}
        for k, v in columns.items():
            v = _check_column(k, np.asarray(v))
            if v.ndim != 1 or v.shape[0] % nw:
                raise ValueError(f"column {k!r}: expected (P * capacity,), got {v.shape}")
            cols[k] = torch.from_numpy(np.array(v.reshape(nw, -1))).to(ctx.device)
        return cls(cols, torch.from_numpy(counts).to(ctx.device), ctx)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Live rows to host, in partition order."""
        return to_numpy(self.table())

    def partitions(self) -> list[dict[str, np.ndarray]]:
        """Per worker, its live rows as numpy (host)."""
        counts = self.counts.cpu().numpy()
        host = {k: v.cpu().numpy() for k, v in self.columns.items()}
        return [{k: v[w, : counts[w]] for k, v in host.items()}
                for w in range(self.ctx.nworkers)]

    def _wrap(self, table: Table, info: dict):
        return DDF(dict(table.columns), table.nvalid, self.ctx), info

    def _check_columns(self, names: Sequence[str], op: str) -> None:
        missing = [n for n in names if n not in self.columns]
        if missing:
            raise KeyError(f"{op}: unknown column(s) {missing}; "
                           f"available schema: {sorted(self.columns)}")

    # -- loosely synchronous ----------------------------------------------------
    def join(self, other: "DDF", on: Sequence[str], strategy: str = "auto",
             quota: int | None = None, capacity: int | None = None,
             num_chunks: int = 1):
        """Equi-join. ``strategy="auto"`` lets the planner pick hash-shuffle
        vs broadcast; ``num_chunks > 1`` runs the chunked shuffle
        (1 = monolithic all-to-all).

        Returns (joined DDF, {"overflow_*": (P,) int32})."""
        on = tuple(on)
        self._check_columns(on, "join")
        other._check_columns(on, "join")
        nw = self.ctx.nworkers
        if strategy == "auto":
            plan = patterns.plan_join(
                self.num_rows(), other.num_rows(), nw, self.capacity)
            strategy = plan.strategy
        quota = quota or default_quota(self.capacity, nw)
        capacity = capacity or 2 * self.capacity
        comm = self.ctx.comm()
        if strategy == "broadcast":
            gather = "left" if self.num_rows() <= other.num_rows() else "right"
            out, info = operators.dist_join_broadcast(
                comm, self.table(), other.table(), on, capacity, gather=gather)
        elif strategy == "shuffle":
            out, info = operators.dist_join_shuffle(
                comm, self.table(), other.table(), on, quota, capacity,
                num_chunks=num_chunks)
        else:
            raise ValueError(f"unknown join strategy {strategy!r}")
        return self._wrap(out, info)

    def groupby(self, by: Sequence[str], aggs: Mapping[str, Sequence[str]],
                pre_combine: bool | None = None, cardinality_hint: float | None = None,
                quota: int | None = None, capacity: int | None = None,
                num_chunks: int = 1):
        """GroupBy-aggregate with the canonical mapping
        ``{value_col: (op, ...)}``. With ``pre_combine=None`` the planner
        picks combine-shuffle-reduce vs plain shuffle (from
        ``cardinality_hint``); ``num_chunks > 1`` runs the chunked
        shuffle.

        Returns (aggregated DDF, {"overflow_shuffle", "overflow_agg"})."""
        if not isinstance(aggs, Mapping):
            raise TypeError("groupby: aggregation expressions are not ported yet "
                            "(expr, ROADMAP queue A); pass {col: (ops,)}")
        by = tuple(by)
        aggs = {k: tuple(v) for k, v in aggs.items()}
        self._check_columns(by, "groupby(by)")
        self._check_columns(sorted(aggs), "groupby(aggs)")
        nw = self.ctx.nworkers
        if pre_combine is None:
            card = cardinality_hint if cardinality_hint is not None else 0.0
            plan = patterns.plan_groupby(card, nw, capacity or self.capacity)
            pre_combine = plan.strategy == "combine_shuffle_reduce"
        quota = quota or default_quota(self.capacity, nw)
        capacity = capacity or self.capacity
        out, info = operators.dist_groupby(
            self.ctx.comm(), self.table(), by, aggs, quota, capacity, pre_combine,
            num_chunks=num_chunks)
        return self._wrap(out, info)

    def unique(self, subset: Sequence[str], quota: int | None = None,
               capacity: int | None = None, num_chunks: int = 1):
        """Distinct rows by ``subset`` key columns (combine-shuffle-reduce).

        Returns (DDF, {"overflow_shuffle", "overflow_agg"})."""
        subset = tuple(subset)
        self._check_columns(subset, "unique")
        nw = self.ctx.nworkers
        quota = quota or default_quota(self.capacity, nw)
        capacity = capacity or self.capacity
        out, info = operators.dist_unique(
            self.ctx.comm(), self.table(), subset, quota, capacity,
            num_chunks=num_chunks)
        return self._wrap(out, info)
