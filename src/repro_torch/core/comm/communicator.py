"""The Communicator over the P workers of a DDF (paper §3.1, Fig. 4).

The reference annotates its ``jax.lax`` collectives with per-fabric Hockney
profiles (alpha, beta) for TPU interconnects. Those are TPU figures and are
not carried over. On one card the shuffle is an on-card transpose, whose
cost is described by the single ``DEVICE`` profile below. Over a process
group (``core.comm.group``) each rank holds a block of the workers and the
same collectives run through NCCL or gloo; every rank still plans with the
``DEVICE`` profile, so all of them take the same decisions. A profile of
the cross-card fabric waits for a run on more than one card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..dataframe import Table
from . import channels, collectives
from .group import WorkerBlock

__all__ = ["FabricProfile", "DEVICE", "Communicator", "make_communicator"]


@dataclasses.dataclass(frozen=True)
class FabricProfile:
    """Hockney (alpha, beta) + name, feeding the cost model."""

    name: str
    alpha_s: float          # startup latency per message [s]
    beta_s_per_byte: float  # transfer time per byte [s/B]

    def t_msg(self, nbytes: float) -> float:
        return self.alpha_s + nbytes * self.beta_s_per_byte


# The all-to-all on one card is a transpose of the (P_src, P_dst, quota)
# buffers. Fitted by chip_smoke.py (transposes of (8, 8, 4096) and
# (8, 8, 1048576) int32, eager PyTorch, so alpha includes the host dispatch)
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
DEVICE = FabricProfile("device", alpha_s=2.279e-05, beta_s_per_byte=7.452e-13)


@dataclasses.dataclass(frozen=True)
class Communicator:
    """The P workers with their fabric profile: all of them on one device
    (``group=None``), or this rank's block of a process group. Methods
    mirror paper Table 1; arrays are (local, ...) tensors, one slice per
    worker this process holds (all P on one card)."""

    nworkers: int
    fabric: FabricProfile = DEVICE
    device: torch.device | None = None
    group: object = None
    workers: WorkerBlock = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "workers", WorkerBlock(self.nworkers, self.device, self.group))

    # -- metadata
    def size(self) -> int:
        """The global worker count P."""
        return self.nworkers

    def rank(self) -> torch.Tensor:
        """(local,) int32: the global rank of each worker held here."""
        return self.workers.local_ids()

    # -- table routines (paper Table 1 "Common" column)
    def shuffle(self, table: Table, dest, quota: int, capacity: int | None = None,
                algorithm: str = "native", num_chunks: int = 1):
        """Shuffle live rows to ``dest`` workers. ``num_chunks > 1`` uses the
        chunked engine (bit-exact with the monolithic one); ``algorithm``
        picks the monolithic all-to-all ("native" or "bruck") and, as in the
        reference, is refused with chunking rather than ignored."""
        if num_chunks > 1:
            if algorithm != "native":
                raise ValueError(
                    f"algorithm={algorithm!r} is only available for the monolithic "
                    "shuffle (num_chunks=1); the chunked engine is native only")
            return collectives.shuffle_table_pipelined(table, dest, quota,
                                                       num_chunks, capacity,
                                                       workers=self.workers)
        return collectives.shuffle_table(table, dest, quota, capacity, algorithm=algorithm,
                                         workers=self.workers)

    def allgather(self, table: Table, capacity: int | None = None) -> Table:
        return collectives.allgather_table(table, capacity, workers=self.workers)

    def gather(self, table: Table, root: int = 0, capacity: int | None = None) -> Table:
        return collectives.gather_table(table, root, capacity, workers=self.workers)

    def broadcast(self, table: Table, root: int = 0) -> Table:
        return collectives.broadcast_table(table, root, workers=self.workers)

    def scatter(self, table: Table, root: int = 0, quota: int | None = None):
        return collectives.scatter_table(table, root, quota, workers=self.workers)

    # -- array / scalar routines
    def allreduce(self, x, op: str = "sum"):
        return collectives.allreduce_array(x, op, workers=self.workers)

    def reduce_scatter(self, x):
        return collectives.reduce_scatter_array(x, workers=self.workers)

    def allgather_array(self, x, tiled: bool = False):
        return collectives.allgather_array(x, tiled, workers=self.workers)

    # -- channels (p2p)
    def shift(self, x, offset: int = 1):
        return channels.shift(x, offset, workers=self.workers)

    def halo_exchange(self, tail, head):
        return channels.halo_exchange(tail, head, workers=self.workers)

    def barrier(self):
        collectives.barrier(self.workers)


def make_communicator(nworkers: int, device=None, group=None) -> Communicator:
    """Communicator over ``nworkers`` workers: all of them on one device, or
    with ``group`` (a ``torch.distributed`` process group) this rank's
    block of them (``device`` places :meth:`Communicator.rank`)."""
    return Communicator(nworkers=nworkers, fabric=DEVICE, device=device, group=group)
