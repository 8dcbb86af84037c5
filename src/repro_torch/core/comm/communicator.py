"""The Communicator over the P workers of one card (paper §3.1, Fig. 4).

The reference annotates its ``jax.lax`` collectives with per-fabric Hockney
profiles (alpha, beta) for TPU interconnects. Those are TPU figures and are
not carried over. On one card the shuffle is an on-card transpose, whose
cost is described by the single ``DEVICE`` profile below.
"""

from __future__ import annotations

import dataclasses

import torch

from ..dataframe import Table
from . import channels, collectives

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
    """The P workers of one card with their fabric profile. Methods mirror
    paper Table 1; arrays are (P, ...) tensors, one slice per worker."""

    nworkers: int
    fabric: FabricProfile = DEVICE
    device: torch.device | None = None

    # -- metadata
    def size(self) -> int:
        return self.nworkers

    def rank(self) -> torch.Tensor:
        """(P,) int32: each worker's rank."""
        return torch.arange(self.nworkers, dtype=torch.int32, device=self.device)

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
                                                       num_chunks, capacity)
        return collectives.shuffle_table(table, dest, quota, capacity, algorithm=algorithm)

    def allgather(self, table: Table, capacity: int | None = None) -> Table:
        return collectives.allgather_table(table, capacity)

    def gather(self, table: Table, root: int = 0, capacity: int | None = None) -> Table:
        return collectives.gather_table(table, root, capacity)

    def broadcast(self, table: Table, root: int = 0) -> Table:
        return collectives.broadcast_table(table, root)

    def scatter(self, table: Table, root: int = 0, quota: int | None = None):
        return collectives.scatter_table(table, root, quota)

    # -- array / scalar routines
    def allreduce(self, x, op: str = "sum"):
        return collectives.allreduce_array(x, op)

    def reduce_scatter(self, x):
        return collectives.reduce_scatter_array(x)

    def allgather_array(self, x, tiled: bool = False):
        return collectives.allgather_array(x, tiled)

    # -- channels (p2p)
    def shift(self, x, offset: int = 1):
        return channels.shift(x, offset)

    def halo_exchange(self, tail, head):
        return channels.halo_exchange(tail, head)

    def barrier(self):
        collectives.barrier()


def make_communicator(nworkers: int, device=None) -> Communicator:
    """Communicator over ``nworkers`` workers of one card (``device`` places
    :meth:`Communicator.rank`)."""
    return Communicator(nworkers=nworkers, fabric=DEVICE, device=device)
