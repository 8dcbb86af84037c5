"""The Communicator over the P workers of one card (paper §3.1, Fig. 4).

The reference annotates its ``jax.lax`` collectives with per-fabric Hockney
profiles (alpha, beta) for TPU interconnects. Those are TPU figures and are
not carried over. On one card the shuffle is an on-card transpose, whose
cost is described by the single ``DEVICE`` profile below.
"""

from __future__ import annotations

import dataclasses

from ..dataframe import Table
from . import collectives

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
    paper Table 1 for the routines this slice has."""

    nworkers: int
    fabric: FabricProfile = DEVICE

    def size(self) -> int:
        return self.nworkers

    def shuffle(self, table: Table, dest, quota: int, capacity: int | None = None,
                num_chunks: int = 1):
        """Shuffle live rows to ``dest`` workers; ``num_chunks > 1`` uses the
        chunked engine (bit-exact with the monolithic one). The reference's
        Bruck variant is not ported yet (ROADMAP queue A item 4)."""
        if num_chunks > 1:
            return collectives.shuffle_table_pipelined(table, dest, quota,
                                                       num_chunks, capacity)
        return collectives.shuffle_table(table, dest, quota, capacity)

    def allgather(self, table: Table, capacity: int | None = None) -> Table:
        return collectives.allgather_table(table, capacity)


def make_communicator(nworkers: int) -> Communicator:
    """Communicator over ``nworkers`` workers of one card."""
    return Communicator(nworkers=nworkers, fabric=DEVICE)
