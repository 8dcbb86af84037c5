"""Cost model for the pattern planner (paper §5), the part the planner
reads.

T = alpha + n * beta per message (Hockney). On one card the only fabric is
the on-card transpose (``comm.communicator.DEVICE``).

Not ported yet: the local-compute costs (Table 4) and the pipeline-depth
chooser, which need a fabric that overlaps compute (one card has none);
broadcast/reduce/allreduce costs, the full per-pattern breakdown, the
shuffle-algorithm and batch-size choosers and the adaptive re-planning
constants (ROADMAP queue A item 5).
"""

from __future__ import annotations

import dataclasses
import math

from .comm.communicator import DEVICE, FabricProfile

__all__ = [
    "CostParams",
    "t_shuffle",
    "t_allgather",
    "choose_join_strategy",
    "choose_groupby_strategy",
]


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Hockney (alpha, beta) from the fabric."""

    fabric: FabricProfile = DEVICE

    @property
    def alpha(self) -> float:
        return self.fabric.alpha_s

    @property
    def beta(self) -> float:
        return self.fabric.beta_s_per_byte


# -- Table 3: collective communication costs ------------------------------------

def t_shuffle(P: int, n_bytes: float, p: CostParams, algorithm: str = "isend-irecv"):
    """All-to-all cost (paper Table 3): (T_startup, T_transfer, T_reduce) in
    seconds for ``n_bytes`` per worker."""
    a, b = p.alpha, p.beta
    if algorithm == "isend-irecv":
        return ((P - 1) * a, (P - 1) / P * n_bytes * b, 0.0)
    if algorithm == "ring":
        return (P * a, P * n_bytes * b, 0.0)
    if algorithm == "pairwise":
        return (P * a, n_bytes * b, 0.0)
    if algorithm == "bruck":
        lg = math.log2(max(P, 2))
        return (lg * a, lg * n_bytes / 2 * b, 0.0)
    raise ValueError(algorithm)


def t_allgather(P: int, n_bytes: float, p: CostParams, algorithm: str = "ring"):
    """AllGather cost (paper Table 3); the whole table is ``P * n_bytes``."""
    a, b = p.alpha, p.beta
    total = P * n_bytes
    if algorithm == "ring":
        return (P * a, (P - 1) / P * total * b, 0.0)
    if algorithm in ("recursive-doubling", "bruck"):
        return (math.log2(max(P, 2)) * a, (P - 1) / P * total * b, 0.0)
    raise ValueError(algorithm)


# -- §5.4 runtime strategy selection ----------------------------------------------

def choose_join_strategy(n_left_rows: float, n_right_rows: float, P: int,
                         row_bytes: float, params: CostParams = CostParams(),
                         broadcast_budget_bytes: float = 256e6) -> str:
    """"broadcast" when replicating the small side costs less than
    shuffling both and fits ``broadcast_budget_bytes``, else "shuffle"."""
    small = min(n_left_rows, n_right_rows)
    if small * row_bytes > broadcast_budget_bytes:
        return "shuffle"
    shuffle_cost = (sum(t_shuffle(P, n_left_rows / P * row_bytes, params))
                    + sum(t_shuffle(P, n_right_rows / P * row_bytes, params)))
    bcast_cost = sum(t_allgather(P, small / P * row_bytes, params))
    return "broadcast" if bcast_cost < shuffle_cost else "shuffle"


def choose_groupby_strategy(cardinality: float, threshold: float = 0.5) -> bool:
    """Pre-combine (Combine-Shuffle-Reduce) at low cardinality (paper
    §5.4.1). Returns True for pre-combine."""
    return cardinality < threshold
