"""Cost model for the pattern planner (paper §5).

T_total = T_core + T_aux + T_comm, with T = alpha + n * beta per message
(Hockney): paper Table 3 (collectives), Table 4 (local operators) and the
§5.3 per-pattern totals, parameterized for one card. On one card the only
fabric is the on-card transpose (``comm.communicator.DEVICE``), and the
local-operator constant ``gamma_s_per_row`` is an H100 measurement
(``chip_smoke.py`` fits both).

Units: seconds, bytes, rows. ``n`` follows the paper's bold-n convention:
work per worker in *bytes* for communication terms and in *rows* for local
terms (row width ``row_bytes`` converts between them).

:func:`choose_chunk_count` always picks the monolithic shuffle: the
all-to-all on one card is a transpose that overlaps no compute.
:func:`choose_shuffle_algorithm` is the reference's argmin of Table 3's
all-to-all costs. Not ported, by design: the reference's Pallas dispatch
parameters (``kernel_params``), a row count below which it runs the plain
jnp version; on the card every call launches its kernel (ROADMAP, "Not
ported, by design").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from .comm.communicator import DEVICE, FabricProfile

__all__ = [
    "CostParams",
    "params_for_fabric",
    "t_shuffle",
    "t_shuffle_pipelined",
    "t_allgather",
    "t_broadcast",
    "t_reduce",
    "t_allreduce",
    "LOCAL_COSTS",
    "t_local",
    "pattern_cost",
    "choose_join_strategy",
    "choose_groupby_strategy",
    "choose_shuffle_algorithm",
    "choose_chunk_count",
    "choose_batch_rows",
    "ADAPTIVE_REPLAN_EVERY",
    "ADAPTIVE_DRIFT",
    "ADAPTIVE_QUOTA_SAFETY",
    "ADAPTIVE_CAPACITY_SAFETY",
]

#: device seconds per row per worker of the local operators (paper Table
#: 4's constant): a local groupby (sum, min, max, count, mean of one int32
#: column by one int32 key) over 8 workers x 12,500,000 rows, 79.407 ms timed
#: with CUDA events by ``chip_smoke.py``'s ``gamma_fit`` on an NVIDIA H100
#: 80GB HBM3 at a 700 W power limit, divided by the rows per worker.
GAMMA_S_PER_ROW = 6.353e-09


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Hockney (alpha, beta) from the fabric + the local-compute constant.

    Attributes:
      fabric: the interconnect profile supplying alpha [s/message] and
        beta [s/byte] (``DEVICE``, the on-card transpose).
      gamma_s_per_row: per-row local processing constant [s/row/worker],
        the card's (:data:`GAMMA_S_PER_ROW`).
    """

    fabric: FabricProfile = DEVICE
    gamma_s_per_row: float = GAMMA_S_PER_ROW

    @property
    def alpha(self) -> float:
        return self.fabric.alpha_s

    @property
    def beta(self) -> float:
        return self.fabric.beta_s_per_byte


# -- Adaptive mid-stream re-planning knobs ---------------------------------------
#
# The streaming runner's AdaptiveController (repro_torch.stats.adaptive)
# corrects quota/capacity for later morsels from observed batch histograms.
# These are the reference's policy constants, not calibration: re-plans
# rebuild the batch plan for new static shapes, so the controller acts only
# at a coarse cadence and only on substantial drift, and always leaves
# safety headroom over observed maxima (an undersized buffer raises under
# strict_overflow; an oversized one just wastes a bounded slice of memory).

#: batches between adaptive re-plan decision points
ADAPTIVE_REPLAN_EVERY = 4

#: relative quota drift (|target - current| / current) that triggers a re-plan
ADAPTIVE_DRIFT = 0.25

#: headroom multiplier over the max observed per-partition histogram cell
ADAPTIVE_QUOTA_SAFETY = 1.5

#: headroom multiplier over the max observed per-worker partial-group count
ADAPTIVE_CAPACITY_SAFETY = 2.0


def params_for_fabric(fabric: str | None = None) -> CostParams:
    """The card's CostParams. The reference maps a context's fabric name
    ("ici" | "dcn" | "host") to its profile; one card has only the on-card
    transpose, so every name gives the ``DEVICE`` profile (the port's
    ``DDFContext`` has no fabric)."""
    return CostParams()


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


def t_shuffle_pipelined(
    P: int,
    n_bytes: float,
    num_chunks: int,
    p: CostParams,
    core_s: float = 0.0,
    algorithm: str = "isend-irecv",
) -> float:
    """Wall time of the K-chunk pipelined shuffle (comm/compute overlap).

    With the payload split into K chunks, chunk ``i+1``'s transfer overlaps
    chunk ``i``'s local merge/compute, so the steady state runs at
    ``max(T_comm_chunk, T_core_chunk)`` per chunk and only the pipeline
    fill/drain is exposed:

        T ≈ t_comm + t_core + (K-1) * max(t_comm, t_core)

    where ``t_comm = T_startup + T_transfer/K`` (every chunk pays the full
    per-message startup — the alpha term that bounds useful K) and
    ``t_core = core_s / K``.

    Args:
      P: number of workers.
      n_bytes: per-worker *total* payload in bytes.
      num_chunks: pipeline depth K >= 1 (K=1 is the monolithic shuffle).
      p: Hockney/compute calibration.
      core_s: total local compute to overlap against, in seconds (e.g. the
        merge/compact leg of the pattern using the shuffle).
      algorithm: monolithic collective flavor used per chunk.

    Returns:
      Estimated wall seconds for the shuffle + overlapped compute.
    """
    K = max(int(num_chunks), 1)
    s, x, r = t_shuffle(P, n_bytes / K, p, algorithm)
    t_comm = s + x + r  # startup is paid per chunk: t_shuffle already has it
    t_core = core_s / K
    return t_comm + t_core + (K - 1) * max(t_comm, t_core)


def t_broadcast(P: int, n_bytes: float, p: CostParams, algorithm: str = "binomial"):
    """Broadcast cost (paper Table 3): root's n bytes reach all P workers.

    Returns (T_startup, T_transfer, T_reduce) in seconds.
    """
    a, b = p.alpha, p.beta
    lg = math.log2(max(P, 2))
    if algorithm == "binomial":
        return (lg * a, lg * n_bytes * b, 0.0)
    if algorithm == "scatter-allgather":
        return ((lg + P) * a, (P - 1) / P * n_bytes * b, 0.0)
    raise ValueError(algorithm)


def t_reduce(P: int, n_bytes: float, p: CostParams, algorithm: str = "binomial"):
    """Reduce-to-root cost (paper Table 3); third term is reduction compute.

    Returns (T_startup, T_transfer, T_reduce) in seconds.
    """
    a, b = p.alpha, p.beta
    lg = math.log2(max(P, 2))
    if algorithm == "binomial":
        return (lg * a, lg * n_bytes * b, lg * n_bytes * b)
    if algorithm == "reduce-scatter-gather":
        return (lg * a, (P - 1) / P * n_bytes * b, (P - 1) / P * n_bytes * b)
    raise ValueError(algorithm)


def t_allreduce(P: int, n_bytes: float, p: CostParams, algorithm: str = "reduce-scatter-allgather"):
    """AllReduce cost (paper Table 3): all workers end with the reduction.

    Returns (T_startup, T_transfer, T_reduce) in seconds.
    """
    a, b = p.alpha, p.beta
    lg = math.log2(max(P, 2))
    if algorithm == "binomial":
        return (lg * a, lg * n_bytes * b, lg * n_bytes * b)
    if algorithm == "recursive-doubling":
        return (lg * a, lg * n_bytes * b, lg * n_bytes * b)
    if algorithm == "reduce-scatter-allgather":
        return (lg * a, 2 * (P - 1) / P * n_bytes * b, (P - 1) / P * n_bytes * b)
    raise ValueError(algorithm)


def _sum3(t):
    return t[0] + t[1] + t[2]


# -- Table 4: core local operator costs ------------------------------------------
# cost(n_rows, cardinality C) -> seconds, using the calibrated gamma.

LOCAL_COSTS: dict[str, Callable[[float, float, CostParams], float]] = {
    "selection": lambda n, C, p: p.gamma_s_per_row * n,
    "map": lambda n, C, p: p.gamma_s_per_row * n,
    "row_aggregation": lambda n, C, p: p.gamma_s_per_row * n,
    "projection": lambda n, C, p: p.gamma_s_per_row * 1.0,  # O(c)
    "union": lambda n, C, p: p.gamma_s_per_row * n,
    "set_difference": lambda n, C, p: p.gamma_s_per_row * n,
    # paper Table 4: Hash-Join O(n) + O(n/C); Sort-Join O(n log n) + O(n/C)
    "hash_join": lambda n, C, p: p.gamma_s_per_row * (n + n / max(C, 1e-9)),
    "sort_join": lambda n, C, p: p.gamma_s_per_row * (n * math.log2(max(n, 2)) + n / max(C, 1e-9)),
    "transpose": lambda n, C, p: p.gamma_s_per_row * n,
    "unique": lambda n, C, p: p.gamma_s_per_row * n,
    "groupby": lambda n, C, p: p.gamma_s_per_row * n,
    "column_aggregation": lambda n, C, p: p.gamma_s_per_row * n,
    "sort": lambda n, C, p: p.gamma_s_per_row * n * math.log2(max(n, 2)),
}


def t_local(op: str, n_rows: float, cardinality: float = 1.0, p: CostParams = CostParams()) -> float:
    """Core local operator cost (paper Table 4).

    Args:
      op: a key of :data:`LOCAL_COSTS` (e.g. "hash_join", "sort", "groupby").
      n_rows: local rows processed (the paper's bold-n, in rows).
      cardinality: key cardinality fraction C in (0, 1].
      p: calibration; uses ``gamma_s_per_row`` [s/row].

    Returns:
      Estimated local seconds.
    """
    return LOCAL_COSTS[op](n_rows, cardinality, p)


# -- §5.3 per-pattern totals -------------------------------------------------------

def pattern_cost(
    pattern: str,
    *,
    P: int,
    n_rows: float,
    row_bytes: float,
    cardinality: float = 1.0,
    core_op: str = "map",
    params: CostParams = CostParams(),
    shuffle_algorithm: str = "isend-irecv",
    num_chunks: int = 1,
) -> dict[str, float]:
    """Estimated wall time breakdown {core, aux, comm, total} per worker.

    Args:
      pattern: a key of :data:`repro_torch.core.patterns.PATTERNS`.
      P: number of workers.
      n_rows: rows per worker (bold-n in rows).
      row_bytes: bytes per row (converts rows -> bytes for comm terms).
      cardinality: key cardinality fraction C in (0, 1].
      core_op: the core local operator (a :data:`LOCAL_COSTS` key).
      params: Hockney + gamma calibration.
      shuffle_algorithm: collective flavor for shuffle-based patterns.
      num_chunks: pipeline depth K for shuffle-based patterns. With K > 1
        the shuffle and the core op overlap
        (:func:`t_shuffle_pipelined`), so ``total < core + aux + comm``;
        the component terms still report the unoverlapped costs.

    Returns:
      {"core", "aux", "comm", "total"} in seconds.
    """
    p = params
    n_bytes = n_rows * row_bytes
    C = cardinality
    if pattern == "embarrassingly_parallel":
        core = t_local(core_op, n_rows, C, p)
        return _pack(core, 0.0, 0.0)
    if pattern == "shuffle_compute":
        aux = t_local("map", n_rows, C, p)  # hash partition is a map
        comm = _sum3(t_shuffle(P, n_bytes, p, shuffle_algorithm))
        core = t_local(core_op, n_rows, C, p)
        if num_chunks > 1:
            piped = t_shuffle_pipelined(P, n_bytes, num_chunks, p,
                                        core_s=core, algorithm=shuffle_algorithm)
            return {"core": core, "aux": aux, "comm": comm, "total": aux + piped}
        return _pack(core, aux, comm)
    if pattern == "sample_shuffle_compute":
        aux = t_local("sort", n_rows, C, p) + t_local("map", n_rows, C, p)
        comm = _sum3(t_allreduce(P, 8.0 * P, p)) + _sum3(t_shuffle(P, n_bytes, p, shuffle_algorithm))
        core = t_local("sort", n_rows, C, p)  # local merge
        return _pack(core, aux, comm)
    if pattern == "combine_shuffle_reduce":
        core1 = t_local(core_op, n_rows, C, p)
        aux = t_local("map", n_rows * C, C, p)
        comm = _sum3(t_shuffle(P, n_bytes * C, p, shuffle_algorithm))
        core2 = t_local(core_op, n_rows * C, C, p)
        if num_chunks > 1:
            piped = t_shuffle_pipelined(P, n_bytes * C, num_chunks, p,
                                        core_s=core2, algorithm=shuffle_algorithm)
            return {"core": core1 + core2, "aux": aux, "comm": comm,
                    "total": core1 + aux + piped}
        return _pack(core1 + core2, aux, comm)
    if pattern == "broadcast_compute":
        # broadcast the small relation (n here = small side), join locally
        comm = _sum3(t_allgather(P, n_bytes, p))
        core = t_local(core_op, n_rows, C, p)
        return _pack(core, 0.0, comm)
    if pattern == "globally_reduce":
        core = t_local("column_aggregation", n_rows, C, p)
        comm = _sum3(t_allreduce(P, row_bytes, p))
        return _pack(core, 0.0, comm)
    if pattern == "halo_exchange":
        core = t_local("map", n_rows, C, p)
        comm = p.alpha + row_bytes * p.beta  # one neighbor message
        return _pack(core, 0.0, comm)
    if pattern == "partitioned_io":
        core = t_local("map", n_rows, C, p)
        comm = _sum3(t_shuffle(P, n_bytes, p, shuffle_algorithm))
        return _pack(core, 0.0, comm)
    raise ValueError(pattern)


def _pack(core, aux, comm):
    return {"core": core, "aux": aux, "comm": comm, "total": core + aux + comm}


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


def choose_shuffle_algorithm(P: int, n_bytes: float, params: CostParams = CostParams()) -> str:
    """Latency-bound (small n, large P) -> Bruck; else pairwise/isend
    (paper §6.1.1 recommendation)."""
    best, best_t = None, float("inf")
    for alg in ("isend-irecv", "ring", "pairwise", "bruck"):
        t = _sum3(t_shuffle(P, n_bytes, params, alg))
        if t < best_t:
            best, best_t = alg, t
    return best


def choose_chunk_count(P: int, n_bytes: float, params: CostParams = CostParams()) -> int:
    """Pipeline depth of a shuffle of ``n_bytes`` per worker: 1, the
    monolithic shuffle. The reference picks the depth that best overlaps
    the chunked all-to-all with the local operator; on one card the
    all-to-all is a transpose that overlaps nothing, so chunks only add
    passes. The same plans therefore differ from the reference's only in
    ``num_chunks``, with the same results."""
    return 1


def choose_batch_rows(
    P: int,
    row_bytes: float,
    p: CostParams = CostParams(),
    total_rows: int | None = None,
    memory_budget_bytes: float = 32e6,
    working_set_factor: float = 4.0,
    dispatch_overhead_s: float = 1e-3,
    overhead_fraction: float = 0.05,
    min_rows: int = 256,
) -> int:
    """Pick the global row count per streamed batch (morsel size).

    Two forces bound the choice (the streaming analogue of
    :func:`choose_chunk_count`'s alpha-vs-beta tradeoff):

    - **memory ceiling** (hard): a batch's per-device working set —
      ``row_bytes * rows / P`` inflated by ``working_set_factor`` for
      shuffle buffers and operator intermediates — must fit
      ``memory_budget_bytes``;
    - **overhead amortization** (soft): each batch pays a fixed host-side
      cost ``dispatch_overhead_s`` (decode setup, cache lookups, one
      program dispatch), so batches should be large enough that this stays
      under ``overhead_fraction`` of per-batch device work, modeled as
      ``rows/P * (gamma + row_bytes * beta)`` seconds.

    The intra-batch shuffle pipeline depth is planned separately per
    shuffle op by :func:`choose_chunk_count` once batch-scale row estimates
    are known (``repro_torch.plan.optimizer.plan_shuffles``).

    Args:
      P: number of workers.
      row_bytes: bytes per row of the scanned schema (post-pushdown).
      p: Hockney/compute calibration.
      total_rows: dataset rows, to clamp the batch to the data.
      memory_budget_bytes: per-device budget for one batch's working set.
      working_set_factor: working-set inflation over raw batch bytes.
      dispatch_overhead_s: fixed per-batch host overhead.
      overhead_fraction: target ceiling for overhead / device work.
      min_rows: floor on the returned batch size.

    Returns:
      Global rows per batch (>= 1).
    """
    P = max(int(P), 1)
    row_bytes = max(float(row_bytes), 1.0)
    mem_rows = P * memory_budget_bytes / (row_bytes * max(working_set_factor, 1.0))
    t_row = p.gamma_s_per_row + row_bytes * p.beta  # device seconds/row/worker
    amort_rows = dispatch_overhead_s * P / (max(overhead_fraction, 1e-6) * t_row)
    rows = min(mem_rows, max(amort_rows, float(min_rows)))
    if total_rows is not None:
        rows = min(rows, float(max(int(total_rows), 1)))
    return max(int(rows), 1)
