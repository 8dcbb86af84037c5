"""Host-side planner (paper §4.3, §5.4): picks the pattern variant and the
static sizes (quota, capacity) of one distributed operator from table sizes
and sampled cardinality.

The planner always plans the monolithic shuffle. On one card the
all-to-all is a transpose that overlaps no compute, so the chunked shuffle
only adds passes; it stays available to callers that pass ``num_chunks``,
and ``cost_model.choose_chunk_count`` picks 1 until a multi-card slice
(ROADMAP, "Parked until a run shows more than one card")."""

from __future__ import annotations

import dataclasses

import numpy as np

from . import cost_model
from .partition import default_quota

__all__ = ["PATTERNS", "Plan", "plan_join", "plan_groupby", "sampled_quota",
           "sampled_cardinality", "quota_from_histogram"]

# Pattern -> (operators, result semantic, communication ops) -- paper Table 2.
PATTERNS: dict[str, dict] = {
    "embarrassingly_parallel": dict(
        operators=("select", "project", "map", "row_aggregation"),
        result="partitioned", comm=()),
    "shuffle_compute": dict(
        operators=("union", "difference", "join", "transpose"),
        result="partitioned", comm=("shuffle",)),
    "combine_shuffle_reduce": dict(
        operators=("unique", "groupby"),
        result="partitioned", comm=("shuffle",)),
    "broadcast_compute": dict(
        operators=("broadcast_join",),
        result="partitioned", comm=("bcast",)),
    "globally_reduce": dict(
        operators=("column_aggregation", "length", "equality"),
        result="replicated", comm=("allreduce",)),
    "sample_shuffle_compute": dict(
        operators=("sort",),
        result="partitioned", comm=("gather", "bcast", "shuffle", "allreduce")),
    "halo_exchange": dict(
        operators=("window",),
        result="partitioned", comm=("send_recv",)),
    "partitioned_io": dict(
        operators=("read", "write", "rebalance"),
        result="partitioned", comm=("send_recv", "scatter", "gather")),
}


@dataclasses.dataclass(frozen=True)
class Plan:
    """Execution plan of one distributed operator: pattern variant,
    per-destination quota, output capacity and planning inputs."""

    strategy: str
    quota: int
    capacity: int
    details: dict


def quota_from_histogram(hist: np.ndarray, capacity: int, num_partitions: int,
                         sample_fraction: float = 1.0, safety: float = 1.5) -> int:
    """Quota from a destination histogram (paper §5.4.2): the (scaled)
    largest cell with ``safety`` headroom, clipped to ``capacity``, at
    least 16."""
    hist = np.asarray(hist)
    if hist.size == 0 or hist.max() <= 0:
        return default_quota(capacity, num_partitions)
    est_max = hist.max() / max(sample_fraction, 1e-9)
    return int(min(capacity, max(est_max * safety, 16)))


def sampled_quota(dest_sample: np.ndarray, capacity: int, num_partitions: int,
                  sample_fraction: float, safety: float = 1.5) -> int:
    """Quota from sampled destination ids (paper §5.4.2)."""
    if dest_sample.size == 0:
        return default_quota(capacity, num_partitions)
    hist = np.bincount(dest_sample, minlength=num_partitions)
    return quota_from_histogram(hist, capacity, num_partitions, sample_fraction, safety)


def sampled_cardinality(key_sample: np.ndarray) -> float:
    """C-hat = unique / total of a host-side key sample (paper §5.4.1)."""
    if key_sample.size == 0:
        return 1.0
    return float(len(np.unique(key_sample))) / float(key_sample.size)


def plan_join(n_left: int, n_right: int, P: int, capacity: int,
              row_bytes: float = 16.0,
              params: cost_model.CostParams = cost_model.CostParams(),
              cardinality: float = 1.0) -> Plan:
    """Hash-shuffle vs broadcast join."""
    strategy = cost_model.choose_join_strategy(n_left, n_right, P, row_bytes, params)
    quota = default_quota(capacity, P)
    exp_out = (max(n_left, n_right) / max(P, 1)) / max(cardinality, 1e-9)
    cap_out = int(min(max(2 * exp_out, capacity), 4 * capacity))
    return Plan(strategy, quota, cap_out, dict(n_left=n_left, n_right=n_right))


def plan_groupby(cardinality: float, P: int, capacity: int,
                 pre_combine: bool | None = None) -> Plan:
    """Combine-shuffle-reduce vs shuffle-compute (paper §5.4.1).
    Cardinality 0.0 means unknown."""
    if pre_combine is None:
        pre_combine = cost_model.choose_groupby_strategy(cardinality)
    quota = default_quota(capacity, P)
    return Plan("combine_shuffle_reduce" if pre_combine else "shuffle_compute",
                quota, capacity, dict(cardinality=cardinality))
