"""Statistics subsystem: chunk sketches, estimation, adaptive re-planning.

The reference's ``repro.stats``, in three cooperating parts:

- :mod:`repro_torch.stats.sketch` — per-chunk :class:`ChunkStats` (row
  count, per-column min/max, KMV distinct sketch) computed at dataset write
  time and serialized into the JSON manifest; mergeable to dataset level;
  :func:`backfill_stats` migrates pre-stats datasets in place.
- :mod:`repro_torch.stats.estimate` — interval evaluation of absorbed scan
  predicates over chunk bounds (:func:`chunk_skip_mask`: skip whole chunks
  before decode, never a chunk that could match), selectivity and
  key-cardinality estimates, and :class:`PlanStats`, the bundle the plan
  optimizer and cost model consume in place of fixed ratios.
- :mod:`repro_torch.stats.adaptive` — :class:`AdaptiveController`, the
  mid-stream feedback loop correcting quota/capacity for later morsels from
  observed batch cardinalities, checkpoint-snapshotted so resumed queries
  stay bit-identical.
"""

from .sketch import (
    ChunkStats,
    ColumnStats,
    DEFAULT_KMV_K,
    STATS_VERSION,
    backfill_stats,
    hash32,
    merge_chunk_stats,
)
from .estimate import (
    Interval,
    PlanStats,
    chunk_skip_mask,
    expr_interval,
    key_cardinality,
    plan_stats,
    predicate_selectivity,
    scan_row_estimate,
)
from .adaptive import AdaptiveController

__all__ = [
    "ColumnStats",
    "ChunkStats",
    "merge_chunk_stats",
    "hash32",
    "DEFAULT_KMV_K",
    "STATS_VERSION",
    "backfill_stats",
    "Interval",
    "expr_interval",
    "chunk_skip_mask",
    "predicate_selectivity",
    "key_cardinality",
    "scan_row_estimate",
    "PlanStats",
    "plan_stats",
    "AdaptiveController",
]
