"""Out-of-core streaming execution engine: the reference's ``repro.stream``
on one card.

Runs lazy ``repro_torch.plan`` pipelines over chunked on-disk datasets
larger than the card's memory:

- ``scan``   — ``scan_csv`` / ``scan_dataset`` build ``LazyDDF`` handles
  whose leaves are ``SCAN`` plan nodes over a ``DatasetManifest``;
- ``runner`` — the morsel-driven batch runner: slices manifests into
  cost-model-sized batches (``cost_model.choose_batch_rows``), copies each
  decoded batch to the card and drives it through the one optimized plan
  (``executor.run_planned``), overlaps host-side chunk decode of batch
  *k+1* with the card's work on batch *k* (a prefetch thread), and
  finalizes non-EP tails via carry-state merges (groupby/unique) or
  host-side spill + merge (sort, scan x scan joins);
- ``checkpoint`` — ``StreamCheckpoint``, atomic snapshots of the runner's
  whole per-query state (scan cursor, carry tables as host numpy, spill
  manifests) so a killed query resumes mid-stream bit-identically;
- ``StreamExecution`` — the runner's morsel loop exposed as an externally
  drivable step generator (one event per morsel);
- ``recovery`` — retryable-vs-fatal error classification
  (``classify_error``, ``RETRYABLE_EXCEPTIONS``) and the bounded-backoff
  ``RetryPolicy`` / ``call_with_retry`` used at every runner fault site.

Entry points: ``repro_torch.stream.scan_csv(...)`` / ``scan_dataset(...)``
returning a ``LazyDDF``; then ``.collect_stream()`` / ``.to_batches()``
(plain ``.collect()`` on a scan-bearing plan routes here automatically).
Fault tolerance is opt-in per run via ``checkpoint_dir=`` / ``resume=``.
"""

from .checkpoint import StreamCheckpoint  # noqa: F401
from .recovery import (  # noqa: F401
    RETRYABLE_EXCEPTIONS,
    RetryPolicy,
    call_with_retry,
    classify_error,
)
from .runner import StreamExecution, collect, to_batches  # noqa: F401
from .scan import scan_csv, scan_dataset  # noqa: F401

__all__ = [
    "scan_csv",
    "scan_dataset",
    "collect",
    "to_batches",
    "StreamExecution",
    "StreamCheckpoint",
    "RetryPolicy",
    "RETRYABLE_EXCEPTIONS",
    "call_with_retry",
    "classify_error",
]
