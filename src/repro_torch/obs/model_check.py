"""Cost-model validation: per-operator predicted-vs-observed accounting.

The engine *plans* from the paper's Hockney-style cost model
(``repro_torch.core.cost_model.pattern_cost``) but historically never recorded
what actually happened. This module closes that loop: every planned
shuffle/groupby/scan executed while tracing is enabled appends a
:class:`ModelRecord` pairing the model's predicted seconds/rows/bytes with
the measured wall time and actual volumes, and :func:`model_report`
summarizes prediction error per paper pattern — the reproduction's
validation payoff.

Predictions are computed as a *side table* over the planned DAG
(:func:`predict_plan`, keyed by post-order node index). Plan nodes are
never mutated or annotated in place: node structural identity keys the
plan and op caches and the streaming checkpoint ``query_key``, so
attaching data to nodes would silently split caches.

A whole-pipeline program (the executor's one composed callable) has a
single wall measurement; the executor apportions it across the program's
planned operators in proportion to predicted share (:func:`record_program`). Each record keeps
the raw ``program_s`` and its ``share`` in ``meta`` so the apportioning is
never hidden.

Recording is gated on ``repro_torch.obs.trace.enabled()`` and thread-safe
(stream prefetch + service scheduler threads). Over a process group the
observed rows of ``plan.execute`` and ``stream.device_op`` are global (every
worker's, gathered over the group, so tracing must be on for every rank
alike); the wall times and the spans are each rank's own.
"""

from __future__ import annotations

import dataclasses
import threading

from . import trace as _trace

__all__ = [
    "ModelRecord",
    "mark",
    "model_report",
    "predict_plan",
    "record",
    "record_program",
    "records",
    "reset",
    "scan_prediction",
]

_lock = threading.Lock()
_records: list = []
_MAX_RECORDS = 500_000


@dataclasses.dataclass
class ModelRecord:
    """One predicted-vs-observed sample for a planned operator.

    ``pattern`` is the paper pattern the operator maps to (e.g.
    ``shuffle_compute``); ``op`` labels the concrete operator instance.
    Seconds are per-dispatch wall time; rows/bytes fields are None when a
    side was not measured/predicted for this sample."""

    pattern: str
    op: str
    predicted_s: float
    observed_s: float
    predicted_rows: float | None = None
    observed_rows: int | None = None
    predicted_bytes: float | None = None
    observed_bytes: int | None = None
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def rel_err(self) -> float:
        """``|observed - predicted| / predicted`` for the time terms."""
        return abs(self.observed_s - self.predicted_s) / max(
            self.predicted_s, 1e-9)


def record(pattern: str, op: str, predicted_s: float, observed_s: float,
           **fields) -> None:
    """Append one sample (no-op while tracing is disabled)."""
    if not _trace.enabled():
        return
    rec = ModelRecord(pattern, op, float(predicted_s), float(observed_s),
                      **fields)
    with _lock:
        if len(_records) < _MAX_RECORDS:
            _records.append(rec)


def records(since: int = 0) -> list:
    """Snapshot of collected samples (from index ``since``; :func:`mark`)."""
    with _lock:
        return list(_records[since:])


def mark() -> int:
    """Current sample count — pass to ``records(since=...)`` to scope a
    later read to samples collected after this point."""
    with _lock:
        return len(_records)


def reset() -> None:
    """Drop every collected sample."""
    with _lock:
        _records.clear()


# -- plan -> pattern predictions ----------------------------------------------

def _pattern_for(node):
    """(pattern, core_op) for a *planned* node, or None when the node maps
    to no modeled communication pattern (EP ops, elided shuffles)."""
    from ..plan import logical as L

    if isinstance(node, L.Scan):
        return "partitioned_io", "map"
    if isinstance(node, L.Join):
        if node.strategy == "local":
            return None
        if (node.strategy or "").startswith("broadcast"):
            return "broadcast_compute", "hash_join"
        return "shuffle_compute", "hash_join"
    if isinstance(node, L.GroupBy):
        if node.elide_shuffle:
            return None
        if node.pre_combine:
            return "combine_shuffle_reduce", "groupby"
        return "shuffle_compute", "groupby"
    if isinstance(node, L.Unique):
        if node.elide_shuffle:
            return None
        return "combine_shuffle_reduce", "unique"
    if isinstance(node, (L.Union, L.Difference)):
        if node.elide_shuffle:
            return None
        return "shuffle_compute", "unique"
    if isinstance(node, L.Sort):
        return "sample_shuffle_compute", "sort"
    if isinstance(node, L.Rebalance):
        return "shuffle_compute", "map"
    if isinstance(node, L.Recode):
        # vocab unification: a pure per-row gather, no communication — the
        # one EP node charged individually (it is deliberately kept out of
        # fusion so its cost stays visible)
        return "embarrassingly_parallel", "map"
    return None


def _cardinality(node) -> float:
    from ..plan import logical as L

    if isinstance(node, L.GroupBy):
        c = node.cardinality_hint
        if c is not None and 0.0 < c <= 1.0:
            return c
        return L.UNKNOWN_CARDINALITY
    if isinstance(node, (L.Unique, L.Union, L.Difference)):
        return L.UNKNOWN_CARDINALITY
    return 1.0


def predict_plan(plan, P: int, src_rows, params) -> list:
    """Cost-model predictions for every modeled operator of a planned DAG.

    Returns a side table — one dict per shuffle/groupby/scan-style node,
    in post-order::

        {"node_index": i, "op": "n3:GroupBy", "pattern": ...,
         "predicted_s": ..., "predicted_rows": ..., "predicted_bytes": ...}

    ``node_index`` is the node's position in ``logical.walk(plan)`` (the
    same numbering the executor's aux keys use). ``src_rows`` maps source
    id -> global rows, as passed to the optimizer; ``params`` is the
    fabric's :class:`repro_torch.core.cost_model.CostParams`.
    """
    from ..core import cost_model
    from ..plan import logical as L

    out = []
    memo: dict = {}
    for i, node in enumerate(L.walk(plan)):
        pat = _pattern_for(node)
        if pat is None:
            continue
        pattern, core_op = pat
        if isinstance(node, L.Scan):
            n_in = float(src_rows.get(node.sid, node.capacity))
            in_bytes = n_in * L.row_bytes_of(node.schema)
        else:
            kids = node.children
            n_in = sum(L.estimate_rows(c, src_rows, memo) for c in kids)
            in_bytes = sum(L.estimate_rows(c, src_rows, memo)
                           * L.row_bytes_of(L.schema_of(c)) for c in kids)
        n_in = max(n_in, 1.0)
        rb = in_bytes / n_in
        cost = cost_model.pattern_cost(
            pattern,
            P=P,
            n_rows=n_in / max(P, 1),
            row_bytes=rb,
            cardinality=_cardinality(node),
            core_op=core_op,
            params=params,
            num_chunks=int(getattr(node, "num_chunks", None) or 1),
        )
        out.append({
            "node_index": i,
            "op": f"n{i}:{type(node).__name__}",
            "pattern": pattern,
            "predicted_s": float(cost["total"]),
            "predicted_rows": float(L.estimate_rows(node, src_rows, memo)),
            "predicted_bytes": float(in_bytes),
        })
    return out


def scan_prediction(n_rows: int, row_bytes: float, P: int, params) -> dict:
    """Predicted seconds/bytes for decoding one scan batch — the paper's
    ``partitioned_io`` pattern (read + partition the admitted rows)."""
    from ..core import cost_model

    cost = cost_model.pattern_cost(
        "partitioned_io", P=P, n_rows=max(float(n_rows) / max(P, 1), 1.0),
        row_bytes=float(row_bytes), params=params)
    return {"predicted_s": float(cost["total"]),
            "predicted_rows": float(n_rows),
            "predicted_bytes": float(n_rows) * float(row_bytes)}


def record_program(preds: list, wall_s: float,
                   observed_rows: int | None = None,
                   observed_bytes: int | None = None,
                   op_prefix: str = "") -> None:
    """Record one program's measured wall time against its
    operators' predictions.

    A whole-pipeline program yields a single wall measurement;
    it is apportioned across the program's modeled operators proportional
    to predicted share, with the raw ``program_s`` and each operator's
    ``share`` kept in ``meta``. ``observed_rows``/``observed_bytes`` (the
    program's output) attach to the root-most operator only."""
    if not _trace.enabled() or not preds:
        return
    total = sum(p["predicted_s"] for p in preds)
    total = total if total > 0 else 1.0
    last = len(preds) - 1
    for j, p in enumerate(preds):
        share = p["predicted_s"] / total
        record(p["pattern"], op_prefix + p["op"],
               p["predicted_s"], wall_s * share,
               predicted_rows=p.get("predicted_rows"),
               predicted_bytes=p.get("predicted_bytes"),
               observed_rows=observed_rows if j == last else None,
               observed_bytes=observed_bytes if j == last else None,
               meta={"program_s": wall_s, "share": share,
                     "node_index": p["node_index"]})


def model_report(samples: list | None = None) -> dict:
    """Per-pattern prediction-error summary over collected samples.

    Returns ``{pattern: {"count", "predicted_s", "observed_s",
    "mean_abs_rel_err", "bias"}}`` where ``bias`` is total observed /
    total predicted seconds (> 1: the model underestimates; < 1: it
    overestimates) and ``mean_abs_rel_err`` averages per-sample
    ``|obs - pred| / pred``. Pass ``samples`` to scope (e.g. one
    profiled run); defaults to every collected sample."""
    samples = records() if samples is None else samples
    out: dict[str, dict] = {}
    for r in samples:
        d = out.setdefault(r.pattern, {"count": 0, "predicted_s": 0.0,
                                       "observed_s": 0.0, "_err": 0.0})
        d["count"] += 1
        d["predicted_s"] += r.predicted_s
        d["observed_s"] += r.observed_s
        d["_err"] += r.rel_err
    for d in out.values():
        d["mean_abs_rel_err"] = d.pop("_err") / d["count"]
        d["bias"] = d["observed_s"] / max(d["predicted_s"], 1e-12)
    return out
