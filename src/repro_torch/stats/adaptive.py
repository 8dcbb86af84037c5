"""Mid-stream adaptive re-planning for the morsel-driven runner.

:class:`AdaptiveController` is the feedback half of the statistics
subsystem: while the streaming runner drives a carry-fold (groupby /
unique), the controller ingests each batch's *observed* facts — rows
admitted, the host-side hash-partition histogram over the shuffle keys,
and the per-worker partial-group counts — and, when the plan's static
quota/capacity drift far enough from what the data actually does,
re-derives those knobs for all later morsels (generalizing the spill
join's double-on-overflow capacity growth into proactive, histogram-led
correction).

Corrections are **result-invariant**: quota/capacity/num_chunks only size
static buffers, so any values large enough for the data produce
bit-identical output (undersized ones raise loudly under
``strict_overflow``). That, plus fully deterministic decision rules and
JSON-able state snapshotted into ``StreamCheckpoint`` (``state_dict`` /
``restore``), keeps resumed adaptive queries bit-identical to
uninterrupted ones — and to non-adaptive and eager execution.

Knobs live in ``cost_model``: ``ADAPTIVE_REPLAN_EVERY`` (decision
cadence, in batches), ``ADAPTIVE_DRIFT`` (relative quota drift that
triggers a re-plan), ``ADAPTIVE_QUOTA_SAFETY`` / ``ADAPTIVE_CAPACITY_SAFETY``
(headroom over the observed maxima).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import cost_model
from ..core import patterns

__all__ = ["AdaptiveController"]

#: hard cap on re-plans per query: each re-plan recompiles the pipeline
#: for the new static shapes, so corrections must stay rare
_MAX_REPLANS = 4


class AdaptiveController:
    """Deterministic quota/capacity feedback controller for one stream.

    The runner calls :meth:`observe` once per batch with what actually
    happened, :meth:`should_replan` at the re-plan cadence, and
    :meth:`apply` to rewrite the batch-root node when a correction is
    due. ``state_dict``/``restore`` round-trip the whole decision state
    through JSON so a checkpoint taken mid-correction resumes with the
    same future decisions (bit-identical results either way).
    """

    def __init__(self, num_partitions: int, plan_quota: int,
                 plan_capacity: int,
                 replan_every: int | None = None):
        self.P = int(num_partitions)
        self.plan_quota = int(plan_quota)
        self.plan_capacity = int(plan_capacity)
        self.replan_every = int(replan_every
                                or cost_model.ADAPTIVE_REPLAN_EVERY)
        self.batches = 0
        self.replans = 0
        self.max_hist = 0        # max rows any one partition received
        self.max_groups = 0      # max partial groups on any one worker
        self.rows_ewma = 0.0
        self.card_ewma = 0.0     # observed groups_out / rows_in
        self.quota_override: int | None = None
        self.capacity_override: int | None = None

    # -- observation ----------------------------------------------------

    def observe(self, rows_in: int, hist=None, groups_out=None,
                max_worker_groups=None) -> None:
        """Fold one batch's observed facts into the controller state.

        ``hist`` is the host hash-partition histogram over the shuffle
        keys (len P); ``groups_out`` the batch's total surviving groups;
        ``max_worker_groups`` the largest per-worker partial count."""
        self.batches += 1
        w = 0.5
        self.rows_ewma = (rows_in if self.batches == 1
                          else w * rows_in + (1 - w) * self.rows_ewma)
        if hist is not None and len(hist):
            self.max_hist = max(self.max_hist, int(np.max(hist)))
        if groups_out is not None and rows_in > 0:
            card = min(float(groups_out) / float(rows_in), 1.0)
            self.card_ewma = (card if self.card_ewma == 0.0
                              else w * card + (1 - w) * self.card_ewma)
        if max_worker_groups is not None:
            self.max_groups = max(self.max_groups, int(max_worker_groups))

    # -- decisions ------------------------------------------------------

    def _target_quota(self) -> int | None:
        if self.max_hist <= 0:
            return None
        return patterns.quota_from_histogram(
            np.asarray([self.max_hist]), self.plan_capacity, self.P,
            safety=cost_model.ADAPTIVE_QUOTA_SAFETY)

    def should_replan(self) -> bool:
        """True when it's a decision point and observed quota need has
        drifted more than ``ADAPTIVE_DRIFT`` from the current plan."""
        if self.replans >= _MAX_REPLANS or self.batches == 0:
            return False
        if self.batches % self.replan_every != 0:
            return False
        target = self._target_quota()
        if target is None:
            return False
        current = self.quota_override or self.plan_quota
        drift = abs(target - current) / max(float(current), 1.0)
        return drift > cost_model.ADAPTIVE_DRIFT

    def apply(self, node):
        """Recompute the quota/capacity corrections from everything
        observed so far, then return ``node`` with them pinned for all
        later morsels (one re-plan consumed)."""
        self.replans += 1
        target = self._target_quota()
        if target is not None:
            self.quota_override = int(target)
        if self.max_groups > 0:
            cap = int(min(
                self.plan_capacity,
                max(self.max_groups * cost_model.ADAPTIVE_CAPACITY_SAFETY,
                    16)))
            self.capacity_override = cap
        return self.pin(node)

    def pin(self, node):
        """Return ``node`` with the *current* overrides applied (no new
        decision — what a checkpoint-resumed stream uses to re-enter the
        exact corrected plan). The optimizer keeps explicit values;
        ``num_chunks`` resets to None so it re-derives for the new
        shapes."""
        fields = {f.name for f in dataclasses.fields(node)}
        repl = {}
        if self.quota_override is not None and "quota" in fields:
            repl["quota"] = self.quota_override
        if self.capacity_override is not None and "capacity" in fields:
            repl["capacity"] = self.capacity_override
        if repl and "num_chunks" in fields:
            repl["num_chunks"] = None
        if (repl and self.card_ewma > 0.0 and "cardinality_hint" in fields):
            repl["cardinality_hint"] = round(
                min(max(self.card_ewma, 1e-3), 1.0), 3)
        return dataclasses.replace(node, **repl) if repl else node

    @property
    def current_quota(self) -> int:
        """The quota later morsels will run with (override or plan)."""
        return self.quota_override or self.plan_quota

    # -- checkpoint plumbing --------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full decision state."""
        return {
            "P": self.P,
            "plan_quota": self.plan_quota,
            "plan_capacity": self.plan_capacity,
            "replan_every": self.replan_every,
            "batches": self.batches,
            "replans": self.replans,
            "max_hist": self.max_hist,
            "max_groups": self.max_groups,
            "rows_ewma": self.rows_ewma,
            "card_ewma": self.card_ewma,
            "quota_override": self.quota_override,
            "capacity_override": self.capacity_override,
        }

    @classmethod
    def restore(cls, state: dict) -> "AdaptiveController":
        """Rebuild a controller from :meth:`state_dict` output; resumed
        streams make exactly the decisions the interrupted one would."""
        c = cls(state["P"], state["plan_quota"], state["plan_capacity"],
                state.get("replan_every"))
        c.batches = int(state["batches"])
        c.replans = int(state["replans"])
        c.max_hist = int(state["max_hist"])
        c.max_groups = int(state["max_groups"])
        c.rows_ewma = float(state["rows_ewma"])
        c.card_ewma = float(state["card_ewma"])
        qo = state.get("quota_override")
        co = state.get("capacity_override")
        c.quota_override = None if qo is None else int(qo)
        c.capacity_override = None if co is None else int(co)
        return c
