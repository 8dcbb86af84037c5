"""Failure handling for the trainer: a per-step watchdog that takes an
emergency checkpoint when a step straggles.

``StepGuard.step`` runs one train step, waits for the card
(``plan.executor.sync``, the counterpart of ``jax.block_until_ready``) and
times it with the injected clock. Once ``min_history`` steps are known, a
step longer than ``threshold_factor`` times the mean of the last 20 saves
the new state through ``checkpoint.save``'s atomic publish.

The reference's ``rescale_state`` (restore onto a different device mesh)
needs the sharding plans of ``sharding.py``, which the one-card port does
not have; it waits with them.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..plan.executor import sync
from . import checkpoint

__all__ = ["StepGuard"]


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        t = _first_tensor(v) if isinstance(v, (dict, list, tuple, torch.Tensor)) else None
        if t is not None:
            return t
    return None


class StepGuard:
    """Watchdog: emergency-checkpoint when a step exceeds the straggler
    threshold (factor x trailing-mean step time).

    ``time_fn`` injects the clock (tests drive straggler detection with a
    fake clock; production uses ``time.monotonic``). Emergency saves go
    through ``checkpoint.save``'s atomic tmp-dir-rename publish, so a
    straggler that turns into a crash mid-save never corrupts the previous
    checkpoint; ``last_emergency_step`` records the most recent trigger."""

    def __init__(self, ckpt_dir: str, threshold_factor: float = 3.0,
                 min_history: int = 5, time_fn: Callable[[], float] = time.monotonic):
        self.ckpt_dir = ckpt_dir
        self.factor = threshold_factor
        self.min_history = min_history
        self.time_fn = time_fn
        self.history: list[float] = []
        self.emergency_saves = 0
        self.last_emergency_step: int | None = None

    def step(self, step_idx: int, fn: Callable, state, *args):
        t0 = self.time_fn()
        out = fn(state, *args)
        t = _first_tensor(out)
        if t is not None:
            sync(t)
        dt = self.time_fn() - t0
        if len(self.history) >= self.min_history:
            recent = self.history[-20:]
            if dt > self.factor * (sum(recent) / len(recent)):
                checkpoint.save(self.ckpt_dir, step_idx, out[0] if isinstance(out, tuple) else out)
                self.emergency_saves += 1
                self.last_emergency_step = step_idx
        self.history.append(dt)
        return out
