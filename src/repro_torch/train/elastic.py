"""Elastic restore and failure handling for the trainer.

``rescale_state`` restores a checkpoint onto a mesh of another worker
count: the state comes back through ``checkpoint.restore`` whole, on one
device, and carries the new mesh's sharding plan (``repro_torch.sharding``)
for ``params``, ``opt.mu`` and ``opt.nu``, with ``opt.step`` replicated.
One process holds every shard: ``state.local(coord)`` gives the views that
a mesh coordinate would hold, never copies. Onto a mesh over a process
group (``launch.mesh.make_group_mesh``) each rank gets its own
coordinate's shards, a ``sharding.RankState`` the planned step takes.

``StepGuard.step`` runs one train step, waits for the card
(``plan.executor.sync``, the counterpart of ``jax.block_until_ready``) and
times it with the injected clock. Once ``min_history`` steps are known, a
step longer than ``threshold_factor`` times the mean of the last 20 saves
the new state through ``checkpoint.save``'s atomic publish. For a state
over a process group, rank 0's clock decides and every rank is shown the
decision (``broadcast_ints``), so that every rank saves at the same step:
a rank deciding alone would leave the others waiting in its gathers.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from .. import sharding as shard_mod
from ..core.comm import fsdp
from ..device import resolve_device
from ..plan.executor import sync
from ..tree import flatten
from . import checkpoint

__all__ = ["ShardedState", "rescale_state", "StepGuard"]


class ShardedState(dict):
    """A train state {params, opt} with its layout on a mesh: ``plan`` and
    ``specs`` (:func:`repro_torch.sharding.state_specs`). It is the state
    itself, usable wherever a restored state is."""

    def __init__(self, state: dict, plan: shard_mod.ShardingPlan, specs: dict):
        super().__init__(state)
        self.plan = plan
        self.specs = specs

    def local(self, coord) -> dict:
        """The views of every leaf that mesh coordinate ``coord`` holds."""
        return shard_mod.local_shards(self, self.specs, self.plan, coord)

    def bytes_per_device(self) -> int:
        return shard_mod.bytes_per_device(self, self.specs, self.plan)


def rescale_state(ckpt_dir: str, step: int, state_specs, new_mesh, mode: str = "train",
                  device=None):
    """Restore a checkpoint onto ``new_mesh`` (another worker count is
    fine): returns (:class:`ShardedState`, step). ``state_specs`` is the
    state's layout (a state, or ``train_state_specs`` on the meta device);
    the state lands on ``device``, the card by default. Onto a mesh over a
    process group: (this rank's ``sharding.RankState``, step)."""
    plan = shard_mod.make_plan(new_mesh, mode=mode)
    if getattr(new_mesh, "group", None) is not None:
        return checkpoint.restore(ckpt_dir, step, state_specs, device=resolve_device(device),
                                  plan=plan)
    state, step = checkpoint.restore(ckpt_dir, step, state_specs,
                                     device=resolve_device(device))
    return ShardedState(state, plan, shard_mod.state_specs(state, plan)), step


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
        new = out[0] if isinstance(out, tuple) else out
        slow = False
        if len(self.history) >= self.min_history:
            recent = self.history[-20:]
            slow = dt > self.factor * (sum(recent) / len(recent))
        if isinstance(new, shard_mod.RankState):  # rank 0's clock decides for every rank
            group = shard_mod.mesh_group(new.plan)
            slow = bool(fsdp.broadcast_ints([int(slow)], group,
                                            flatten(new)["opt/step"].device)[0])
        if slow:
            checkpoint.save(self.ckpt_dir, step_idx, new)
            self.emergency_saves += 1
            self.last_emergency_step = step_idx
        self.history.append(dt)
        return out
