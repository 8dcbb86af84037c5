"""AdamW: float32 moments in the parameters' layout, global-norm gradient
clipping, decoupled weight decay, a warmup + cosine schedule.

The arithmetic is the reference's, in float32: the schedule and the bias
corrections ``b ** step`` are computed on float32 tensors, not in Python
floats. Weight decay applies to every parameter with ``ndim >= 2`` in the
stacked layout, so a stacked norm scale (n_layers, d) is decayed, as in the
reference. The update is in place under ``torch.no_grad()`` (the
counterpart of the reference's donated train state); the call shape
``params, opt, metrics = adamw_update(cfg, params, grads, opt)`` is the
reference's, and returns the same dicts.

Over a process group (``plan``, with the whole leaves' ``specs``) every
leaf is this rank's shard in its leaf's shape, so the decay rule sees the
leaf's true rank and the update is the same elementwise arithmetic; only
the gradient norm crosses ranks: each leaf's sum of squares, a replicated
leaf's from the first rank that holds each of its shards alone (a leaf
the plan does not split over "model" counted once), summed over the mesh's
ranks in one all-reduce and then added up in leaf order, as on one card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import sharding as shard_mod
from ..core.comm import fsdp
from ..tree import leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def adamw_init(params: dict) -> dict:
    """{"mu", "nu"}: float32 zeros in the parameters' layout; "step": an
    int32 scalar 0, on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor): linear warmup over
    ``warmup_steps``, then a cosine from ``lr`` down to ``min_lr_ratio *
    lr`` at ``total_steps``; float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: dict, plan=None, specs: dict | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32. With ``plan``
    (over a process group), ``tree`` holds this rank's shards of leaves
    laid out by ``specs`` and the norm is the whole tree's."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    group = shard_mod.mesh_group(plan)
    if group is not None:
        first = [shard_mod.first_holder(s, plan) for s in leaves(specs)]
        sums = torch.stack([v if keep else torch.zeros_like(v)
                            for v, keep in zip(sums, first)])
        sums = fsdp.all_reduce(sums, group).unbind()
    total = 0
    for v in sums:
        total = total + v
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict, plan=None,
                 specs: dict | None = None):
    """One AdamW step, in place: returns (params, state, {"grad_norm",
    "lr"}), the same ``params`` and ``state`` dicts updated. With ``plan``,
    the trees hold this rank's shards of leaves laid out by ``specs`` (the
    parameters' storage specs)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, plan, specs)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                            leaves(state["nu"])):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if p.ndim >= 2:  # no decay on norms and scalars
            delta = delta + cfg.weight_decay * p.float()
        p.sub_((lr * delta).to(p.dtype))
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
