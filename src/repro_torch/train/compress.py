"""Gradient compression for a data-parallel all-reduce: int8 quantisation
with error feedback.

Per-worker gradients are quantised to int8 against one scale shared by all
workers (from the max over every worker), summed in int32 and dequantised;
each worker keeps its own quantisation residual for the next step. On one
card the P workers are a leading dimension (P, ...) of each gradient: the
reference's ``pmax`` and ``psum`` over the mesh axis become a max and a sum
over that dimension. Over a process group (``group=``) each rank is one
worker and holds its own gradients: they become an all-reduce MAX of the
amax and an all-reduce SUM of the int32 payloads, the same arithmetic, so
the same bits as the one-card form at P = world.
"""

from __future__ import annotations

import torch

from ..core.comm import fsdp
from ..tree import tree_map

__all__ = ["quantize", "dequantize", "compressed_psum", "init_error_feedback"]


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Floats -> (int8, float32 scale), symmetric per tensor."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _one(g: torch.Tensor, e: torch.Tensor | None = None):
    P = g.shape[0]
    g32 = g.float() + (e if e is not None else 0.0)
    # one scale for every worker, so the int8 payloads are commensurable and
    # the int32 sum is exact
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_e = g32 - q.float() * scale  # each worker's residual
    qsum = q.to(torch.int32).sum(dim=0)
    return qsum.float() * scale / P, new_e


def _one_rank(group, g: torch.Tensor, e: torch.Tensor | None = None):
    world, _ = fsdp.world_and_rank(group)
    g32 = g.float() + (e if e is not None else 0.0)
    scale = torch.clamp(fsdp.all_reduce(g32.abs().max(), group, op="max"), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_e = g32 - q.float() * scale
    qsum = fsdp.all_reduce(q.to(torch.int32), group)
    return qsum.float() * scale / world, new_e


def compressed_psum(grads: dict, error: dict | None = None, group=None):
    """Mean over the leading worker dimension of every gradient (P, ...),
    through int8 payloads: returns (mean grads (...), new error (P, ...)).
    ``error`` is the previous call's residual tree, or None. With ``group``
    (a process group) each leaf is this rank's worker's gradient (...) and
    the mean is over the ranks; the error is this rank's (...)."""
    one = _one if group is None else (lambda g, e=None: _one_rank(group, g, e))
    pairs = tree_map(one, grads) if error is None else tree_map(one, grads, error)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def init_error_feedback(grads: dict) -> dict:
    """float32 zeros in the layout of ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
