"""Point-to-point channels (paper §3.2) over the P workers.

The reference moves fixed-size buffers between devices with
``jax.lax.ppermute``. Here every worker's buffer is one slice of the
leading dimension, and a permutation of the global worker axis is the
block's ``permute_workers`` (``group.WorkerBlock``): an indexing of that
dimension on one card, a collective over a process group:

- ``shift``: every worker sends to rank + offset (mod P) and receives from
  rank - offset -- the building block of the halo exchange (§5.3.6);
- ``send_recv``: any permutation of (src, dst) pairs; a rank that receives
  nothing gets zeros, as a channel with no matching send;
- ``halo_exchange``: ring-neighbour halos without wrap-around; the edge
  workers receive zeros.

Each takes and returns ``(local, ...)`` tensors, one slice per worker held
(all P on one card).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .group import WorkerBlock, block_of

__all__ = ["shift", "send_recv", "halo_exchange"]


def shift(x: torch.Tensor, offset: int = 1, workers: WorkerBlock | None = None) -> torch.Tensor:
    """(P, ...) -> (P, ...): worker r receives worker r - offset's slice
    (mod P)."""
    return block_of(workers, x).permute_workers(x, offset)


def send_recv(x: torch.Tensor, perm: Sequence[tuple[int, int]],
              workers: WorkerBlock | None = None) -> torch.Tensor:
    """General p2p over (src, dst) pairs of global ranks; ranks that
    receive nothing get zeros. A pair whose two ranks lie ``d`` apart
    travels in the shift by ``d``."""
    block = block_of(workers, x)
    out = torch.zeros_like(x)
    for d in sorted({(dst - src) % block.nworkers for src, dst in perm}):
        moved = block.permute_workers(x, d)
        for src, dst in perm:
            if (dst - src) % block.nworkers == d and block.lo <= dst < block.hi:
                out[dst - block.lo] = moved[dst - block.lo]
    return out


def halo_exchange(tail: torch.Tensor, head: torch.Tensor,
                  workers: WorkerBlock | None = None):
    """Exchange boundary halos with the ring neighbours (no wrap-around).

    ``tail``: each worker's last rows (sent right), ``head``: its first rows
    (sent left), both (P, ...). Returns (left_halo, right_halo): the
    previous worker's tail and the next worker's head; worker 0's left halo
    and worker P-1's right halo are zeros."""
    block = block_of(workers, tail)
    g = block.local_ids()
    edge = (1,) * (tail.dim() - 1)
    left = block.permute_workers(tail, 1)
    right = block.permute_workers(head, -1)
    left = torch.where((g > 0).view(-1, *edge), left, torch.zeros_like(left))
    right = torch.where((g < block.nworkers - 1).view(-1, *edge), right, torch.zeros_like(right))
    return left, right
