"""Point-to-point channels (paper §3.2) over the P workers of one card.

The reference moves fixed-size buffers between devices with
``jax.lax.ppermute``. Here every worker's buffer is one slice of the
leading dimension, so a permutation is an indexing of that dimension:

- ``shift``: every worker sends to rank + offset (mod P) and receives from
  rank - offset -- the building block of the halo exchange (§5.3.6);
- ``send_recv``: any permutation of (src, dst) pairs; a rank that receives
  nothing gets zeros, as a channel with no matching send;
- ``halo_exchange``: ring-neighbour halos without wrap-around; the edge
  workers receive zeros.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["shift", "send_recv", "halo_exchange"]


def shift(x: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """(P, ...) -> (P, ...): worker r receives worker r - offset's slice
    (mod P)."""
    return torch.roll(x, offset, dims=0)


def send_recv(x: torch.Tensor, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """General p2p over (src, dst) pairs; ranks that receive nothing get
    zeros."""
    out = torch.zeros_like(x)
    for src, dst in perm:
        out[dst] = x[src]
    return out


def halo_exchange(tail: torch.Tensor, head: torch.Tensor):
    """Exchange boundary halos with the ring neighbours (no wrap-around).

    ``tail``: each worker's last rows (sent right), ``head``: its first rows
    (sent left), both (P, ...). Returns (left_halo, right_halo): the
    previous worker's tail and the next worker's head; worker 0's left halo
    and worker P-1's right halo are zeros."""
    left = torch.zeros_like(tail)
    right = torch.zeros_like(head)
    left[1:] = tail[:-1]
    right[:-1] = head[1:]
    return left, right
