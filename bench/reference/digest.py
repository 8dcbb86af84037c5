"""Digests that let the benchmark hold every answer of a window to the
reference without keeping the answers or reading them on the host.

Each digest is a small int64 tensor computed where the columns lie, in a
few passes of 32-bit arithmetic over the columns as they are stored:
either a worker's padded ``(P, capacity)`` buffers with the live row
counts, or flat 1-D columns (the reference's, one "worker" holding every
row). Padding is never compacted away: it is masked out of the sums.

``row_digest`` does not depend on the order of the rows (a sum over rows
of a 32-bit mix of each row's column patterns), so the program's
partitions and the reference's sorted columns give the same number when
they hold the same rows. ``order_violations`` counts the adjacent pairs of
the flattened live sequence that are out of ascending order, so a
sequence that holds the reference's rows and reads 0 is the reference's
sorted sequence.
"""

from __future__ import annotations

import torch

INT32_MIN = -(2**31)
# the golden ratio's and murmur3's fmix32 constants, as int32
_C1 = -1640531535  # 0x9E3779B1
_C2 = -2048144789  # 0x85EBCA6B
_C3 = -1028477387  # 0xC2B2AE35


def bits64(v: torch.Tensor) -> torch.Tensor:
    """A 32-bit column's patterns as non-negative int64."""
    return bits32(v).to(torch.int64) & 0xFFFFFFFF


def bits32(v: torch.Tensor) -> torch.Tensor:
    """A 32-bit column's patterns as int32 (a float32 column's bits)."""
    if v.dtype == torch.float32:
        return v.view(torch.int32)
    if v.dtype != torch.int32:
        raise TypeError(f"digests take 32-bit columns, got {v.dtype}")
    return v


def padded(v: torch.Tensor, counts):
    """``v`` as ``(P, capacity)`` and its live counts (a flat column is one
    worker holding every row)."""
    if v.dim() == 1:
        v = v.reshape(1, -1)
    if counts is None:
        counts = torch.full((v.shape[0],), v.shape[1], dtype=torch.int64, device=v.device)
    return v, counts


def _valid(v: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    return torch.arange(v.shape[1], device=v.device)[None, :] < counts[:, None]


def row_digest(columns: dict, counts: torch.Tensor | None = None) -> torch.Tensor:
    """``[rows, digest]`` (int64) of the live rows of equal-shaped 32-bit
    columns, taken in name order; ``counts`` holds each worker's live rows
    of ``(P, capacity)`` columns, and is left out for flat ones. Each row
    mixes to ``h = fmix32((..((b0 * C1 + b1) * C1 + b2) * C1 ..))`` in
    wrapping int32 arithmetic with arithmetic shifts; the digest is the
    int64 sum of ``h`` over the live rows."""
    names = sorted(columns)
    first, counts = padded(columns[names[0]], counts)
    acc = bits32(first) * _C1
    for name in names[1:]:
        acc.add_(bits32(padded(columns[name], counts)[0])).mul_(_C1)
    acc.bitwise_xor_(acc >> 16).mul_(_C2)  # fmix32, with arithmetic shifts
    acc.bitwise_xor_(acc >> 13).mul_(_C3)
    acc.bitwise_xor_(acc >> 16)
    acc.mul_(_valid(acc, counts))
    return torch.stack([counts.sum().to(torch.int64), acc.sum(dtype=torch.int64)])


def order_violations(v: torch.Tensor, counts: torch.Tensor | None = None) -> torch.Tensor:
    """``[n]`` (int64): adjacent pairs of the live sequence, worker after
    worker, in which an int32 value is below the one before it."""
    v, counts = padded(v, counts)
    if v.shape[1] == 0:
        return torch.zeros(1, dtype=torch.int64, device=v.device)
    inner = ((v[:, 1:] < v[:, :-1]) & _valid(v, counts)[:, 1:]).sum(dtype=torch.int64)
    return (inner + across_workers(v, counts)).reshape(1)


def across_workers(v: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The pairs of ``order_violations`` that span two workers: a worker's
    first live value below the largest live value before it."""
    nonempty = counts > 0
    last = v.gather(1, (counts - 1).clamp(min=0).to(torch.int64)[:, None]).squeeze(1)
    floor = torch.full_like(last, INT32_MIN)
    seen = torch.cummax(torch.where(nonempty, last, floor), 0).values  # the largest so far
    before = torch.cat([floor[:1], seen[:-1]])
    return ((v[:, 0] < before) & nonempty).sum(dtype=torch.int64)
