"""The digests of ``reference.digest``, fused on the card.

On a CUDA device each digest is one Triton pass over a DDF's padded
columns (read once, 4 bytes a value) in place of the plain definition's
twenty-odd PyTorch passes, so the harness's own work inside the window
stays a small share of it; the program's answers and the reference's go
through the same function. Elsewhere, and for more than ``MAX_COLS``
columns, the plain definition runs. ``bench/tests`` holds the two equal on
the card. Triton is imported, and its kernels built, at the first call.
"""

from __future__ import annotations

import functools

import torch

from reference import digest as plain

MAX_COLS = 8
BLOCK = 4096


@functools.cache
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["cap"])
    def rows(p0, p1, p2, p3, p4, p5, p6, p7, counts, cap, part, NCOLS: tl.constexpr,
             BLOCK: tl.constexpr):
        w = tl.program_id(0)
        b = tl.program_id(1)
        offs = b * BLOCK + tl.arange(0, BLOCK)
        m = offs < tl.load(counts + w)
        at = w.to(tl.int64) * cap + offs
        acc = tl.load(p0 + at, mask=m, other=0) * -1640531535
        if NCOLS > 1:
            acc = (acc + tl.load(p1 + at, mask=m, other=0)) * -1640531535
        if NCOLS > 2:
            acc = (acc + tl.load(p2 + at, mask=m, other=0)) * -1640531535
        if NCOLS > 3:
            acc = (acc + tl.load(p3 + at, mask=m, other=0)) * -1640531535
        if NCOLS > 4:
            acc = (acc + tl.load(p4 + at, mask=m, other=0)) * -1640531535
        if NCOLS > 5:
            acc = (acc + tl.load(p5 + at, mask=m, other=0)) * -1640531535
        if NCOLS > 6:
            acc = (acc + tl.load(p6 + at, mask=m, other=0)) * -1640531535
        if NCOLS > 7:
            acc = (acc + tl.load(p7 + at, mask=m, other=0)) * -1640531535
        acc = (acc ^ (acc >> 16)) * -2048144789
        acc = (acc ^ (acc >> 13)) * -1028477387
        acc = acc ^ (acc >> 16)
        acc = tl.where(m, acc, 0)
        tl.store(part + w * tl.num_programs(1) + b, tl.sum(acc.to(tl.int64), axis=0))

    @triton.jit(do_not_specialize=["cap"])
    def order(p, counts, cap, part, BLOCK: tl.constexpr):
        w = tl.program_id(0)
        b = tl.program_id(1)
        offs = b * BLOCK + tl.arange(0, BLOCK)
        m = (offs < tl.load(counts + w)) & (offs >= 1)
        at = w.to(tl.int64) * cap + offs
        v = tl.load(p + at, mask=m, other=0)
        prev = tl.load(p + at - 1, mask=m, other=0)
        bad = (v < prev) & m
        tl.store(part + w * tl.num_programs(1) + b, tl.sum(bad.to(tl.int64), axis=0))

    return rows, order


def _launch(kernel, cols, counts, **meta) -> torch.Tensor:
    P, cap = cols[0].shape
    nb = -(-cap // BLOCK)
    part = torch.empty(P * nb, dtype=torch.int64, device=cols[0].device)
    kernel[(P, nb)](*cols, counts, cap, part, BLOCK=BLOCK, **meta)
    return part.sum()


def _fused(first: torch.Tensor, n_cols: int) -> bool:
    return first.device.type == "cuda" and first.numel() > 0 and n_cols <= MAX_COLS


def row_digest(columns: dict, counts: torch.Tensor | None = None) -> torch.Tensor:
    """``reference.digest.row_digest``, one pass on the card."""
    names = sorted(columns)
    if not _fused(columns[names[0]], len(names)):
        return plain.row_digest(columns, counts)
    first, counts = plain.padded(columns[names[0]], counts)
    cols = [plain.bits32(plain.padded(columns[n], counts)[0]).contiguous() for n in names]
    pad = [cols[0]] * (MAX_COLS - len(cols))
    total = _launch(_kernels()[0], cols + pad, counts, NCOLS=len(cols))
    return torch.stack([counts.sum().to(torch.int64), total])


def order_violations(v: torch.Tensor, counts: torch.Tensor | None = None) -> torch.Tensor:
    """``reference.digest.order_violations``, one pass on the card."""
    if not _fused(v, 1):
        return plain.order_violations(v, counts)
    v, counts = plain.padded(v, counts)
    v = v.contiguous()
    inner = _launch(_kernels()[1], [v], counts)
    return (inner + plain.across_workers(v, counts)).reshape(1)
