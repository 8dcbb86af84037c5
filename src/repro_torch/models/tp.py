"""Tensor parallelism over a plan's model axis: the layouts a layer finds its
shards in, the Megatron *f* / *g* pair, and the vocabulary-parallel
embedding and unembedding.

A layer whose weights the plan splits the Megatron way (column-split
inputs, row-split output) runs its part: *f* (:func:`enter`) on the input,
the rank's columns, then *g* (:func:`leave`) on the row-split product. The
pair follows the residual stream's layout (``ModelAxis.seq``): where every
model rank holds its rows' stream whole, *f* is ``fsdp.copy_to_model`` and
*g* ``fsdp.reduce_from_model``; where the stream is split along the
sequence (the reference's ``act_seq``), *f* all-gathers the sequence
(``fsdp.gather_seq``) and *g* reduce-scatters it (``fsdp.scatter_seq``).
Where a layer's specs do not give that layout (a dim that does not divide
falls back to another candidate, or to none), the layer gathers its split
leaves whole (:func:`gather_split`) and runs unsplit on every rank, the
same values, on the whole stream (:func:`whole`), keeping its rank's block
of the output (:func:`own`).

Which dim of each leaf the plan splits over "model" comes from the plan's
specs: a layer is handed a ``sharding.ModelAxis`` whose ``dims`` are its
leaves'.
"""

from __future__ import annotations

import torch

from ..core.comm import fsdp

__all__ = ["enter", "leave", "whole", "own", "stream_norm", "stream_params", "gather_split",
           "rank_block", "embed_lookup", "unembed_logits", "rms_scale"]


def enter(x: torch.Tensor, tp) -> torch.Tensor:
    """*f*: the stream ``x`` as the input of a column-split product, whole
    on every rank; the backward sums the ranks' partial cotangents (an
    all-reduce, or a reduce-scatter to the rank's block of a split
    stream)."""
    if tp.seq:
        return fsdp.gather_seq(x, tp.group)
    return fsdp.copy_to_model(x, tp.group)


def leave(y: torch.Tensor, tp) -> torch.Tensor:
    """*g*: the ranks' partial outputs ``y`` (B, S, ...) summed, whole on
    every rank or, on a split stream, the rank's block of the sequence."""
    if tp.seq:
        return fsdp.scatter_seq(y, tp.group)
    return fsdp.reduce_from_model(y, tp.group)


def whole(x: torch.Tensor, tp) -> torch.Tensor:
    """The stream ``x`` whole on every rank, for work every rank does whole:
    a split stream all-gathered (the backward takes the rank's block),
    else ``x``."""
    if tp is not None and tp.seq:
        return fsdp.gather_whole(x, 1, tp.group)
    return x


def own(y: torch.Tensor, tp) -> torch.Tensor:
    """The inverse of :func:`whole` for an output every rank computed whole:
    the rank's block of a split stream (the backward all-gathers), else
    ``y``."""
    if tp is not None and tp.seq:
        return fsdp.split_seq(y, tp.group)
    return y


def stream_norm(norm: dict, tp) -> dict:
    """A norm's leaves (scale, bias), which act on the stream token by
    token: on a split stream each rank's gradient covers its positions
    only, so each leaf goes through ``fsdp.copy_to_model`` (the backward
    sums over the model ranks); otherwise ``norm`` itself."""
    if tp is None or not tp.seq:
        return norm
    return {k: fsdp.copy_to_model(v, tp.group) for k, v in norm.items()}


def stream_params(tree: dict, tp) -> dict:
    """A layer's parameters with its norms (``ln*``) through
    :func:`stream_norm`."""
    if tp is None or not tp.seq:
        return tree
    return {k: stream_norm(v, tp) if k.startswith("ln") else v for k, v in tree.items()}


def gather_split(tree: dict, tp) -> dict:
    """Every leaf of ``tree`` (a layer's parameters) whole on every rank:
    a leaf that ``tp.dims`` splits over the model ranks is all-gathered (the
    backward takes the rank's slice: each rank then computes with the whole
    leaf), the others are as they are."""
    out = {}
    for k, v in tree.items():
        dim = tp.dims[k]
        if isinstance(v, dict):
            out[k] = gather_split(v, tp.sub(k))
        else:
            out[k] = v if dim is None else fsdp.gather_whole(v, dim, tp.group)
    return out


def rank_block(n_whole: int, tp) -> tuple[int, int]:
    """[lo, hi) of this rank's block of a dim of ``n_whole`` split evenly."""
    n = n_whole // tp.size
    return tp.rank * n, (tp.rank + 1) * n


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor, dtype, tp,
                 split: bool = False) -> torch.Tensor:
    """The rows of ``tokens`` in ``dtype``: a lookup of the whole table, or,
    with the vocabulary split over the model ranks (``tp.dims`` 0, the
    table's axis), of the rank's rows (zeros for the others' tokens) summed
    over the ranks. With ``split``, this rank's block of the sequence of
    them (``tp``'s group: the model ranks): the sum reduce-scattered, a
    whole table's rows cut to the block."""
    if tp is None or tp.dims is None:
        rows = emb.to(dtype)[tokens]
        return fsdp.split_seq(rows, tp.group) if split else rows
    lo, hi = rank_block(emb.shape[0] * tp.size, tp)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = torch.where(inside[..., None], emb.to(dtype)[local.clamp(0, hi - lo - 1)], 0)
    if split:
        return fsdp.scatter_seq(rows, tp.group)
    return fsdp.reduce_from_model(rows, tp.group)


def unembed_logits(h: torch.Tensor, emb: torch.Tensor, tp) -> torch.Tensor:
    """h (..., d) against the embedding: the whole logits, each rank's block
    of the vocabulary all-gathered where the table is split (``tp``: the
    table's axis)."""
    if tp is None or tp.dims is None:
        return h @ emb.to(h.dtype).T
    logits = fsdp.copy_to_model(h, tp.group) @ emb.to(h.dtype).T
    return fsdp.gather_whole(logits, logits.dim() - 1, tp.group)


def rms_scale(y: torch.Tensor, scale: torch.Tensor, tp, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the channels that the model ranks split: y (..., C/M) is
    this rank's block, ``scale`` (C,) the whole (replicated) scale. The sum
    of squares is all-reduced (its backward sums the ranks' cotangents), the
    scale's gradient summed over the ranks; float32, cast back to y's
    dtype."""
    yf = y.float()
    n = y.shape[-1] * tp.size
    ss = fsdp.all_reduce_sum(torch.sum(yf * yf, dim=-1, keepdim=True), tp.group)
    lo, hi = rank_block(n, tp)
    s = fsdp.copy_to_model(scale, tp.group)[lo:hi]
    return (yf * torch.rsqrt(ss / n + eps) * s).to(y.dtype)
