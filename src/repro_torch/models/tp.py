"""Tensor parallelism over a plan's model axis: the layouts a layer finds its
shards in, and the vocabulary-parallel embedding and unembedding.

Every model rank holds its rows' residual stream whole. A layer whose
weights the plan splits the Megatron way (column-split inputs, row-split
output) runs its part: ``fsdp.copy_to_model`` (*f*) on the input, the
rank's columns, then ``fsdp.reduce_from_model`` (*g*) on the row-split
product. Where a layer's specs do not give that layout (a dim that does
not divide falls back to another candidate, or to none), the layer
gathers its split leaves whole (:func:`gather_split`) and runs unsplit on
every rank, the same values.

Which dim of each leaf the plan splits over "model" comes from the plan's
specs: a layer is handed a ``sharding.ModelAxis`` whose ``dims`` are its
leaves'.
"""

from __future__ import annotations

import torch

from ..core.comm import fsdp

__all__ = ["gather_split", "rank_block", "embed_lookup", "unembed_logits",
           "rms_scale"]


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


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor, dtype, tp) -> torch.Tensor:
    """The rows of ``tokens`` in ``dtype``: a lookup of the whole table, or,
    with the vocabulary split over the model ranks (``tp.dims`` 0, the
    table's axis), of the rank's rows (zeros for the others' tokens) summed
    over the ranks."""
    if tp is None or tp.dims is None:
        return emb.to(dtype)[tokens]
    lo, hi = rank_block(emb.shape[0] * tp.size, tp)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = emb.to(dtype)[local.clamp(0, hi - lo - 1)]
    return fsdp.reduce_from_model(torch.where(inside[..., None], rows, 0), tp.group)


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
