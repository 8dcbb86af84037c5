"""Chunked cross-entropy: never materialises the full (tokens x vocab)
logits tensor.

The sequence is cut into chunks; each chunk computes its logits against the
embedding in the compute dtype, the final softcap, a float32 logsumexp and
the label logit. Each chunk runs under ``torch.utils.checkpoint``, so the
backward recomputes its logits and only one chunk's logits live at a time
(olmo-1b, 4 x 512 positions x 50,304: 0.41 GB in float32).

With the vocabulary split over a plan's model axis (``tp``: the
reference's vocab-sharded loss, when V divides the model axis) each rank
computes its block of the logits from f(hidden) and the logsumexp's max,
its sum of exponentials and the gold logit are all-reduced over the model
ranks (the max without a gradient; the sum and the gold logit as *g*), the
softcap before them. A hidden state already gathered from a
sequence-split stream by ``fsdp.gather_seq`` (``entered``) is *f*'s
output: the chunks take it as it is.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import sharding as shard_mod
from ..core.comm import fsdp
from ..models import tp as tp_mod
from ..models.common import softcap

__all__ = ["chunked_cross_entropy"]


def _chunk_nll(h: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               final_softcap: float | None) -> torch.Tensor:
    logits = torch.einsum("bcd,vd->bcv", h, emb)
    logits = softcap(logits, final_softcap).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((lse - gold) * mask)


def _chunk_nll_tp(h: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                  final_softcap: float | None, tp, entered: bool) -> torch.Tensor:
    """:func:`_chunk_nll` with ``emb`` this rank's block of the vocabulary
    (``entered``: ``h`` is already *f*'s output)."""
    hf = h if entered else fsdp.copy_to_model(h, tp.group)
    logits = torch.einsum("bcd,vd->bcv", hf, emb)
    logits = softcap(logits, final_softcap).float()
    m = fsdp.all_reduce(logits.amax(dim=-1), tp.group, op="max")
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    lse = m + torch.log(fsdp.reduce_from_model(se, tp.group))
    lo, hi = tp_mod.rank_block(emb.shape[0] * tp.size, tp)
    local = labels - lo
    inside = (local >= 0) & (local < hi - lo)
    gold = torch.gather(logits, -1, local.clamp(0, hi - lo - 1)[..., None])[..., 0]
    gold = fsdp.reduce_from_model(torch.where(inside, gold, 0.0), tp.group)
    return torch.sum((lse - gold) * mask)


def chunked_cross_entropy(hidden: torch.Tensor, embedding: torch.Tensor, labels: torch.Tensor,
                          loss_mask: torch.Tensor, chunk: int = 512,
                          final_softcap: float | None = None, plan=None, tp=None,
                          entered: bool = False):
    """(mean nll over the masked tokens, number of masked tokens), both
    float32 scalars. With ``plan`` (a train plan over a process group) the
    inputs are this rank's rows, the count is every rank's, and the mean is
    this rank's share of the global mean: its nll sum over the global
    count, which summed over the ranks is the global mean.

    Args:
      hidden: (B, S, d) in the compute dtype.
      embedding: (V, d), cast to the compute dtype.
      labels: (B, S) integer.
      loss_mask: (B, S) of 0 and 1.
      chunk: positions per chunk; S must be a multiple of ``S // (S //
        chunk)``.
      final_softcap: ``c * tanh(logits / c)`` before the softmax.
      tp: the plan's model axis when ``embedding`` is this rank's block of
        the vocabulary (the module's notes); None: the whole vocabulary.
      entered: ``hidden`` comes from ``fsdp.gather_seq`` (with ``tp``).
    """
    B, S, _ = hidden.shape
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    emb = embedding.to(hidden.dtype)
    labels = labels.long()
    mask = loss_mask.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        if tp is None:
            nll = checkpoint(_chunk_nll, hidden[:, sl], emb, labels[:, sl], mask[:, sl],
                             final_softcap, use_reentrant=False)
        else:
            nll = checkpoint(_chunk_nll_tp, hidden[:, sl], emb, labels[:, sl], mask[:, sl],
                             final_softcap, tp, entered, use_reentrant=False)
        nll_sum = nll_sum + nll
    tok_sum = torch.sum(mask)
    group = shard_mod.data_group(plan)
    if group is not None:
        tok_sum = fsdp.all_reduce(tok_sum, group)
    return nll_sum / torch.clamp(tok_sum, min=1.0), tok_sum
