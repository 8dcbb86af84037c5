"""Serving steps: prefill (one full-sequence forward) and decode (one token
for the whole batch). Sampling is greedy argmax; batching lives in
engine.py.

With ``plan`` (``sharding.make_plan(make_group_mesh(model=M), mode="serve")``,
or a train plan) each rank holds its shards of the parameters
(``sharding.shard_params``) and of the decode state
(``model.init_decode_state(B, T, plan=plan)``) and takes its rows of the
batch (``sharding.shard_batch``): at model axis 1 data-parallel serving
with no collective, above it tensor parallelism over "model" with the KV
cache's sequence split over the model ranks. A long-context state
(``init_decode_state(1, T, plan=plan, long_context=True)``, the
reference's batch-1 decode) splits the cache's sequence over every rank
of the mesh, each rank taking the whole batch. The next tokens are the
rank's rows'. ``ServeEngine`` stays unplanned, as the reference's."""

from __future__ import annotations

from typing import Callable

import torch

from .. import sharding as shard_mod
from ..models.model_zoo import Model

__all__ = ["make_serve_step", "make_prefill"]


def make_serve_step(model: Model, plan=None) -> Callable:
    """serve_step(params, state, {"token" (B, 1)}) -> (next token (B,) int32,
    state)."""
    def serve_step(params, state, batch):
        logits, state = model.decode_step(params, state, batch, plan=plan)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill(model: Model, plan=None) -> Callable:
    """prefill(params, state, batch) -> (next token (B,) int32, state). The
    batch is what :meth:`Model.forward` takes: "tokens" (B, S), plus
    "patch_embeds" for vlm or "enc_frames" for encdec.

    One full-sequence forward, which runs flash attention in every
    self-attention layer and the SSD-scan kernel in every Mamba layer. As in
    the reference, it builds no cache: it only sets ``length`` to S, so
    nothing can decode from its state; :class:`~repro_torch.serve.ServeEngine`
    prefills token by token. Unlike the reference, it unembeds only the last
    position: the same next token, without a (B, S, vocab) logits tensor.
    """
    def prefill(params, state, batch):
        hidden, _ = model.forward(params, batch, plan=plan)
        logits = model.unembed(params, hidden[:, -1:], plan=plan)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        new = dict(state)
        new["length"] = batch["tokens"].shape[1]
        state = (shard_mod.RankState(new, state.plan, state.specs)
                 if isinstance(state, shard_mod.RankState) else new)
        return nxt, state

    return prefill
