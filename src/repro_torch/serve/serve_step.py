"""Serving steps: prefill (one full-sequence forward) and decode (one token
for the whole batch). Sampling is greedy argmax; batching lives in
engine.py."""

from __future__ import annotations

from typing import Callable

import torch

from ..models.model_zoo import Model

__all__ = ["make_serve_step", "make_prefill"]


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, state, {"token" (B, 1)}) -> (next token (B,) int32,
    state)."""

    def serve_step(params, state, batch):
        logits, state = model.decode_step(params, state, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill(model: Model) -> Callable:
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
        hidden, _ = model.forward(params, batch)
        logits = model.unembed(params, hidden[:, -1:])[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        state = dict(state)
        state["length"] = batch["tokens"].shape[1]
        return nxt, state

    return prefill
