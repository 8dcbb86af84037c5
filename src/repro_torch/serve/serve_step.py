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
    """prefill(params, state, {"tokens" (B, S)}) -> (next token (B,) int32,
    state).

    One full-sequence forward, which runs the SSD-scan kernel in every Mamba
    layer and flash attention in every shared-block call. As in the
    reference, it builds no cache: it only sets ``length``, so nothing can
    decode from its state; :class:`~repro_torch.serve.ServeEngine` prefills
    token by token.
    """

    def prefill(params, state, batch):
        hidden, _ = model.forward(params, batch)
        logits = model.unembed(params, hidden)[:, -1]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        state = dict(state)
        state["length"] = batch["tokens"].shape[1]
        return nxt, state

    return prefill
