"""Batched serving engine: static batch, greedy decode."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models.model_zoo import Model
from .serve_step import make_serve_step

__all__ = ["ServeEngine"]


@dataclasses.dataclass
class ServeEngine:
    model: Model
    params: dict
    max_len: int = 256

    def __post_init__(self):
        self._step = make_serve_step(self.model)

    def generate(self, prompts: Sequence[Sequence[int]], max_new: int = 32) -> list[list[int]]:
        """Greedy-decode a batch of token prompts, prefilling token by token.

        Prompts may differ in length: each lane feeds its own next token
        every step, a prompt token while it is still prefilling and its last
        generated token afterwards, so every lane's output equals a solo run
        of its prompt.
        """
        B = len(prompts)
        if any(len(p) == 0 for p in prompts):
            raise ValueError("every prompt must contain at least one token")
        lens = [len(p) for p in prompts]
        maxp = max(lens)
        toks = np.zeros((B, maxp), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
        outs = [list(p) for p in prompts]
        ngen = [0] * B
        feed = toks[:, 0].copy()
        device = self.model.device
        with torch.inference_mode():
            # encdec: no audio, so enc_out stays the state's bf16 zeros, the
            # reference engine's zero encoder output
            state = self.model.init_decode_state(B, self.max_len)
            # after the step that consumed lane i's token at position t, the
            # argmax is lane i's token for position t + 1: a later prompt
            # token (ignored, the real one is fed) or a generated one
            for t in range(maxp + max_new - 1):
                nxt, state = self._step(self.params, state,
                                        {"token": torch.from_numpy(feed[:, None]).to(device)})
                nxt = nxt.cpu().numpy()
                for i in range(B):
                    if t + 1 < lens[i]:
                        feed[i] = toks[i, t + 1]
                    else:
                        if ngen[i] < max_new:
                            outs[i].append(int(nxt[i]))
                            ngen[i] += 1
                        feed[i] = nxt[i]
        return outs
