"""Model registry: config -> a bundle of the model's functions on one device
(or on one rank's device of a process group, under a sharding plan)."""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import transformer
from .config import ModelConfig

__all__ = ["Model", "build_model", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init_params(self, gen: torch.Generator) -> dict:
        """Random float32 parameters from ``gen``, a generator on this
        model's device."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        return transformer.init_params(gen, self.cfg)

    def forward(self, params: dict, batch: dict, remat: bool = False, plan=None,
                gather_out: bool = True):
        """(params, batch) -> (hidden (B, S', d), MoE aux loss). The batch
        holds "tokens" (B, S), plus "patch_embeds" (B, n_patches, d) for
        vlm (then S' = n_patches + S) or "enc_frames" (B, T, d) for
        encdec. ``remat`` recomputes each layer in the backward (the train
        step's setting). With ``plan`` (a train or serve plan over a
        process group) ``params`` are this rank's shards and ``batch`` its
        rows; ``gather_out=False`` leaves a sequence-split stream split
        (``transformer.forward``)."""
        return transformer.forward(params, batch, self.cfg, remat, plan, gather_out)

    def param_shapes(self) -> dict:
        """The tree of the whole parameters' shapes (no memory allocated)."""
        return transformer.param_shapes(self.cfg)

    def unembed(self, params: dict, h: torch.Tensor, plan=None) -> torch.Tensor:
        return transformer.unembed(params, h, self.cfg, plan)

    def decode_step(self, params: dict, state: dict, batch: dict, plan=None):
        """(params, state, {"token" (B, 1)}) -> (logits (B, V), state). With
        ``plan``, the rank's shards, rows and decode state."""
        return transformer.decode_step(params, state, batch, self.cfg, plan)

    def init_decode_state(self, batch: int, max_len: int, dtype=torch.bfloat16,
                          plan=None, long_context: bool = False) -> dict:
        """The decode state of ``batch`` rows; with ``plan``, this rank's
        shards of it (``long_context``: the KV cache's positions over the
        whole mesh, for the reference's batch-1 decode)."""
        return transformer.init_decode_state(self.cfg, batch, max_len, dtype,
                                             device=self.device, plan=plan,
                                             long_context=long_context)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (default: the card)."""
    transformer.check_family(cfg)
    return Model(cfg=cfg, device=resolve_device(device))
