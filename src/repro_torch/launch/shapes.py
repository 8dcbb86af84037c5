"""The launch grid's input shapes and their input stand-ins.

LM transformer shapes, as the reference's ``launch/shapes.py``:
  train_4k     seq 4096,    global_batch 256   -> train_step
  prefill_32k  seq 32768,   global_batch 32    -> prefill forward
  decode_32k   seq 32768,   global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288,  global_batch 1     -> serve_step; sub-quadratic
                                                  archs only

Where the reference builds ``jax.ShapeDtypeStruct``s, :func:`input_specs`
builds tensors on the ``meta`` device (or another device the caller names):
the same keys, shapes and dtypes, and on ``meta`` no memory.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig

__all__ = ["SHAPES", "ShapeCell", "input_specs", "cell_applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (SSM, hybrid, a sliding window
    or local/global layers)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str | ShapeCell, device="meta") -> dict:
    """Every model input of the cell as an uninitialised tensor on
    ``device``: "tokens" (B, S) int32, plus "patch_embeds" (vlm; the tokens
    then fill S - n_patches) or "enc_frames" (encdec) float32, and
    "labels"/"loss_mask" for train; a decode cell's one "token" (B, 1)."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = cell.global_batch, cell.seq_len

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if cell.kind in ("train", "prefill"):
        S_text = S
        specs: dict = {}
        if cfg.family == "vlm" and cfg.n_patches:
            S_text = S - cfg.n_patches
            specs["patch_embeds"] = spec((B, cfg.n_patches, cfg.d_model), torch.float32)
        if cfg.family == "encdec":
            specs["enc_frames"] = spec((B, cfg.enc_positions, cfg.d_model), torch.float32)
        specs["tokens"] = spec((B, S_text), torch.int32)
        if cell.kind == "train":
            specs["labels"] = spec((B, S), torch.int32)
            specs["loss_mask"] = spec((B, S), torch.float32)
        return specs

    # decode: one new token against a cache of length S
    return {"token": spec((B, 1), torch.int32)}
