"""Dense MLP variants (SwiGLU / GeGLU / GELU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init
from .config import ModelConfig

__all__ = ["mlp_init", "mlp_forward"]


def mlp_init(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d, ff), device=device),
            "w_up": dense_init(gen, (d, ff), device=device),
            "w_down": dense_init(gen, (ff, d), device=device),
        }
    return {"w_up": dense_init(gen, (d, ff), device=device),
            "w_down": dense_init(gen, (ff, d), device=device)}


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) in x's dtype. GELU is the tanh form, as
    ``jax.nn.gelu(approximate=True)`` computes it."""
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)
