"""Dense MLP variants (SwiGLU / GeGLU / GELU).

Over a plan's model axis (``tp``) ``w_gate``/``w_up`` are split over d_ff's
columns and ``w_down`` over its rows: f(x), the rank's columns, its rows'
partial product, then the sum over the ranks (*g*; both follow the
stream's layout, ``models.tp``). Whole weights run on the whole stream."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import tp as tp_mod
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


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d) in x's dtype. GELU is the tanh form, as
    ``jax.nn.gelu(approximate=True)`` computes it. With ``tp`` (a
    ``sharding.ModelAxis`` for ``p``), ``p`` holds this rank's shards over
    the model axis."""
    if tp is not None and tp.dims["w_up"] is not None:
        return tp_mod.leave(_mlp(p, tp_mod.enter(x, tp), cfg), tp)
    return tp_mod.own(_mlp(p, tp_mod.whole(x, tp), cfg), tp)


def _mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(x @ p["w_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt)
