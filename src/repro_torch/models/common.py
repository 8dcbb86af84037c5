"""Shared model primitives: initializer, norms, rotary embeddings, softcap.

Parameters are float32 tensors in nested dicts with the reference's names
and shapes; each op casts them to the activation dtype at use, as the
reference does.
"""

from __future__ import annotations

import torch

__all__ = ["dense_init", "norm_init", "norm_apply", "rope", "apply_rope", "softcap"]


def dense_init(gen: torch.Generator, shape, in_axis: int = 0, *,
               device: torch.device | str) -> torch.Tensor:
    """Truncated-normal fan-in init in [-2, 2] standard deviations, float32
    (``src/repro/models/common.py:12``). ``gen`` lives on ``device``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t.mul_(1.0 / float(shape[in_axis]) ** 0.5)


def norm_init(kind: str, d: int, *, device: torch.device | str) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones(d, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(d, device=device), "bias": torch.zeros(d, device=device)}
    if kind == "nonparametric":
        return {}
    raise ValueError(kind)


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMS or layer norm over the last axis, in float32, cast back to x's
    dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * p["scale"]).to(x.dtype)
    if kind in ("layernorm", "nonparametric"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            xf = xf * p["scale"] + p["bias"]
        return xf.to(x.dtype)
    raise ValueError(kind)


def rope(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> cos, sin of shape (..., S, head_dim / 2),
    float32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, head_dim), cos/sin (..., S, half): rotate-half form, the
    rotation in x's dtype (cos/sin cast), as the reference does."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
