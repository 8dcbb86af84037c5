"""GQA attention: full-sequence self-attention (through the flash-attention
kernel), cross-attention and single-token cached decode (plain PyTorch).

``attention`` computes q/k/v and rope, then calls ``ops.flash_attention``,
which takes the place of both the reference's dense einsum branch and its
chunked online-softmax path (``src/repro/models/attention.py:56-178``), so
any S works. Cross-attention (``kv_x``) takes K/V from another sequence of
its own length, which the kernel's contract (one S for q and k/v) does not
cover: it stays the reference's dense einsum, softmax, einsum, with the
probabilities rounded to the activation dtype before the PV product.

The decode cache is bf16 (or the caller's dtype), or int8 with a float32
scale per (token, head): symmetric quantisation, round to nearest even,
clipped to +-127 (``quantize_kv``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
from .common import apply_rope, dense_init, rope, softcap
from .config import ModelConfig

__all__ = ["attn_init", "attention", "attention_decode", "init_kv_cache", "KVCache",
           "quantize_kv"]


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, H, hd), device=device),
        "wk": dense_init(gen, (d, KV, hd), device=device),
        "wv": dense_init(gen, (d, KV, hd), device=device),
        "wo": dense_init(gen, (H, hd, d), device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), device=device)
        p["bk"] = torch.zeros((KV, hd), device=device)
        p["bv"] = torch.zeros((KV, hd), device=device)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, kv_x: torch.Tensor | None = None):
    """q from x; k and v from ``kv_x`` (cross-attention) or x."""
    dt = x.dtype
    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    if cfg.query_scale is not None:
        return cfg.query_scale ** -0.5
    return cfg.head_dim ** -0.5


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
              window: int | None = None, positions: torch.Tensor | None = None,
              kv_x: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention, x (B, S, d) -> (B, S, d). With ``kv_x``
    (B, S_kv, d), cross-attention: K/V from ``kv_x``, no rope, no mask."""
    if kv_x is not None:
        return _cross_attention(p, x, kv_x, cfg)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap, scale=_scale(cfg))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, S, H, hd) over k, v (B, T, KV, hd) in the reference's dense
    arithmetic: float32 scaled and softcapped scores, masked where ``mask``
    (T,) is False, the probabilities rounded to q's dtype before the PV
    product."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bqhgc,bthc->bhgqt", qg, k).float() * _scale(cfg)
    scores = softcap(scores, cfg.attn_logit_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhgqt,bthc->bqhgc", probs, v).reshape(B, S, H, hd)


def _cross_attention(p: dict, x: torch.Tensor, kv_x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    out = _dense_attention(*_qkv(p, x, cfg, kv_x), cfg)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


class KVCache(NamedTuple):
    k: torch.Tensor  # (n_layers, B, T, KV, hd): the cache dtype, or int8
    v: torch.Tensor
    # (n_layers, B, T, KV, 1) float32 dequantisation scales of an int8
    # cache; None otherwise
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, quantized: bool = False, *, device) -> KVCache:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        sshape = (n_layers, batch, max_len, cfg.n_kv_heads, 1)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 1, KV, hd) -> (int8 values, (B, 1, KV, 1) float32 scale):
    symmetric per (token, head)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     length: int, cfg: ModelConfig, *, window: int | None = None,
                     k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None):
    """One decode step: write the new K/V at ``length`` and attend over
    ``[0, length]``. x (B, 1, d); cache_k/v (B, T, KV, hd), this layer's
    cache (int8 with ``k_scale``/``v_scale`` (B, T, KV, 1) when quantised),
    updated in place (the reference returns new arrays), as are the scales.
    Returns out (B, 1, d)."""
    B = x.shape[0]
    dt = x.dtype
    if length >= cache_k.shape[1]:
        raise ValueError(f"decode position {length} is past the cache's {cache_k.shape[1]} slots")
    q, k, v = _qkv(p, x, cfg)
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    cos, sin = rope(pos, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    quantized = cache_k.dtype == torch.int8
    if quantized:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        k_scale[:, length] = ks[:, 0]
        v_scale[:, length] = vs[:, 0]
    cache_k[:, length] = k[:, 0].to(cache_k.dtype)
    cache_v[:, length] = v[:, 0].to(cache_v.dtype)
    keys, vals = cache_k.to(dt), cache_v.to(dt)
    if quantized:
        keys, vals = keys * k_scale.to(dt), vals * v_scale.to(dt)
    ti = torch.arange(cache_k.shape[1], device=x.device)
    mask = ti <= length
    if window is not None:
        mask &= ti > length - window
    out = _dense_attention(q, keys, vals, cfg, mask)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out
