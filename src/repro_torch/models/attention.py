"""GQA self-attention: full-sequence (through the flash-attention kernel) and
single-token cached decode (plain PyTorch).

``attention`` computes q/k/v and rope, then calls ``ops.flash_attention``,
which takes the place of both the reference's dense einsum branch and its
chunked online-softmax path (``src/repro/models/attention.py:56-178``), so
any S works. Cross-attention and the int8 KV cache are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import ops
from .common import apply_rope, dense_init, rope, softcap
from .config import ModelConfig

__all__ = ["attn_init", "attention", "attention_decode", "init_kv_cache", "KVCache"]


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


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
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
    """Full-sequence self-attention, x (B, S, d) -> (B, S, d)."""
    if kv_x is not None:
        raise NotImplementedError("cross-attention (kv_x) is not ported yet "
                                  "(ROADMAP queue A: encdec family)")
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


class KVCache(NamedTuple):
    k: torch.Tensor  # (n_layers, B, T, KV, hd)
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, quantized: bool = False, *, device) -> KVCache:
    if quantized:
        raise NotImplementedError("the int8 KV cache is not ported yet (ROADMAP queue A)")
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     length: int, cfg: ModelConfig, *, window: int | None = None):
    """One decode step: write the new K/V at ``length`` and attend over
    ``[0, length]``. x (B, 1, d); cache_k/v (B, T, KV, hd), this layer's
    cache, updated in place (the reference returns new arrays). Returns
    (out (B, 1, d), cache_k, cache_v)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    if length >= cache_k.shape[1]:
        raise ValueError(f"decode position {length} is past the cache's {cache_k.shape[1]} slots")
    q, k, v = _qkv(p, x, cfg)
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    cos, sin = rope(pos, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, length] = k[:, 0].to(cache_k.dtype)
    cache_v[:, length] = v[:, 0].to(cache_v.dtype)
    keys = cache_k.to(dt)
    vals = cache_v.to(dt)

    qg = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bqhgc,bthc->bhgqt", qg, keys).float() * _scale(cfg)
    scores = softcap(scores, cfg.attn_logit_softcap)
    ti = torch.arange(cache_k.shape[1], device=x.device)
    mask = ti <= length
    if window is not None:
        mask &= ti > length - window
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bhgqt,bthc->bqhgc", probs, vals).reshape(B, 1, H, hd)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out, cache_k, cache_v
