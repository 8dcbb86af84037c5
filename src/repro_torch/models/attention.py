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

Over a plan's model axis (``tp``, a ``sharding.ModelAxis``; see
``models.tp``): with ``wq``/``wo`` split over heads, each rank attends its
query heads through ``ops.flash_attention``; ``wk``/``wv`` split over heads
give it their KV heads, split over head_dim they are gathered at use (the
backward reduce-scatters) and the rank takes the KV heads its query heads
read. *f* and *g* follow the stream's layout (``models.tp``): on a
sequence-split stream the rank attends its heads over the whole gathered
sequence and keeps its block of the summed output. Cross-attention splits
its heads the same way: Q from *f*(x), K/V from the encoder's output,
which every model rank holds whole (``copy_to_model`` on it), no rope.
Any other layout gathers the split leaves whole and runs on the whole
stream. Decode under a serve plan keeps the reference's cache layout: the
sequence over the ranks the state's spec names (split-K; ``sharding.
cache_axis``: the model ranks, or every rank of the mesh for a
long-context state): the new token's q/k/v are gathered whole over the
model ranks, the rank that owns position ``length`` writes it, each rank
scores its slice of the sequence for every head, the softmax's max and
sum are all-reduced in float32 over the cache's ranks and so is the sum of
the ranks' partial outputs; each rank then keeps its heads (or head_dim
slice) for the row-split ``wo``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.comm import fsdp
from ..kernels import ops
from . import tp as tp_mod
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


def _kv_heads(cfg: ModelConfig, tp) -> tuple[int, int] | None:
    """[lo, hi) of the KV heads this rank's query heads read when they are
    split over the model ranks; None when a rank's heads straddle KV heads
    unevenly."""
    G = cfg.n_heads // cfg.n_kv_heads
    lo, hi = tp_mod.rank_block(cfg.n_heads, tp)
    if (hi - lo) % G and G % (hi - lo):
        return None
    return lo // G, (hi - 1) // G + 1


def tp_layout(cfg: ModelConfig, tp) -> dict | None:
    """How the rank's attention leaves are split (``tp.dims``): {"q": 1,
    "k": 1 or 2, "v": 1 or 2} (the dim of ``wq``/``wk``/``wv`` split: heads
    or head_dim, with ``wo`` split over heads, the biases as their weights)
    when the rank can attend its query heads, else None (gather whole)."""
    dims = tp.dims
    if dims["wq"] != 1 or dims["wo"] != 0 or dims.get("bq", 0) != 0:
        return None
    out = {"q": 1}
    for n in ("k", "v"):
        dim = dims[f"w{n}"]
        if dim is None or dims.get(f"b{n}", dim - 1) != dim - 1:
            return None
        out[n] = dim
    if 2 in out.values() and _kv_heads(cfg, tp) is None:
        return None
    return out


def _qkv_tp(p: dict, x: torch.Tensor, cfg: ModelConfig, layout: dict, tp,
            kv_x: torch.Tensor | None = None):
    """This rank's query heads and the KV heads they read (whole head_dim),
    from the column-split projections of f(x) (and of ``kv_x``, whole on
    every rank, for cross-attention)."""
    xf = tp_mod.enter(x, tp)
    kvf = None if kv_x is None else fsdp.copy_to_model(kv_x, tp.group)
    q, k, v = _qkv(p, xf, cfg, kvf)
    if 2 in layout.values():
        lo, hi = _kv_heads(cfg, tp)
        if layout["k"] == 2:
            k = fsdp.gather(k, 3, tp.group)[:, :, lo:hi]
        if layout["v"] == 2:
            v = fsdp.gather(v, 3, tp.group)[:, :, lo:hi]
    return q, k, v


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
              window: int | None = None, positions: torch.Tensor | None = None,
              kv_x: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """Full-sequence attention, x (B, S, d) -> (B, S, d). With ``kv_x``
    (B, S_kv, d), cross-attention: K/V from ``kv_x``, no rope, no mask.
    With ``tp`` (a ``sharding.ModelAxis`` for ``p``), ``p`` holds this
    rank's shards over the model axis, and x and the output are the rank's
    block of the sequence where ``tp.seq``."""
    layout = None
    if tp is not None:
        layout = tp_layout(cfg, tp)
        if layout is None:
            p = tp_mod.gather_split(p, tp)
            x = tp_mod.whole(x, tp)
    q, k, v = _qkv(p, x, cfg, kv_x) if layout is None else _qkv_tp(p, x, cfg, layout, tp, kv_x)
    if kv_x is not None:
        out = _dense_attention(q, k, v, cfg)
    else:
        if positions is None:
            positions = torch.arange(q.shape[1], dtype=torch.int32, device=x.device)[None, :]
        cos, sin = rope(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_logit_softcap, scale=_scale(cfg))
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return tp_mod.own(y, tp) if layout is None else tp_mod.leave(y, tp)


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
                     k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
                     tp=None, cache=None):
    """One decode step: write the new K/V at ``length`` and attend over
    ``[0, length]``. x (B, 1, d); cache_k/v (B, T, KV, hd), this layer's
    cache (int8 with ``k_scale``/``v_scale`` (B, T, KV, 1) when quantised),
    updated in place (the reference returns new arrays), as are the scales.
    Returns out (B, 1, d). With ``tp``, ``p`` holds this rank's shards; with
    ``cache`` (a ``sharding.CacheAxis``), the caches hold its rank's block
    of the T positions."""
    if tp is not None or cache is not None:
        return _decode_tp(p, x, cache_k, cache_v, length, cfg, window, k_scale, v_scale, tp,
                          cache)
    dt = x.dtype
    if length >= cache_k.shape[1]:
        raise ValueError(f"decode position {length} is past the cache's {cache_k.shape[1]} slots")
    q, k, v = _qkv(p, x, cfg)
    q, k = _rope_at(q, k, length, cfg)
    quantized = cache_k.dtype == torch.int8
    if quantized:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        k_scale[:, length] = ks[:, 0]
        v_scale[:, length] = vs[:, 0]
    cache_k[:, length] = k[:, 0].to(cache_k.dtype)
    cache_v[:, length] = v[:, 0].to(cache_v.dtype)
    keys, vals = _dequantized(cache_k, cache_v, k_scale, v_scale, dt)
    mask = _decode_mask(torch.arange(cache_k.shape[1], device=x.device), length, window)
    out = _dense_attention(q, keys, vals, cfg, mask)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return out


def _rope_at(q, k, length: int, cfg: ModelConfig):
    pos = torch.full((q.shape[0], 1), length, dtype=torch.int32, device=q.device)
    cos, sin = rope(pos, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _dequantized(cache_k, cache_v, k_scale, v_scale, dt):
    keys, vals = cache_k.to(dt), cache_v.to(dt)
    if cache_k.dtype == torch.int8:
        keys, vals = keys * k_scale.to(dt), vals * v_scale.to(dt)
    return keys, vals


def _decode_mask(ti: torch.Tensor, length: int, window: int | None) -> torch.Tensor:
    mask = ti <= length
    if window is not None:
        mask &= ti > length - window
    return mask


def _decode_tp(p, x, cache_k, cache_v, length, cfg, window, k_scale, v_scale, tp, cache):
    """:func:`attention_decode` over the model ranks (``tp``) and the ranks
    that split the cache's positions (``cache``); the module's notes."""
    dt = x.dtype
    T_l = cache_k.shape[1]
    T = T_l * cache.size if cache is not None else T_l
    if length >= T:
        raise ValueError(f"decode position {length} is past the cache's {T} slots")
    dims = tp.dims if tp is not None else {}
    if tp is not None and any(
            dims[f"b{n}"] != (None if dims[f"w{n}"] is None else dims[f"w{n}"] - 1)
            for n in "qkv" if f"b{n}" in p):  # a bias split unlike its weight
        p = tp_mod.gather_split(p, tp)
        dims = dict.fromkeys(dims)

    def whole_of(n, t):  # each projection whole on every rank
        dim = dims.get(f"w{n}")
        return t if dim is None else fsdp.gather_whole(t, dim + 1, tp.group)

    q, k, v = (whole_of(n, t) for n, t in zip("qkv", _qkv(p, x, cfg)))
    q, k = _rope_at(q, k, length, cfg)
    lo = cache.rank * T_l if cache is not None else 0
    quantized = cache_k.dtype == torch.int8
    if quantized:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    if lo <= length < lo + T_l:  # this rank owns the position
        if quantized:
            k_scale[:, length - lo] = ks[:, 0]
            v_scale[:, length - lo] = vs[:, 0]
        cache_k[:, length - lo] = k[:, 0].to(cache_k.dtype)
        cache_v[:, length - lo] = v[:, 0].to(cache_v.dtype)
    keys, vals = _dequantized(cache_k, cache_v, k_scale, v_scale, dt)
    mask = _decode_mask(torch.arange(lo, lo + T_l, device=x.device), length, window)
    if cache is not None:
        out = _split_k_attention(q, keys, vals, cfg, mask, cache.group)
    else:
        out = _dense_attention(q, keys, vals, cfg, mask)
    wo = p["wo"].to(dt)
    dim = dims.get("wo")
    if dim is None:
        return torch.einsum("bshk,hkd->bsd", out, wo)
    a, b = tp_mod.rank_block(out.shape[2 + dim], tp)
    out = out[:, :, a:b] if dim == 0 else out[..., a:b]
    return fsdp.reduce_from_model(torch.einsum("bshk,hkd->bsd", out, wo), tp.group)


def _split_k_attention(q, k, v, cfg: ModelConfig, mask, group) -> torch.Tensor:
    """:func:`_dense_attention` of q (B, 1, H, hd) over the whole sequence,
    of which k, v (B, T/n, KV, hd) and ``mask`` (T/n,) are this rank's
    block over the n ranks of ``group``: the softmax's max and sum
    all-reduced, then the ranks' partial products (float32) summed, cast to
    q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bqhgc,bthc->bhgqt", qg, k).float() * _scale(cfg)
    scores = softcap(scores, cfg.attn_logit_softcap)
    scores = torch.where(mask, scores, -1e30)
    m = fsdp.all_reduce(scores.amax(dim=-1, keepdim=True), group, op="max")
    e = torch.exp(scores - m)
    total = fsdp.all_reduce(e.sum(dim=-1, keepdim=True), group)
    probs = (e / total).to(q.dtype)
    part = torch.einsum("bhgqt,bthc->bqhgc", probs.float(), v.float())
    return fsdp.all_reduce(part, group).to(q.dtype).reshape(B, S, H, hd)
