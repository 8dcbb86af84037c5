"""Model assembly for every family: init, the full-sequence forward and the
cached one-token decode step.

- dense / moe / vlm: a uniform decoder stack (gemma2's local/global
  alternation is a per-layer window; llava puts projected patch embeddings
  in front of the tokens, and its decode ignores that prefix, as the
  reference's does).
- ssm (mamba2): a stack of Mamba2 blocks.
- hybrid (zamba2): a Mamba2 backbone with ONE shared attention block applied
  after every ``shared_attn_every`` layers, with the same weights each time.
- encdec (whisper): a bidirectional encoder over precomputed frames, and a
  causal decoder with cross-attention to the encoder's output (at decode,
  ``state["enc_out"]``).

Layer parameters are stacked along a leading ``n_layers`` axis, as in the
reference; the reference's ``lax.scan`` over that axis is a Python loop
here, over one ``torch.unbind`` of each stacked tensor (so a backward
stacks the layers' gradients once, rather than scattering each layer's
into a zero stack of its own). ``forward(..., remat=True)`` recomputes
each layer (and the hybrid's shared block) in the backward, as the
reference's ``_scan_layers(remat=True)`` does: only the layer inputs are
kept, through ``torch.utils.checkpoint``. The train step sets it; serving
leaves it off.

``forward(..., plan=...)`` runs a rank's part of the reference's planned
forward over a process group (``repro_torch.sharding``): ``params`` hold
this rank's shards and ``batch`` its rows. Each layer body gathers its
weights first (``gather_params``, inside the function a recomputation runs
again, as the reference's gather sits inside its remat'd layer), the
embedding, ``vis_proj`` and the position tables through ``use_param``, and
the leaves the reference reads without a hook (the final and encoder norms)
the same way, so that every parameter's gradient is summed over the ranks.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .. import sharding as shard_mod
from .common import dense_init, norm_apply, norm_init, softcap
from .config import ModelConfig

__all__ = [
    "FAMILIES", "init_params", "param_shapes", "embed_tokens", "forward", "unembed",
    "layer_windows", "init_decode_state", "decode_step",
]

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")

# "full attention" as a window (the reference's int32 max // 2)
_BIG_WINDOW = (2**31 - 1) // 2


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name}); known: {FAMILIES}")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter or state tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, one ``torch.unbind`` per leaf."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _run(remat: bool, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _stack(trees: list[dict]) -> dict:
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


def _init_stacked(n: int, make: Callable[[], dict]) -> dict:
    """``n`` layers of ``make()`` stacked on a leading axis, each copied into
    its slot as it is made, so the peak is the stack plus one layer."""
    def alloc(t):
        return ({k: alloc(v) for k, v in t.items()} if isinstance(t, dict)
                else t.new_empty((n,) + tuple(t.shape)))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    first = make()
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str, device) -> dict:
    """One layer: ``mamba``, ``attn_mlp``, ``attn_moe`` or ``cross`` (whisper's
    decoder block: self-attention, cross-attention, MLP)."""
    p: dict[str, Any] = {"ln1": norm_init(cfg.norm, cfg.d_model, device=device)}
    if kind == "mamba":
        p["ssm"] = ssm_mod.ssm_init(gen, cfg, device=device)
        return p
    p["attn"] = attn_mod.attn_init(gen, cfg, device=device)
    p["ln2"] = norm_init(cfg.norm, cfg.d_model, device=device)
    if kind == "attn_moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, device=device)
    else:
        p["mlp"] = mlp_mod.mlp_init(gen, cfg, device=device)
    if cfg.use_post_norm:
        p["ln1_post"] = norm_init(cfg.norm, cfg.d_model, device=device)
        p["ln2_post"] = norm_init(cfg.norm, cfg.d_model, device=device)
    if kind == "cross":
        p["lnx"] = norm_init(cfg.norm, cfg.d_model, device=device)
        p["xattn"] = attn_mod.attn_init(gen, cfg, device=device)
    return p


def _decoder_kind(cfg: ModelConfig) -> str:
    return {"moe": "attn_moe", "ssm": "mamba", "hybrid": "mamba",
            "encdec": "cross"}.get(cfg.family, "attn_mlp")


def layer_windows(cfg: ModelConfig, n_layers: int) -> list[int]:
    """Per-layer attention window (``_BIG_WINDOW``: full attention); with the
    local/global pattern, the window on even layers."""
    if cfg.local_global_pattern:
        return [cfg.sliding_window if i % 2 == 0 else _BIG_WINDOW for i in range(n_layers)]
    if cfg.sliding_window is not None:
        return [cfg.sliding_window] * n_layers
    return [_BIG_WINDOW] * n_layers


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random float32 parameters on ``gen``'s device (or ``device``, e.g.
    ``"meta"`` for shapes only), in the reference's layout (stacked
    ``layers`` and ``enc_layers``; ``shared`` for the hybrid family). The
    values come from ``gen``, not from the reference's ``jax.random``."""
    check_family(cfg)
    device = gen.device if device is None else torch.device(device)
    p: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), device=device),
        "final_norm": norm_init(cfg.norm, cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), device=device)
    if cfg.learned_positions:
        p["pos_embed"] = dense_init(gen, (cfg.max_seq, cfg.d_model), device=device)
    kind = _decoder_kind(cfg)
    p["layers"] = _init_stacked(cfg.n_layers, lambda: _layer_init(gen, cfg, kind, device))
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        p["shared"] = _layer_init(gen, cfg, "attn_mlp", device)
    if cfg.family == "encdec":
        p["enc_layers"] = _init_stacked(cfg.n_enc_layers,
                                        lambda: _layer_init(gen, cfg, "attn_mlp", device))
        p["enc_norm"] = norm_init(cfg.norm, cfg.d_model, device=device)
        p["enc_pos"] = dense_init(gen, (cfg.enc_positions, cfg.d_model), device=device)
    if cfg.family == "vlm" and cfg.n_patches:
        # the projector stub: one linear adapter over pre-projected patches
        p["vis_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), device=device)
    return p


@functools.lru_cache(maxsize=None)
def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of the whole parameters' shapes (``torch.Size``), from an
    init on the ``meta`` device: what a planned forward reads its shards'
    specs from. One tree per config, shared by the callers: not to be
    changed."""
    def go(t):
        return {k: go(v) for k, v in t.items()} if isinstance(t, dict) else t.shape

    return go(init_params(torch.Generator(), cfg, device="meta"))


def _layer_shapes(shapes: dict) -> dict:
    """One layer's shapes of a stacked shape tree."""
    return {k: _layer_shapes(v) if isinstance(v, dict) else v[1:] for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(lp: dict, h: torch.Tensor, cfg: ModelConfig, window, plan=None,
                shapes=None):
    """Pre-norm attention + MLP (or MoE) block: (h, MoE aux loss or 0).
    With a plan, ``lp`` holds shards of leaves of ``shapes``."""
    lp = shard_mod.gather_params(lp, plan, shapes)
    a_in = norm_apply(lp["ln1"], h, cfg.norm)
    a = attn_mod.attention(lp["attn"], a_in, cfg, causal=True, window=window)
    if cfg.use_post_norm:
        a = norm_apply(lp["ln1_post"], a, cfg.norm)
    h = h + a
    m_in = norm_apply(lp["ln2"], h, cfg.norm)
    if "moe" in lp:
        m, aux = moe_mod.moe_forward(lp["moe"], m_in, cfg, plan=plan)
    else:
        m, aux = mlp_mod.mlp_forward(lp["mlp"], m_in, cfg), 0.0
    if cfg.use_post_norm:
        m = norm_apply(lp["ln2_post"], m, cfg.norm)
    return shard_mod.act_seq(h + m, plan), aux


def _mamba_block(lp: dict, h: torch.Tensor, cfg: ModelConfig, plan=None,
                 shapes=None) -> torch.Tensor:
    lp = shard_mod.gather_params(lp, plan, shapes)
    out, _ = ssm_mod.ssd_forward(lp["ssm"], norm_apply(lp["ln1"], h, cfg.norm), cfg,
                                 plan=plan)
    return shard_mod.act_seq(h + out, plan)


def _hybrid_forward(params: dict, h: torch.Tensor, cfg: ModelConfig,
                    remat: bool = False, plan=None, shapes=None) -> torch.Tensor:
    """zamba2: after each full segment of ``shared_attn_every`` Mamba layers
    the shared block runs with the same weights; the remainder layers
    follow without it. With a plan the shared block is gathered at each
    use, and its gradient summed in float32 over the uses."""
    k = cfg.shared_attn_every
    lsh = _layer_shapes(shapes["layers"]) if shapes is not None else None
    ssh = shapes["shared"] if shapes is not None else None
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = _run(remat, _mamba_block, lp, h, cfg, plan, lsh)
        if (i + 1) % k == 0:
            h, _ = _run(remat, _attn_block, params["shared"], h, cfg, _BIG_WINDOW, plan, ssh)
    return h


def _encoder_layer(lp: dict, h: torch.Tensor, cfg: ModelConfig, plan=None,
                   shapes=None) -> torch.Tensor:
    lp = shard_mod.gather_params(lp, plan, shapes)
    a_in = norm_apply(lp["ln1"], h, cfg.norm)
    h = h + attn_mod.attention(lp["attn"], a_in, cfg, causal=False, window=None)
    return h + mlp_mod.mlp_forward(lp["mlp"], norm_apply(lp["ln2"], h, cfg.norm), cfg)


def _encoder_forward(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                     remat: bool = False, plan=None, shapes=None) -> torch.Tensor:
    """whisper's encoder over precomputed conv-frontend frames (B, T, d):
    bidirectional self-attention and MLP blocks, then the encoder norm."""
    T = frames.shape[1]
    pos = shard_mod.use_param(params["enc_pos"][:T], plan, "enc_pos",
                              shapes and shapes["enc_pos"])
    h = frames + pos.to(frames.dtype)[None]
    lsh = _layer_shapes(shapes["enc_layers"]) if shapes is not None else None
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        h = _run(remat, _encoder_layer, lp, h, cfg, plan, lsh)
    enc_norm = shard_mod.gather_params(params["enc_norm"], plan,
                                       shapes and shapes["enc_norm"])
    return norm_apply(enc_norm, h, cfg.norm)


def _decoder_layer(lp: dict, h: torch.Tensor, enc: torch.Tensor,
                   cfg: ModelConfig, plan=None, shapes=None) -> torch.Tensor:
    """whisper's decoder block: causal self-attention, cross-attention to
    ``enc``, MLP."""
    lp = shard_mod.gather_params(lp, plan, shapes)
    h = h + attn_mod.attention(lp["attn"], norm_apply(lp["ln1"], h, cfg.norm), cfg,
                               causal=True)
    h = h + attn_mod.attention(lp["xattn"], norm_apply(lp["lnx"], h, cfg.norm), cfg,
                               kv_x=enc)
    h = h + mlp_mod.mlp_forward(lp["mlp"], norm_apply(lp["ln2"], h, cfg.norm), cfg)
    return shard_mod.act_seq(h, plan)


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 dtype: torch.dtype, plan=None, shape=None) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``dtype``; with a plan the
    embedding is gathered (``use_param``), ``shape`` its whole shape."""
    emb = shard_mod.use_param(params["embed"], plan, "embed", shape)
    h = emb.to(dtype)[tokens]
    if cfg.scale_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return h


def forward(params: dict, batch: dict, cfg: ModelConfig, remat: bool = False,
            plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: batch {"tokens" (B, S)}, plus "patch_embeds"
    (B, n_patches, d) for vlm or "enc_frames" (B, T, d) for encdec ->
    (hidden (B, S', d), MoE aux loss, a float32 scalar). For vlm, S' is
    n_patches + S. ``remat`` recomputes every layer in the backward. With
    ``plan`` (a train plan over a process group), ``params`` are this
    rank's shards and ``batch`` its rows; the aux loss is the global one."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    sh = param_shapes(cfg) if shard_mod.data_group(plan) is not None else None

    def shape(name):
        return sh and sh[name]

    h = embed_tokens(params, batch["tokens"], cfg, dtype, plan, shape("embed"))
    if cfg.family == "vlm" and cfg.n_patches:
        vp = shard_mod.use_param(params["vis_proj"], plan, "vis_proj", shape("vis_proj"))
        pe = batch["patch_embeds"].to(dtype) @ vp.to(dtype)
        h = torch.cat([pe, h], dim=1)  # the image prefix
    if cfg.learned_positions:
        pos = shard_mod.use_param(params["pos_embed"][: h.shape[1]], plan, "pos_embed",
                                  shape("pos_embed"))
        h = h + pos.to(dtype)[None]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    lsh = _layer_shapes(sh["layers"]) if sh is not None else None

    if cfg.family in ("dense", "moe", "vlm"):
        layers = _unstack(params["layers"], cfg.n_layers)
        for lp, win in zip(layers, layer_windows(cfg, cfg.n_layers)):
            h, a = _run(remat, _attn_block, lp, h, cfg, win, plan, lsh)
            aux = aux + a
    elif cfg.family == "ssm":
        for lp in _unstack(params["layers"], cfg.n_layers):
            h = _run(remat, _mamba_block, lp, h, cfg, plan, lsh)
    elif cfg.family == "hybrid":
        h = _hybrid_forward(params, h, cfg, remat, plan, sh)
    else:  # encdec
        enc = _encoder_forward(params, batch["enc_frames"].to(dtype), cfg, remat, plan, sh)
        for lp in _unstack(params["layers"], cfg.n_layers):
            h = _run(remat, _decoder_layer, lp, h, enc, cfg, plan, lsh)
    final_norm = shard_mod.gather_params(params["final_norm"], plan, shape("final_norm"))
    h = norm_apply(final_norm, h, cfg.norm)
    return h, aux


def unembed(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    emb = params.get("unembed", params["embed"])
    logits = h @ emb.to(h.dtype).T
    return softcap(logits, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
                      device) -> dict:
    """Decode state: KV caches in ``dtype`` (bf16 by default, as the
    reference; int8 with float32 scales when ``cfg.kv_quant_decode``, for
    the decoder-stack families), SSM states and conv buffers in float32,
    for encdec ``enc_out`` (B, enc_positions, d) zeros in ``dtype``, and
    ``length``, the valid prefix, a host int."""
    check_family(cfg)
    L = cfg.n_layers
    st: dict[str, Any] = {"length": 0}
    if cfg.family in ("dense", "moe", "vlm"):
        st["kv"] = attn_mod.init_kv_cache(cfg, batch, max_len, L, dtype,
                                          quantized=cfg.kv_quant_decode, device=device)
    elif cfg.family in ("ssm", "hybrid"):
        st["ssm"] = ssm_mod.init_ssm_state(cfg, batch, L, device=device)
        if cfg.family == "hybrid":
            st["kv"] = attn_mod.init_kv_cache(cfg, batch, max_len, L // cfg.shared_attn_every,
                                              dtype, device=device)
    else:  # encdec
        st["kv"] = attn_mod.init_kv_cache(cfg, batch, max_len, L, dtype, device=device)
        st["enc_out"] = torch.zeros((batch, cfg.enc_positions, cfg.d_model), dtype=dtype,
                                    device=device)
    return st


def _decode_layer(lp: dict, h: torch.Tensor, kv, i: int, length: int, cfg: ModelConfig,
                  window, enc: torch.Tensor | None = None) -> torch.Tensor:
    """One attention layer of the decoder stack at decode: self-attention
    over layer ``i``'s cache (updated in place), cross-attention to ``enc``
    for encdec, then the MLP or MoE."""
    scales = (kv.k_scale[i], kv.v_scale[i]) if kv.quantized else (None, None)
    a = attn_mod.attention_decode(
        lp["attn"], norm_apply(lp["ln1"], h, cfg.norm), kv.k[i], kv.v[i], length, cfg,
        window=window, k_scale=scales[0], v_scale=scales[1])
    if cfg.use_post_norm:
        a = norm_apply(lp["ln1_post"], a, cfg.norm)
    h = h + a
    if enc is not None:
        h = h + attn_mod.attention(lp["xattn"], norm_apply(lp["lnx"], h, cfg.norm), cfg,
                                   kv_x=enc)
    m_in = norm_apply(lp["ln2"], h, cfg.norm)
    if "moe" in lp:
        m, _ = moe_mod.moe_forward(lp["moe"], m_in, cfg)
    else:
        m = mlp_mod.mlp_forward(lp["mlp"], m_in, cfg)
    if cfg.use_post_norm:
        m = norm_apply(lp["ln2_post"], m, cfg.norm)
    return h + m


def decode_step(params: dict, state: dict, batch: dict, cfg: ModelConfig):
    """One token for the whole batch: batch {"token" (B, 1)} -> (logits
    (B, V), new state). The KV caches are updated in place."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    length = state["length"]
    h = embed_tokens(params, batch["token"], cfg, dtype)
    if cfg.learned_positions:
        h = h + params["pos_embed"][length].to(dtype)[None, None]
    new_state = dict(state)
    kv = state.get("kv")
    if cfg.family in ("dense", "moe", "vlm"):
        for i, win in enumerate(layer_windows(cfg, cfg.n_layers)):
            h = _decode_layer(_layer(params["layers"], i), h, kv, i, length, cfg, win)
    elif cfg.family == "encdec":
        enc = state["enc_out"].to(dtype)
        for i in range(cfg.n_layers):
            h = _decode_layer(_layer(params["layers"], i), h, kv, i, length, cfg, None, enc)
    else:  # ssm, hybrid
        new_ssm = []
        shared_i = 0
        k = cfg.shared_attn_every
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            out, ns = ssm_mod.ssd_decode_step(
                lp["ssm"], norm_apply(lp["ln1"], h, cfg.norm), _layer(state["ssm"], i), cfg)
            h = h + out
            new_ssm.append(ns)
            if cfg.family == "hybrid" and (i + 1) % k == 0:
                h = _decode_layer(params["shared"], h, kv, shared_i, length, cfg, None)
                shared_i += 1
        new_state["ssm"] = _stack(new_ssm)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    logits = unembed(params, h, cfg)[:, 0]
    new_state["length"] = length + 1
    return logits, new_state
