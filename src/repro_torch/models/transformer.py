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
Over the plan's model axis each block runs its part of the Megatron split
(``models.tp``; attention and cross-attention, MLP, MoE and the Mamba2
mixer each say theirs), the embedding is looked up in the rank's block of
the vocabulary and summed over the ranks, llava's column-split
``vis_proj`` output is gathered before the image prefix, whisper's
encoder runs the same split on a stream every model rank holds whole, and
the serving unembedding gathers each rank's block of the logits. Where
the reference splits the residual stream over the model ranks
(``sharding.stream_split``), it is split after the embedding, the image
prefix and the positions (``sharding.act_seq``), every decoder block takes
and gives the rank's block of the sequence (its norms' gradients summed
over the model ranks), and the stream is gathered back after the final
norm. ``decode_step(..., plan=...)`` takes a decode state from
``init_decode_state(..., plan=...)``: the rank's shards, the KV cache's
sequence over the model ranks where it divides, or over the whole mesh
for a long-context state (split-K decode).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import tp as tp_mod
from .. import sharding as shard_mod
from ..core.comm import fsdp
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


def _model_axes(cfg: ModelConfig, plan, seq: bool = False):
    """(the plan's model axis for the whole parameters, for one stacked
    layer's), both None where the layers run whole; ``seq``: the stream is
    split over the model ranks."""
    if shard_mod.model_group(plan) is None:
        return None, None
    full = param_shapes(cfg)
    return tuple(dataclasses.replace(shard_mod.model_axis(plan, shapes), seq=seq)
                 for shapes in (full, _layer_shapes(full["layers"])))


def _encoder_axis(cfg: ModelConfig, plan):
    """The model axis for one stacked encoder layer's parameters (its
    stream whole on every model rank), or None."""
    if cfg.family != "encdec" or shard_mod.model_group(plan) is None:
        return None
    return shard_mod.model_axis(plan, _layer_shapes(param_shapes(cfg)["enc_layers"]))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(lp: dict, h: torch.Tensor, cfg: ModelConfig, window, plan=None,
                shapes=None, tp=None):
    """Pre-norm attention + MLP (or MoE) block: (h, MoE aux loss or 0).
    With a plan, ``lp`` holds shards of leaves of ``shapes``, and ``tp`` is
    the model axis for ``lp`` (None at model axis 1; ``tp.seq``: ``h`` is
    the rank's block of the sequence, and so is the result)."""
    lp = tp_mod.stream_params(shard_mod.gather_params(lp, plan, shapes), tp)
    a_in = norm_apply(lp["ln1"], h, cfg.norm)
    a = attn_mod.attention(lp["attn"], a_in, cfg, causal=True, window=window,
                           tp=tp and tp.sub("attn"))
    if cfg.use_post_norm:
        a = norm_apply(lp["ln1_post"], a, cfg.norm)
    h = h + a
    m_in = norm_apply(lp["ln2"], h, cfg.norm)
    if "moe" in lp:
        m, aux = moe_mod.moe_forward(lp["moe"], m_in, cfg, plan=plan, tp=tp and tp.sub("moe"))
    else:
        m, aux = mlp_mod.mlp_forward(lp["mlp"], m_in, cfg, tp=tp and tp.sub("mlp")), 0.0
    if cfg.use_post_norm:
        m = norm_apply(lp["ln2_post"], m, cfg.norm)
    return h + m, aux


def _mamba_block(lp: dict, h: torch.Tensor, cfg: ModelConfig, plan=None,
                 shapes=None, tp=None) -> torch.Tensor:
    lp = tp_mod.stream_params(shard_mod.gather_params(lp, plan, shapes), tp)
    out, _ = ssm_mod.ssd_forward(lp["ssm"], norm_apply(lp["ln1"], h, cfg.norm), cfg,
                                 plan=plan, tp=tp and tp.sub("ssm"))
    return h + out


def _hybrid_forward(params: dict, h: torch.Tensor, cfg: ModelConfig,
                    remat: bool = False, plan=None, shapes=None, tp=None,
                    ltp=None) -> torch.Tensor:
    """zamba2: after each full segment of ``shared_attn_every`` Mamba layers
    the shared block runs with the same weights; the remainder layers
    follow without it. With a plan the shared block is gathered at each
    use, and its gradient summed in float32 over the uses."""
    k = cfg.shared_attn_every
    lsh = _layer_shapes(shapes["layers"]) if shapes is not None else None
    ssh = shapes["shared"] if shapes is not None else None
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = _run(remat, _mamba_block, lp, h, cfg, plan, lsh, ltp)
        if (i + 1) % k == 0:
            h, _ = _run(remat, _attn_block, params["shared"], h, cfg, _BIG_WINDOW, plan, ssh,
                        tp and tp.sub("shared"))
    return h


def _encoder_layer(lp: dict, h: torch.Tensor, cfg: ModelConfig, plan=None,
                   shapes=None, tp=None) -> torch.Tensor:
    lp = shard_mod.gather_params(lp, plan, shapes)
    a_in = norm_apply(lp["ln1"], h, cfg.norm)
    h = h + attn_mod.attention(lp["attn"], a_in, cfg, causal=False, window=None,
                               tp=tp and tp.sub("attn"))
    return h + mlp_mod.mlp_forward(lp["mlp"], norm_apply(lp["ln2"], h, cfg.norm), cfg,
                                   tp=tp and tp.sub("mlp"))


def _encoder_forward(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                     remat: bool = False, plan=None, shapes=None, tp=None) -> torch.Tensor:
    """whisper's encoder over precomputed conv-frontend frames (B, T, d):
    bidirectional self-attention and MLP blocks, then the encoder norm.
    ``tp``: the model axis for one encoder layer (the stream whole on every
    model rank, as the reference's encoder has no ``act_seq``)."""
    T = frames.shape[1]
    pos = shard_mod.use_param(params["enc_pos"][:T], plan, "enc_pos",
                              shapes and shapes["enc_pos"])
    h = frames + pos.to(frames.dtype)[None]
    lsh = _layer_shapes(shapes["enc_layers"]) if shapes is not None else None
    for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
        h = _run(remat, _encoder_layer, lp, h, cfg, plan, lsh, tp)
    enc_norm = shard_mod.gather_params(params["enc_norm"], plan,
                                       shapes and shapes["enc_norm"])
    return norm_apply(enc_norm, h, cfg.norm)


def _decoder_layer(lp: dict, h: torch.Tensor, enc: torch.Tensor,
                   cfg: ModelConfig, plan=None, shapes=None, tp=None) -> torch.Tensor:
    """whisper's decoder block: causal self-attention, cross-attention to
    ``enc``, MLP. ``tp``: the model axis for ``lp`` (``tp.seq``: ``h`` is
    the rank's block of the sequence; ``enc`` is whole on every rank)."""
    lp = tp_mod.stream_params(shard_mod.gather_params(lp, plan, shapes), tp)
    h = h + attn_mod.attention(lp["attn"], norm_apply(lp["ln1"], h, cfg.norm), cfg,
                               causal=True, tp=tp and tp.sub("attn"))
    h = h + attn_mod.attention(lp["xattn"], norm_apply(lp["lnx"], h, cfg.norm), cfg,
                               kv_x=enc, tp=tp and tp.sub("xattn"))
    return h + mlp_mod.mlp_forward(lp["mlp"], norm_apply(lp["ln2"], h, cfg.norm), cfg,
                                   tp=tp and tp.sub("mlp"))


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 dtype: torch.dtype, plan=None, shape=None, tp=None,
                 split: bool = False) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``dtype``; with a plan the
    embedding is gathered over "data" (``use_param``), ``shape`` its whole
    shape, and looked up in the rank's block of the vocabulary where the
    model axis ``tp`` (for the whole parameters) splits it; with ``split``,
    the rank's block of the sequence of them."""
    emb = shard_mod.use_param(params["embed"], plan, "embed", shape)
    h = tp_mod.embed_lookup(emb, tokens, dtype, tp and tp.sub("embed"), split)
    if cfg.scale_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return h


def forward(params: dict, batch: dict, cfg: ModelConfig, remat: bool = False,
            plan=None, gather_out: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: batch {"tokens" (B, S)}, plus "patch_embeds"
    (B, n_patches, d) for vlm or "enc_frames" (B, T, d) for encdec ->
    (hidden (B, S', d), MoE aux loss, a float32 scalar). For vlm, S' is
    n_patches + S. ``remat`` recomputes every layer in the backward. With
    ``plan`` (a train plan over a process group), ``params`` are this
    rank's shards and ``batch`` its rows; the aux loss is the global one. A
    serve plan's ``params`` are split over "model" alone. Where the plan
    splits the stream over the model ranks, ``gather_out=False`` returns
    the rank's block of the sequence (B, S'/M, d) as the final norm left it
    (the loss gathers it itself)."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    sh = param_shapes(cfg) if shard_mod.fsdp_group(plan) is not None else None
    prefix = cfg.n_patches if cfg.family == "vlm" and cfg.n_patches else 0
    split = shard_mod.stream_split(plan, prefix + batch["tokens"].shape[1])
    tp, ltp = _model_axes(cfg, plan, seq=split)
    # the embedding's sum reduce-scatters when nothing is added to the whole stream
    direct = split and not prefix and not cfg.learned_positions

    def shape(name):
        return sh and sh[name]

    h = embed_tokens(params, batch["tokens"], cfg, dtype, plan, shape("embed"), tp, direct)
    if prefix:
        vp = shard_mod.use_param(params["vis_proj"], plan, "vis_proj", shape("vis_proj"))
        pe = batch["patch_embeds"].to(dtype) @ vp.to(dtype)
        if tp is not None and tp.dims["vis_proj"] is not None:  # its columns over "model"
            pe = fsdp.gather_whole(pe, pe.dim() - 1, tp.group)
        h = torch.cat([pe, h], dim=1)  # the image prefix
    if cfg.learned_positions:
        pos = shard_mod.use_param(params["pos_embed"][: h.shape[1]], plan, "pos_embed",
                                  shape("pos_embed"))
        h = h + pos.to(dtype)[None]
    if split and not direct:
        h = shard_mod.act_seq(h, plan)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    lsh = _layer_shapes(sh["layers"]) if sh is not None else None

    if cfg.family in ("dense", "moe", "vlm"):
        layers = _unstack(params["layers"], cfg.n_layers)
        for lp, win in zip(layers, layer_windows(cfg, cfg.n_layers)):
            h, a = _run(remat, _attn_block, lp, h, cfg, win, plan, lsh, ltp)
            aux = aux + a
    elif cfg.family == "ssm":
        for lp in _unstack(params["layers"], cfg.n_layers):
            h = _run(remat, _mamba_block, lp, h, cfg, plan, lsh, ltp)
    elif cfg.family == "hybrid":
        h = _hybrid_forward(params, h, cfg, remat, plan, sh, tp, ltp)
    else:  # encdec
        enc = _encoder_forward(params, batch["enc_frames"].to(dtype), cfg, remat, plan, sh,
                               _encoder_axis(cfg, plan))
        for lp in _unstack(params["layers"], cfg.n_layers):
            h = _run(remat, _decoder_layer, lp, h, enc, cfg, plan, lsh, ltp)
    final_norm = shard_mod.gather_params(params["final_norm"], plan, shape("final_norm"))
    h = norm_apply(tp_mod.stream_norm(final_norm, tp), h, cfg.norm)
    if split and gather_out:
        h = fsdp.gather_whole(h, 1, tp.group)
    return h, aux


def unembed(params: dict, h: torch.Tensor, cfg: ModelConfig, plan=None) -> torch.Tensor:
    """h (..., d) -> the whole logits (..., V); with a plan, ``params`` are
    the rank's shards."""
    name = "unembed" if "unembed" in params else "embed"
    shape = param_shapes(cfg)[name] if shard_mod.fsdp_group(plan) is not None else None
    emb = shard_mod.use_param(params[name], plan, name, shape)
    tp = shard_mod.model_axis(plan, param_shapes(cfg))
    logits = tp_mod.unembed_logits(h, emb, tp and tp.sub(name))
    return softcap(logits, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
                      device, plan=None, long_context: bool = False) -> dict:
    """Decode state: KV caches in ``dtype`` (bf16 by default, as the
    reference; int8 with float32 scales when ``cfg.kv_quant_decode``, for
    the decoder-stack families), SSM states and conv buffers in float32,
    for encdec ``enc_out`` (B, enc_positions, d) zeros in ``dtype``, and
    ``length``, the valid prefix, a host int. With ``plan``, this rank's
    shards of the ``batch``-row state (``sharding.decode_state_specs``), a
    ``sharding.RankState``; with ``long_context`` (the reference's batch-1
    decode), the KV cache's positions split over every axis of the mesh
    and the batch whole on every rank."""
    check_family(cfg)
    if plan is not None:
        whole = init_decode_state(cfg, batch, max_len, dtype, device="meta")
        specs = shard_mod.decode_state_specs(whole, plan, long_context=long_context)
        local = shard_mod._tree_map(
            lambda path, t, s: torch.zeros(shard_mod.local_shape(t.shape, s, plan),
                                           dtype=t.dtype, device=device), whole, specs)
        local["length"] = 0
        return shard_mod.RankState(local, plan, specs)
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
                  window, enc: torch.Tensor | None = None, tp=None,
                  cache=None) -> torch.Tensor:
    """One attention layer of the decoder stack at decode: self-attention
    over layer ``i``'s cache (updated in place), cross-attention to ``enc``
    for encdec, then the MLP or MoE. ``tp``: the model axis for ``lp``;
    ``cache``: the ranks that split the cache's positions."""
    scales = (kv.k_scale[i], kv.v_scale[i]) if kv.quantized else (None, None)
    a = attn_mod.attention_decode(
        lp["attn"], norm_apply(lp["ln1"], h, cfg.norm), kv.k[i], kv.v[i], length, cfg,
        window=window, k_scale=scales[0], v_scale=scales[1], tp=tp and tp.sub("attn"),
        cache=cache)
    if cfg.use_post_norm:
        a = norm_apply(lp["ln1_post"], a, cfg.norm)
    h = h + a
    if enc is not None:
        h = h + attn_mod.attention(lp["xattn"], norm_apply(lp["lnx"], h, cfg.norm), cfg,
                                   kv_x=enc, tp=tp and tp.sub("xattn"))
    m_in = norm_apply(lp["ln2"], h, cfg.norm)
    if "moe" in lp:
        m, _ = moe_mod.moe_forward(lp["moe"], m_in, cfg, tp=tp and tp.sub("moe"))
    else:
        m = mlp_mod.mlp_forward(lp["mlp"], m_in, cfg, tp=tp and tp.sub("mlp"))
    if cfg.use_post_norm:
        m = norm_apply(lp["ln2_post"], m, cfg.norm)
    return h + m


def decode_step(params: dict, state: dict, batch: dict, cfg: ModelConfig, plan=None):
    """One token for the whole batch: batch {"token" (B, 1)} -> (logits
    (B, V), new state). The KV caches are updated in place. With ``plan``,
    ``params`` are this rank's shards, ``batch`` its rows and ``state`` its
    ``init_decode_state(..., plan=plan)`` (the KV cache's positions split
    as its specs say); the logits are whole."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    length = state["length"]
    tp, ltp = _model_axes(cfg, plan)
    if plan is not None and not isinstance(state, shard_mod.RankState):
        raise TypeError("a planned decode step takes init_decode_state(..., plan=plan)")
    sh = param_shapes(cfg) if shard_mod.fsdp_group(plan) is not None else None
    lsh = _layer_shapes(sh["layers"]) if sh is not None else None

    def layer(i):
        return shard_mod.gather_params(_layer(params["layers"], i), plan, lsh)

    def shared():
        return shard_mod.gather_params(params["shared"], plan, sh and sh["shared"])

    cache = None
    if plan is not None and "kv" in state:
        cache = shard_mod.cache_axis(plan, state.specs["kv"].k)
    h = embed_tokens(params, batch["token"], cfg, dtype, plan, sh and sh["embed"], tp)
    if cfg.learned_positions:
        pos = shard_mod.use_param(params["pos_embed"][length:length + 1], plan, "pos_embed",
                                  sh and sh["pos_embed"])
        h = h + pos[0].to(dtype)[None, None]
    new_state = dict(state)
    kv = state.get("kv")
    if cfg.family in ("dense", "moe", "vlm"):
        for i, win in enumerate(layer_windows(cfg, cfg.n_layers)):
            h = _decode_layer(layer(i), h, kv, i, length, cfg, win, tp=ltp, cache=cache)
    elif cfg.family == "encdec":
        enc = state["enc_out"].to(dtype)
        for i in range(cfg.n_layers):
            h = _decode_layer(layer(i), h, kv, i, length, cfg, None, enc, tp=ltp, cache=cache)
    else:  # ssm, hybrid
        new_ssm = []
        shared_i = 0
        k = cfg.shared_attn_every
        for i in range(cfg.n_layers):
            lp = layer(i)
            out, ns = ssm_mod.ssd_decode_step(
                lp["ssm"], norm_apply(lp["ln1"], h, cfg.norm), _layer(state["ssm"], i), cfg,
                tp=ltp and ltp.sub("ssm"))
            h = h + out
            new_ssm.append(ns)
            if cfg.family == "hybrid" and (i + 1) % k == 0:
                h = _decode_layer(shared(), h, kv, shared_i, length, cfg, None,
                                  tp=tp and tp.sub("shared"), cache=cache)
                shared_i += 1
        new_state["ssm"] = _stack(new_ssm)
    final_norm = shard_mod.gather_params(params["final_norm"], plan, sh and sh["final_norm"])
    h = norm_apply(final_norm, h, cfg.norm)
    logits = unembed(params, h, cfg, plan)[:, 0]
    new_state["length"] = length + 1
    if plan is not None:
        new_state = shard_mod.RankState(new_state, state.plan, state.specs)
    return logits, new_state
