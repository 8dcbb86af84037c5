"""Model assembly for the ``ssm`` and ``hybrid`` families: init, the
full-sequence forward and the cached one-token decode step.

- ssm (mamba2): a stack of Mamba2 blocks.
- hybrid (zamba2): a Mamba2 backbone with ONE shared attention block applied
  after every ``shared_attn_every`` layers, with the same weights each time.

Layer parameters are stacked along a leading ``n_layers`` axis, as in the
reference; the reference's ``lax.scan`` over that axis is a Python loop
here. The other families (dense, moe, vlm, encdec) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from . import attention as attn_mod
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import dense_init, norm_apply, norm_init, softcap
from .config import ModelConfig

__all__ = [
    "FAMILIES", "init_params", "embed_tokens", "forward", "unembed",
    "init_decode_state", "decode_step",
]

FAMILIES = ("ssm", "hybrid")

# the hybrid model's "full attention" window (the reference's int32 max // 2)
_BIG_WINDOW = (2**31 - 1) // 2


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet (ROADMAP queue A); "
            f"ported: {FAMILIES}")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter or state tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _stack(trees: list[dict]) -> dict:
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else torch.stack([t[k] for t in trees]) for k in first}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _mamba_layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    return {"ln1": norm_init(cfg.norm, cfg.d_model, device=device),
            "ssm": ssm_mod.ssm_init(gen, cfg, device=device)}


def _attn_layer_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    p: dict[str, Any] = {
        "ln1": norm_init(cfg.norm, cfg.d_model, device=device),
        "attn": attn_mod.attn_init(gen, cfg, device=device),
        "ln2": norm_init(cfg.norm, cfg.d_model, device=device),
        "mlp": mlp_mod.mlp_init(gen, cfg, device=device),
    }
    if cfg.use_post_norm:
        p["ln1_post"] = norm_init(cfg.norm, cfg.d_model, device=device)
        p["ln2_post"] = norm_init(cfg.norm, cfg.d_model, device=device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random float32 parameters on ``gen``'s device, in the reference's
    layout (stacked ``layers``; ``shared`` for the hybrid family). The
    values come from ``gen``, not from the reference's ``jax.random``."""
    check_family(cfg)
    device = gen.device
    p: dict[str, Any] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), device=device),
        "final_norm": norm_init(cfg.norm, cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), device=device)
    p["layers"] = _stack([_mamba_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)])
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        p["shared"] = _attn_layer_init(gen, cfg, device)
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_block(lp: dict, h: torch.Tensor, cfg: ModelConfig, window) -> torch.Tensor:
    a_in = norm_apply(lp["ln1"], h, cfg.norm)
    a = attn_mod.attention(lp["attn"], a_in, cfg, causal=True, window=window)
    if cfg.use_post_norm:
        a = norm_apply(lp["ln1_post"], a, cfg.norm)
    h = h + a
    m = mlp_mod.mlp_forward(lp["mlp"], norm_apply(lp["ln2"], h, cfg.norm), cfg)
    if cfg.use_post_norm:
        m = norm_apply(lp["ln2_post"], m, cfg.norm)
    return h + m


def _mamba_block(lp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    out, _ = ssm_mod.ssd_forward(lp["ssm"], norm_apply(lp["ln1"], h, cfg.norm), cfg)
    return h + out


def _hybrid_forward(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """zamba2: after each full segment of ``shared_attn_every`` Mamba layers
    the shared block runs with the same weights; the remainder layers
    follow without it."""
    k = cfg.shared_attn_every
    for i in range(cfg.n_layers):
        h = _mamba_block(_layer(params["layers"], i), h, cfg)
        if (i + 1) % k == 0:
            h = _attn_block(params["shared"], h, cfg, window=_BIG_WINDOW)
    return h


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 dtype: torch.dtype) -> torch.Tensor:
    h = params["embed"].to(dtype)[tokens]
    if cfg.scale_embeddings:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return h


def forward(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: batch {"tokens" (B, S)} -> (hidden (B, S, d),
    aux loss 0)."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    h = embed_tokens(params, batch["tokens"], cfg, dtype)
    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            h = _mamba_block(_layer(params["layers"], i), h, cfg)
    else:
        h = _hybrid_forward(params, h, cfg)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    return h, torch.zeros((), device=h.device)


def unembed(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    emb = params.get("unembed", params["embed"])
    logits = h @ emb.to(h.dtype).T
    return softcap(logits, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
                      device) -> dict:
    """Decode state: SSM states and conv buffers (float32) per layer, the
    shared block's KV cache in ``dtype`` (bf16 by default, as the
    reference), and ``length``, the valid prefix, a host int."""
    check_family(cfg)
    st: dict[str, Any] = {"length": 0,
                          "ssm": ssm_mod.init_ssm_state(cfg, batch, cfg.n_layers, device=device)}
    if cfg.family == "hybrid":
        n_shared = cfg.n_layers // cfg.shared_attn_every
        st["kv"] = attn_mod.init_kv_cache(cfg, batch, max_len, n_shared, dtype, device=device)
    return st


def decode_step(params: dict, state: dict, batch: dict, cfg: ModelConfig):
    """One token for the whole batch: batch {"token" (B, 1)} -> (logits
    (B, V), new state). The KV cache is updated in place."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    length = state["length"]
    h = embed_tokens(params, batch["token"], cfg, dtype)
    new_ssm = []
    kv = state.get("kv")
    shared_i = 0
    k = cfg.shared_attn_every
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        out, ns = ssm_mod.ssd_decode_step(
            lp["ssm"], norm_apply(lp["ln1"], h, cfg.norm), _layer(state["ssm"], i), cfg)
        h = h + out
        new_ssm.append(ns)
        if cfg.family == "hybrid" and (i + 1) % k == 0:
            sp = params["shared"]
            a, _, _ = attn_mod.attention_decode(
                sp["attn"], norm_apply(sp["ln1"], h, cfg.norm), kv.k[shared_i], kv.v[shared_i],
                length, cfg, window=None)
            h = h + a
            h = h + mlp_mod.mlp_forward(sp["mlp"], norm_apply(sp["ln2"], h, cfg.norm), cfg)
            shared_i += 1
    h = norm_apply(params["final_norm"], h, cfg.norm)
    logits = unembed(params, h, cfg)[:, 0]
    new_state = dict(state)
    new_state["ssm"] = _stack(new_ssm)
    new_state["length"] = length + 1
    return logits, new_state
