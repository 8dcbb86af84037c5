"""Unified model configuration for the assigned architecture pool."""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0                 # 0 for attention-free
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # block flavour
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparametric
    mlp: str = "swiglu"              # swiglu | geglu | gelu
    use_post_norm: bool = False      # gemma2 sandwich norms
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    scale_embeddings: bool = False   # gemma2: h *= sqrt(d)
    query_scale: float | None = None # gemma2 query_pre_attn_scalar

    # attention variants
    sliding_window: int | None = None          # SWA width (mistral/llava)
    local_global_pattern: bool = False         # gemma2 alternating local/global
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1   # dispatch groups (launcher sets to #mesh shards)
    kv_quant_decode: bool = False  # int8 KV cache at decode (serving)

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # hybrid (zamba2): one shared attention block invoked every k layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper): encoder layers + precomputed-frame length
    n_enc_layers: int = 0
    enc_positions: int = 1500

    # VLM (llava): prefix patch embeddings (anyres stub)
    n_patches: int = 0

    tie_embeddings: bool = True
    max_seq: int = 8192               # learned-position table size if used
    learned_positions: bool = False   # whisper
    dtype: str = "bfloat16"

    # attention-free?
    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §5): SSM/hybrid, SWA, local+global."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None
                or self.local_global_pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (whisper is enc-dec)

    def num_params(self) -> int:
        """Analytic parameter count (for 6ND model FLOPs)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n = 0
        n += V * d  # embedding
        if not self.tie_embeddings:
            n += V * d
        per_layer = 0
        if self.family == "ssm":
            per_layer = self._ssm_layer_params()
        elif self.family == "hybrid":
            per_layer = self._ssm_layer_params()
        else:
            per_layer = self._attn_params() + self._mlp_params()
        n += self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            n += self._attn_params() + self._mlp_params()  # one shared block
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            n += self.n_enc_layers * (self._attn_params() + self._mlp_params())
            n += self.n_layers * self._attn_params()  # cross-attn in decoder
        return n

    def _attn_params(self) -> int:
        d, H, KV, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * H * hd + 2 * d * KV * hd + H * hd * d

    def _mlp_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        if self.family == "moe":
            return self.n_experts * 3 * d * ff + d * self.n_experts
        if self.mlp in ("swiglu", "geglu"):
            return 3 * d * ff
        return 2 * d * ff

    def _ssm_layer_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, s, h = self.ssm_groups, self.ssm_state, self.ssm_heads
        return 2 * d * di + 2 * d * g * s + d * h + di * d + 4 * di

    def num_active_params(self) -> int:
        """Active per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.num_params()
        d, ff = self.d_model, self.d_ff
        dense = self.num_params() - self.n_layers * self.n_experts * 3 * d * ff
        return dense + self.n_layers * self.top_k * 3 * d * ff
