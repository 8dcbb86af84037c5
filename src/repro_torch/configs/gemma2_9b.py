"""gemma2-9b [dense] — local/global alternating attention, logit softcaps.

42L d_model=3584 16H (GQA kv=8, head_dim 256) d_ff=14336 vocab=256000.
[arXiv:2408.00118; hf] Sandwich norms (pre+post), embedding scaling,
query_pre_attn_scalar=256, attn softcap 50, final softcap 30, SWA 4096 on
even layers. long_500k runs: local layers are SWA; global layers cost O(L)
per decoded token (DESIGN.md §5).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    norm="rmsnorm", mlp="geglu", use_post_norm=True,
    scale_embeddings=True, query_scale=256.0,
    sliding_window=4096, local_global_pattern=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="gemma2-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        norm="rmsnorm", mlp="geglu", use_post_norm=True,
        scale_embeddings=True, query_scale=16.0,
        sliding_window=8, local_global_pattern=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
    )
