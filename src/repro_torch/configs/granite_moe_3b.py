"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155.
[hf:ibm-granite/granite-3.0-*-base family]
MoE dispatch/combine maps onto the paper's Combine-Shuffle-Reduce pattern
(DESIGN.md §5).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    norm="rmsnorm", mlp="swiglu",
    n_experts=40, top_k=8, capacity_factor=1.25,
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="granite3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        norm="rmsnorm", mlp="swiglu",
        n_experts=8, top_k=2, capacity_factor=1.5,
    )
