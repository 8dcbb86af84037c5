"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    norm="rmsnorm", mlp="swiglu",
    n_experts=32, top_k=8, capacity_factor=1.25,
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="granite1b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        norm="rmsnorm", mlp="swiglu",
        n_experts=4, top_k=2, capacity_factor=1.5,
    )
