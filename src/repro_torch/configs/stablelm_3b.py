"""stablelm-3b [dense] — MHA, LayerNorm, SwiGLU.

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b family; unverified — full-rotary variant]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50304,
    norm="layernorm", mlp="swiglu",
    tie_embeddings=False,
)


def smoke_config():
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        norm="layernorm", mlp="swiglu", tie_embeddings=False,
    )
