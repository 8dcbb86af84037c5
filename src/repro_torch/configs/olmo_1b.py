"""olmo-1b [dense] — non-parametric LayerNorm.

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304. [arXiv:2402.00838; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304,
    norm="nonparametric", mlp="swiglu",
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="olmo-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        norm="nonparametric", mlp="swiglu",
    )
