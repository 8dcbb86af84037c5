"""deepseek-67b [dense] — llama-arch at depth.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400. [arXiv:2401.02954]
Most collective-bound assigned config (TP at d=8192, 95 layers).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e4,
    tie_embeddings=False,
)


def smoke_config():
    return ModelConfig(
        name="deepseek-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=256,
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
    )
