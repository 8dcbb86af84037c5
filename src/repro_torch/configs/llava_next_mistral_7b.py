"""llava-next-mistral-7b [vlm] — Mistral-7B backbone + anyres patch prefix.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, sliding window 4096.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
The vision tower/anyres tiling is a STUB: input_specs supply precomputed
patch embeddings (B, n_patches, d_model); a linear adapter stands in for the
projector (DESIGN.md §5).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    norm="rmsnorm", mlp="swiglu", rope_theta=1e6,
    sliding_window=4096,
    n_patches=576,
    tie_embeddings=False,
)


def smoke_config():
    return ModelConfig(
        name="llava-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        norm="rmsnorm", mlp="swiglu", sliding_window=8,
        n_patches=4, tie_embeddings=False,
    )
