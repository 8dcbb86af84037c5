"""whisper-tiny [audio] — enc-dec; conv frontend STUB (precomputed frames).

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865. [arXiv:2212.04356]
decode_32k exceeds whisper's trained 448 positions — lowered as a dry-run
shape exercise only (DESIGN.md §5). long_500k skipped (full attention).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    head_dim=64, d_ff=1536, vocab_size=51865,
    norm="layernorm", mlp="gelu", qkv_bias=True,
    learned_positions=True, max_seq=32768 + 8, enc_positions=1500,
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        norm="layernorm", mlp="gelu", qkv_bias=True,
        learned_positions=True, max_seq=64, enc_positions=16,
    )
