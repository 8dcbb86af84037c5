"""mamba2-1.3b [ssm] — pure SSD stack, attention-free.

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    norm="rmsnorm",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
)


def smoke_config():
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=3, d_model=64, vocab_size=256,
        norm="rmsnorm",
        ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=8,
    )
