"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]
Simplifications vs HF zamba2 (DESIGN.md §5): per-invocation LoRA on the
shared block omitted; shared block is a plain pre-norm attn+MLP reused every
6 layers.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    norm="rmsnorm", mlp="gelu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    shared_attn_every=6,
)


def smoke_config():
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        norm="rmsnorm", mlp="gelu",
        ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=8,
        shared_attn_every=2,
    )
