"""Language-model layer of the port: every family of the reference (dense,
moe, vlm, ssm, hybrid, encdec), whose full-sequence forward runs the
flash-attention and SSD-scan Hopper kernels."""

from .config import ModelConfig  # noqa: F401
from .model_zoo import Model, build_model  # noqa: F401

__all__ = ["ModelConfig", "Model", "build_model"]
