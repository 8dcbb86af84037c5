"""Language-model layer of the port: the ``ssm`` and ``hybrid`` families
(mamba2, zamba2), whose full-sequence forward runs the flash-attention and
SSD-scan Hopper kernels."""

from .config import ModelConfig  # noqa: F401
from .model_zoo import Model, build_model  # noqa: F401

__all__ = ["ModelConfig", "Model", "build_model"]
