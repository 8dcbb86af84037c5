"""Where the port runs: the card, unless the caller names another device.

Every entry point of the port (``DDFContext``, ``core.dataframe.from_numpy``,
``models.build_model``, ``models.convert.from_jax_params``) resolves its
``device`` argument here, so they agree on the default and on the refusal
to fall back to the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card. Asking for
    the card without one raises: there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
