"""Where the port runs: the card, unless the caller names another device.

Every entry point of the port (``DDFContext``, ``core.dataframe.from_numpy``,
``models.build_model``, ``models.convert.from_jax_params``) resolves its
``device`` argument here, so they agree on the default and on the refusal
to fall back to the CPU. A rank of a process group resolves with
``per_rank=True``: its default is its own card, ``cuda:LOCAL_RANK``."""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None, per_rank: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and with
    ``per_rank`` the card ``cuda:LOCAL_RANK`` (torchrun's variable, 0
    when unset), which becomes the current device so that a collective
    library initialised after this call binds to it. Asking for the card
    without one raises: there is no silent CPU fallback."""
    if device is None and per_rank:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if per_rank and dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return dev
