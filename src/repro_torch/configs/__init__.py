"""Model configurations of the port: the reference's ten architectures.

Each module exposes ``CONFIG`` (the published widths) and
``smoke_config()`` (a reduced config of the same family for CPU tests), as
the reference's ``repro.configs`` does. ``get_config(name)`` and
``get_smoke_config(name)`` take the reference's names and aliases; an
unknown name raises ``ValueError``.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCHS", "canonical", "get_config", "get_smoke_config"]

ARCHS = [
    "llava_next_mistral_7b",
    "zamba2_1p2b",
    "whisper_tiny",
    "mamba2_1p3b",
    "gemma2_9b",
    "stablelm_3b",
    "deepseek_67b",
    "olmo_1b",
    "granite_moe_3b",
    "granite_moe_1b",
]

_ALIASES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-1.3b": "mamba2_1p3b",
    "gemma2-9b": "gemma2_9b",
    "stablelm-3b": "stablelm_3b",
    "deepseek-67b": "deepseek_67b",
    "olmo-1b": "olmo_1b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()
