"""Model configurations of the port: the architectures whose families
(``ssm``, ``hybrid``) the port runs.

Each module exposes ``CONFIG`` (the published widths) and
``smoke_config()`` (a reduced config of the same family for CPU tests), as
the reference's ``repro.configs`` does. ``get_config(name)`` and
``get_smoke_config(name)`` take the reference's names and aliases; an
architecture the port does not run yet raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCHS", "canonical", "get_config", "get_smoke_config"]

ARCHS = ["zamba2_1p2b", "mamba2_1p3b"]

_ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "mamba2-1.3b": "mamba2_1p3b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP queue A: the dense, moe, "
            f"vlm and encdec families); ported: {ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()
