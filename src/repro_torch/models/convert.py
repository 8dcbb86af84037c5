"""Parameters of the reference's models, as the port's.

The caller turns the reference's parameter pytree into numpy arrays
(``jax.tree.map(np.asarray, params)``); this module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from ..device import resolve_device
from .transformer import check_family

__all__ = ["from_jax_params"]


def _convert(tree, device, path: str):
    if isinstance(tree, dict):
        return {k: _convert(v, device, f"{path}.{k}") for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype != np.float32:
        raise TypeError(f"{path}: expected float32 parameters, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_params(params_np: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameters (nested dicts of float32 numpy arrays) as
    the port's: the same names and shapes, the stacked ``(n_layers, ...)``
    layer layout and ``params["shared"]`` kept, on ``device`` (default: the
    card)."""
    check_family(cfg)
    device = resolve_device(device)
    want = {"embed", "final_norm", "layers"}
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        want.add("shared")
    if not cfg.tie_embeddings:
        want.add("unembed")
    if set(params_np) != want:
        raise ValueError(f"parameter keys {sorted(params_np)} do not match {cfg.name}'s "
                         f"{sorted(want)}")
    out = _convert(params_np, device, "params")
    lead = {t.shape[0] for t in _leaves(out["layers"])}
    if lead != {cfg.n_layers}:
        raise ValueError(f"stacked layers have leading sizes {sorted(lead)}, "
                         f"expected {cfg.n_layers}")
    return out


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
