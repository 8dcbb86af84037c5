"""Parameters and train states of the reference's models, as the port's,
and back.

The caller turns the reference's pytree into numpy arrays
(``jax.tree.map(np.asarray, tree)``); this module imports no jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from ..device import resolve_device
from ..tree import leaves
from .transformer import check_family

__all__ = ["from_jax_params", "from_jax_train_state", "to_numpy_tree", "expected_keys"]


def _convert(tree, device, path: str):
    if isinstance(tree, dict):
        return {k: _convert(v, device, f"{path}.{k}") for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype != np.float32:
        raise TypeError(f"{path}: expected float32 parameters, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def expected_keys(cfg: ModelConfig) -> set[str]:
    """The top-level parameter names of ``cfg``'s model."""
    want = {"embed", "final_norm", "layers"}
    if not cfg.tie_embeddings:
        want.add("unembed")
    if cfg.learned_positions:
        want.add("pos_embed")
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        want.add("shared")
    if cfg.family == "encdec":
        want |= {"enc_layers", "enc_norm", "enc_pos"}
    if cfg.family == "vlm" and cfg.n_patches:
        want.add("vis_proj")
    return want


def from_jax_params(params_np: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameters (nested dicts of float32 numpy arrays) as
    the port's: the same names and shapes, the stacked ``(n_layers, ...)``
    layer layout (``enc_layers``: ``(n_enc_layers, ...)``) and
    ``params["shared"]`` kept, on ``device`` (default: the card)."""
    check_family(cfg)
    device = resolve_device(device)
    want = expected_keys(cfg)
    if set(params_np) != want:
        raise ValueError(f"parameter keys {sorted(params_np)} do not match {cfg.name}'s "
                         f"{sorted(want)}")
    out = _convert(params_np, device, "params")
    for key, n in (("layers", cfg.n_layers), ("enc_layers", cfg.n_enc_layers)):
        if key not in out:
            continue
        lead = {t.shape[0] for t in leaves(out[key])}
        if lead != {n}:
            raise ValueError(f"stacked {key} have leading sizes {sorted(lead)}, expected {n}")
    return out


def from_jax_train_state(state_np: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's train state ``{"params", "opt": {"mu", "nu",
    "step"}}`` (numpy) as the port's: the parameters through
    :func:`from_jax_params`, the float32 moments in the same layout, and
    ``step`` an int32 scalar, all on ``device`` (default: the card)."""
    if set(state_np) != {"params", "opt"} or set(state_np["opt"]) != {"mu", "nu", "step"}:
        raise ValueError("expected a train state {'params', 'opt': {'mu', 'nu', 'step'}}")
    device = resolve_device(device)
    opt = state_np["opt"]
    step = np.asarray(opt["step"])
    if step.shape != () or step.dtype != np.int32:
        raise TypeError(f"opt.step must be an int32 scalar, got {step.dtype} {step.shape}")
    return {"params": from_jax_params(state_np["params"], cfg, device),
            "opt": {"mu": from_jax_params(opt["mu"], cfg, device),
                    "nu": from_jax_params(opt["nu"], cfg, device),
                    "step": torch.tensor(int(step), dtype=torch.int32, device=device)}}


def to_numpy_tree(tree):
    """A nested dict of tensors as numpy arrays on the host, the same keys
    and dtypes: the form the reference's trees take under
    ``jax.tree.map(np.asarray, ...)``."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
