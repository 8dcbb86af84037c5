"""Kernel dispatch: route the hot paths to the Hopper kernels or to their
plain PyTorch versions, and count the launches.

Modes:

- ``"auto"`` (default) -- decide by device: a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version;
- ``"cuda"`` -- always the kernel; a CPU tensor raises;
- ``"torch"`` -- always the plain version (on either device), for A/B
  comparisons on the card.

The mode starts as ``"auto"``; callers switch it with :func:`set_backend`,
:func:`use_backend` or the wrappers' ``force=``. There is no row-count
threshold: the kernels launch at every size until H100 timings say where
the plain version wins (ROADMAP queue A item 2). There is no dtype gate
either: a CUDA tensor of a dtype a kernel does not take raises in the
kernel's wrapper.

Every kernel wrapper calls :func:`count_launch` exactly where it launches
its kernel, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = [
    "KERNEL_OPS",
    "set_backend",
    "get_backend",
    "use_backend",
    "resolve",
    "dispatch_signature",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
]

#: the launch counters: one per kernel, and one for hash_partition's
#: histogram variant (its own ``pallas_call`` in the reference), so that a
#: run shows which of the two it launched
KERNEL_OPS = ("hash_partition", "hash_partition_hist", "segment_reduce", "flash_attention",
              "ssd_scan")

_VALID = ("auto", "cuda", "torch")

_backend = "auto"

_launches = {k: 0 for k in KERNEL_OPS}


def set_backend(mode: str) -> str:
    """Set the process-wide kernel mode; returns the previous one."""
    global _backend
    if mode not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {mode!r}")
    prev = _backend
    _backend = mode
    return prev


def get_backend() -> str:
    """Current mode: "auto" | "cuda" | "torch"."""
    return _backend


@contextlib.contextmanager
def use_backend(mode: str):
    """Context manager form of :func:`set_backend` (restores on exit)."""
    prev = set_backend(mode)
    try:
        yield
    finally:
        set_backend(prev)


def resolve(kernel: str, x: torch.Tensor) -> str:
    """"cuda" or "torch" for one call of ``kernel`` on tensor ``x``. A
    forced "cuda" mode on a CPU tensor raises."""
    if kernel not in KERNEL_OPS:
        raise ValueError(f"unknown kernel {kernel!r}; expected {KERNEL_OPS}")
    if _backend == "torch":
        return "torch"
    if not x.is_cuda:
        if _backend == "cuda":
            raise RuntimeError(
                f"kernel backend 'cuda' forced, but the {kernel} input lies on {x.device}")
        return "torch"
    return "cuda"


def dispatch_signature() -> tuple:
    """Every global input to :func:`resolve` -- for any cache keyed on
    kernel routing."""
    return (_backend,)


def count_launch(kernel: str) -> None:
    """Add one launch of ``kernel``; called by its wrapper at the launch."""
    _launches[kernel] += 1


def launch_counts() -> dict[str, int]:
    """Snapshot of the launch counts since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
