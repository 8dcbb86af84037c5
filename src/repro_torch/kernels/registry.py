"""Kernel dispatch: route the hot paths to the Hopper kernels or to their
plain PyTorch versions, and count the launches.

Modes:

- ``"auto"`` (default) -- decide by device: a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version, a ``meta`` tensor to the
  kernel's wrapper, which stands in for the card there: it allocates the
  kernel's outputs (and the scratch it sizes itself) and launches nothing;
- ``"cuda"`` -- always the kernel; a CPU tensor raises;
- ``"torch"`` -- always the plain version (on either device), for A/B
  comparisons on the card.

The mode starts as ``"auto"``; callers switch it with :func:`set_backend`,
:func:`use_backend` or the wrappers' ``force=``. There is no row-count
threshold: the kernels launch at every size until H100 timings say where
the plain version wins (ROADMAP, "Not ported, by design"). There is no dtype gate
either: a CUDA tensor of a dtype a kernel does not take raises in the
kernel's wrapper.

Every kernel wrapper calls :func:`count_launch` exactly where it launches
its kernel, so a run can show that it went through the kernels. A launch
and a meta stand-in also call :func:`add_work` with the call's flops and
bytes by the kernel's formula (the bound of PERF.md's kernel table): work
inside a kernel is invisible to PyTorch's dispatcher, so
``launch.op_cost`` reads it here.
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
    "add_work",
    "kernel_work",
]

#: the launch counters: one per kernel, and one for hash_partition's
#: histogram variant (its own ``pallas_call`` in the reference), so that a
#: run shows which of the two it launched
KERNEL_OPS = ("hash_partition", "hash_partition_hist", "segment_reduce", "flash_attention",
              "ssd_scan")

_VALID = ("auto", "cuda", "torch")

_backend = "auto"

_launches = {k: 0 for k in KERNEL_OPS}

# per kernel: calls (launches and meta stand-ins), flops and bytes by the
# kernel's formula, since the process started
_work = {k: [0, 0.0, 0.0] for k in KERNEL_OPS}


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
    forced "cuda" mode on a CPU tensor raises; a meta tensor takes the
    kernel's route unless the plain version is pinned."""
    if kernel not in KERNEL_OPS:
        raise ValueError(f"unknown kernel {kernel!r}; expected {KERNEL_OPS}")
    if _backend == "torch":
        return "torch"
    if x.device.type == "meta":
        return "cuda"  # the wrapper's meta stand-in
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


def add_work(kernel: str, flops: float, nbytes: float) -> None:
    """Add one call of ``kernel`` doing ``flops`` and moving ``nbytes`` by
    its formula; called by its wrapper at the launch and by its meta
    stand-in."""
    w = _work[kernel]
    w[0] += 1
    w[1] += flops
    w[2] += nbytes


def kernel_work() -> dict[str, dict]:
    """Snapshot of every kernel's {"calls", "flops", "bytes"} so far (never
    reset: readers take differences)."""
    return {k: {"calls": c, "flops": f, "bytes": b} for k, (c, f, b) in _work.items()}
