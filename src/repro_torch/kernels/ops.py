"""Dispatching wrappers for the dataframe and model-layer kernels.

Each wrapper asks :mod:`~repro_torch.kernels.registry` for a mode: a CUDA
tensor launches the Hopper kernel, a CPU tensor runs the kernel's plain
PyTorch version, and ``force`` pins ``"cuda"`` or ``"torch"``. Results are
the same in both modes: bit for bit for hashes, destinations, histograms,
integer aggregates and min/max; float sums, attention and the SSD scan up
to summation order.
"""

from __future__ import annotations

import torch

from . import registry
from .flash_attention import flash_attention_cuda, flash_attention_ref
from .hash_partition import hash_partition_cuda, hash_partition_ref
from .segment_reduce import segment_reduce_cuda, segment_reduce_ref
from .ssd_scan import ssd_scan_cuda, ssd_scan_ref

__all__ = ["hash_partition", "partition_histogram", "segment_reduce",
           "segment_reduce_partials", "flash_attention", "ssd_scan"]


def _mode(kernel: str, x: torch.Tensor, force: str | None) -> str:
    if force is None:
        return registry.resolve(kernel, x)
    if force not in ("cuda", "torch"):
        raise ValueError(f"force must be 'cuda' or 'torch', got {force!r}")
    return force


def hash_partition(keys: torch.Tensor, num_partitions: int, *,
                   force: str | None = None, with_hist: bool = True):
    """Destination partition per row, plus the (P,) histogram.

    Args:
      keys: (N,) or (N, n_cols) int32 holding uint32 key bits
        (``partition.u32_normalize`` makes them from any column dtype).
      num_partitions: P.
      force: pin "cuda" | "torch" (default: registry dispatch).
      with_hist: False skips the histogram and returns ``hist=None``, as
        the shuffle build side (``partition.hash_partition_ids``) does.

    Returns:
      (dest (N,) int32, hist (P,) int32 | None).
    """
    if _mode("hash_partition", keys, force) == "cuda":
        return hash_partition_cuda(keys, num_partitions, with_hist=with_hist)
    return hash_partition_ref(keys, num_partitions, with_hist=with_hist)


def partition_histogram(keys: torch.Tensor, num_partitions: int, *,
                        force: str | None = None) -> torch.Tensor:
    """(P,) int32 destination counts of the shuffle keys: the histogram
    output of the same :func:`hash_partition` pass."""
    _, hist = hash_partition(keys, num_partitions, force=force, with_hist=True)
    return hist


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                   *, op: str = "sum", force: str | None = None) -> torch.Tensor:
    """Segment reduction over sorted segment ids.

    Args:
      values: (N, width) value rows, sorted by ``seg_ids``.
      seg_ids: (N,) int32, non-decreasing.
      num_segments: rows of the output; ids outside ``[0, num_segments)``
        are dropped (the callers' overflow bucket).
      op: "sum" | "min" | "max".
      force: pin "cuda" | "torch" (default: registry dispatch). Both take
        every value dtype of the port's tables (bool, int8, uint8, int16,
        int32, uint32, float16, float32); a bool sum raises ``TypeError``,
        as in the reference, and other dtypes raise it on the card.

    Returns:
      (num_segments, width) in the value dtype; empty segments hold the
      identity (0, or the min/max sentinel).
    """
    if _mode("segment_reduce", values, force) == "cuda":
        return segment_reduce_cuda(values, seg_ids, num_segments, op)
    return segment_reduce_ref(values, seg_ids, num_segments, op)


def segment_reduce_partials(values: torch.Tensor, seg_ids: torch.Tensor, *,
                            op: str = "sum", force: str | None = None):
    """The reference's per-block partials, in the fused form: one partial
    per segment id in ``[0, max id]``, with ids ``arange``. Kept so callers
    of the reference's name find it; :func:`segment_reduce` is the entry
    point the engine uses."""
    nseg = int(seg_ids.max().item()) + 1 if seg_ids.numel() else 0
    out = segment_reduce(values, seg_ids, nseg, op=op, force=force)
    ids = torch.arange(nseg, dtype=torch.int32, device=values.device)
    return out, ids


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    force: str | None = None) -> torch.Tensor:
    """(B, S, H, hd) x (B, S, KV, hd)^2 -> (B, S, H, hd) attention.

    Args:
      q, k, v: bf16 or float32; K/V head ``h // (H // KV)`` serves query
        head ``h``.
      causal: mask keys after the query.
      window: sliding window (key ``t`` visible when ``t > r - window``);
        a window of at least S hides nothing and is dropped, so the
        hybrid model's "full" window (int32 max // 2) needs no overflow
        care.
      softcap: logit softcap ``c * tanh(s / c)``.
      scale: score scale (default ``hd ** -0.5``).
      force: pin "cuda" | "torch" (default: registry dispatch).
    """
    if window is not None and int(window) >= q.shape[1]:
        window = None
    elif window is not None:
        window = int(window)
    if _mode("flash_attention", q, force) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                               scale=scale)


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = 128, force: str | None = None):
    """Mamba-2 SSD chunked scan plus ``D * x``.

    Args:
      x: (b, L, H, dh) float32; dt: (b, L, H); A, D: (H,); B, C:
        (b, L, G, ds), shared by the ``H // G`` heads of a group.
      chunk: steps per chunk; L need not be a multiple of it.
      force: pin "cuda" | "torch" (default: registry dispatch).

    Returns:
      (y (b, L, H, dh), final state (b, H, dh, ds) float32).
    """
    if _mode("ssd_scan", x, force) == "cuda":
        return ssd_scan_cuda(x, dt, A, B, C, D, chunk=chunk)
    return ssd_scan_ref(x, dt, A, B, C, D, chunk=chunk)
