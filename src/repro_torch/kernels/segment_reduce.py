"""Segment-reduce kernel: the combine and merge legs of every groupby
(Combine-Shuffle-Reduce, paper §5.3.4).

Replaces the TPU kernel ``src/repro/kernels/segment_reduce.py``,
``segment_reduce_partials`` (body ``_kernel``), and the partials merge that
``src/repro/kernels/ops.py::segment_reduce`` ran after it: values sorted by
non-decreasing int32 segment ids reduce to one row per segment (sum, min or
max) in the value dtype. Integer sums wrap as ``jax.ops.segment_sum`` does;
empty segments hold the identity (0 or the ``dataframe`` sentinel); ids
outside ``[0, num_segments)`` are dropped.

Bound on the card: bytes, ``N * (4 * width + 4)`` read plus
``num_segments * width * 4`` written, at 3.35 TB/s (H100 SXM data sheet).
The TPU kernel's one-hot (block x max_segments) matmul existed because the
TPU has no atomics. The CUDA kernel (``csrc/segment_reduce.cu``) fuses the
merge instead: each warp reduces the runs of its 32 rows with a segmented
shuffle reduction and stores a run that lies wholly inside the warp
directly; only runs that continue into a neighbouring warp's rows use an
atomic, at most two per warp. Float sums then combine in an order that
varies from run to run, so they are exact only on integer-valued floats.

:func:`segment_reduce_ref` is the plain PyTorch version. It reduces
integers in int64 and wraps the result back, which also serves uint32,
whose arithmetic torch lacks on the CPU.
"""

from __future__ import annotations

import torch

from ..core.dataframe import max_sentinel, min_sentinel
from . import cuda_lib, registry

__all__ = ["segment_reduce_ref", "segment_reduce_cuda", "identity", "OPS"]

OPS = ("sum", "min", "max")
_DTYPE_CODE = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}


def identity(op: str, dtype: torch.dtype):
    """The value an empty segment holds for ``op`` in ``dtype``."""
    if op == "sum":
        return 0
    if op == "min":
        return max_sentinel(dtype)
    if op == "max":
        return min_sentinel(dtype)
    raise ValueError(op)


def _check(values: torch.Tensor, seg_ids: torch.Tensor, op: str):
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if values.ndim != 2:
        raise ValueError(f"values must be (N, width), got {tuple(values.shape)}")
    if seg_ids.shape != values.shape[:1]:
        raise ValueError(f"seg_ids {tuple(seg_ids.shape)} do not match values "
                         f"{tuple(values.shape)}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"seg_ids must be int32, got {seg_ids.dtype}")


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """Plain version: (num_segments, width) in the value dtype."""
    _check(values, seg_ids, op)
    dtype = values.dtype
    width = values.shape[1]
    if dtype == torch.uint32:
        work = values.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    elif dtype.is_floating_point:
        work = values
    else:
        work = values.to(torch.int64)
    fill = identity(op, dtype)
    out = torch.full((num_segments + 1, width), fill, dtype=work.dtype,
                     device=values.device)
    ids = seg_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out.scatter_reduce_(0, ids[:, None].expand(-1, width), work,
                        reduce=_REDUCE[op], include_self=True)
    out = out[:num_segments]
    if dtype == torch.uint32:
        return out.to(torch.int32).view(torch.uint32)
    return out.to(dtype)


def segment_reduce_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int, op: str = "sum") -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`segment_reduce_ref`, for
    int32, uint32 and float32 values and sorted ids."""
    _check(values, seg_ids, op)
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"segment_reduce_cuda takes int32, uint32 or float32, "
                        f"got {values.dtype}: other value dtypes are not ported "
                        f"to the card yet (ROADMAP queue A)")
    if not (values.is_cuda and seg_ids.is_cuda):
        raise ValueError("segment_reduce_cuda needs CUDA tensors")
    values = values.contiguous()
    seg_ids = seg_ids.contiguous()
    n, width = values.shape
    out = torch.full((num_segments, width), identity(op, values.dtype),
                     dtype=values.dtype, device=values.device)
    if n == 0 or width == 0 or num_segments == 0:
        return out  # nothing to launch
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.segment_reduce_launch(
        values.data_ptr(), seg_ids.data_ptr(), n, width, num_segments,
        _DTYPE_CODE[values.dtype], _OP_CODE[op], out.data_ptr(), stream)
    cuda_lib.check(err, "segment_reduce")
    registry.count_launch("segment_reduce")
    return out
