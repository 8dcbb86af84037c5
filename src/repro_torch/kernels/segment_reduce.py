"""Segment-reduce kernel: the combine and merge legs of every groupby
(Combine-Shuffle-Reduce, paper §5.3.4).

Replaces the TPU kernel ``src/repro/kernels/segment_reduce.py``,
``segment_reduce_partials`` (body ``_kernel``), and the partials merge that
``src/repro/kernels/ops.py::segment_reduce`` ran after it: values sorted by
non-decreasing int32 segment ids reduce to one row per segment (sum, min or
max) in the value dtype. Integer sums wrap as ``jax.ops.segment_sum`` does;
empty segments hold the identity (0 or the ``dataframe`` sentinel); ids
outside ``[0, num_segments)`` are dropped. As in the reference, float min and
max order -0.0 below +0.0 and return NaN for any segment holding a NaN, float
sums add into +0.0, and a bool sum raises ``TypeError``.

Bound on the card: bytes, ``N * (4 + width * esize)`` read plus
``num_segments * width * esize`` written, at 3.35 TB/s (H100 SXM data sheet).
The CUDA kernel (``csrc/segment_reduce.cu``) streams 4096-row tiles through
a shared-memory ring with persistent blocks, reduces each thread's 16
consecutive rows run by run (into shared atomics for dense tiles, a block
scan otherwise), and finishes segments that cross a tile edge in a second
pass over one word per tile; every output element, empty ones included, is
written once, so the output starts as ``torch.empty``. Min and max compare
order-preserving integer keys. Float sums combine in another order than the
reference's, so they are exact only on integer-valued floats.

:func:`segment_reduce_ref` is the plain PyTorch version. It reduces
integers in int64 and wraps the result back, which also serves uint32,
whose arithmetic torch lacks on the CPU, and reduces float min and max on
the same integer keys as the kernel.
"""

from __future__ import annotations

import torch

from ..core.dataframe import max_sentinel, min_sentinel
from . import cuda_lib, registry

__all__ = ["segment_reduce_ref", "segment_reduce_cuda", "identity", "OPS"]

OPS = ("sum", "min", "max")
_DTYPE_CODE = {torch.int32: 0, torch.uint32: 1, torch.float32: 2, torch.bool: 3,
               torch.int8: 4, torch.uint8: 5, torch.int16: 6, torch.float16: 7}
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}
_ALIGN = 16  # the kernel loads ids and values 16 bytes at a time


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
    if op == "sum" and values.dtype == torch.bool:
        raise TypeError("segment sum does not accept dtype bool")


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of float bits (float16 widened exactly):
    -0.0 sorts below +0.0. The map is its own inverse."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _key_float(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bits = key ^ ((key >> 31) & 0x7FFFFFFF)
    return bits.to(torch.int32).view(torch.float32).to(dtype)


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """Plain version: (num_segments, width) in the value dtype."""
    _check(values, seg_ids, op)
    dtype = values.dtype
    width = values.shape[1]
    float_minmax = dtype.is_floating_point and op != "sum"
    if float_minmax:
        # a NaN takes the key that wins, so any NaN gives NaN
        nan_key = -2**31 if op == "min" else 2**31 - 1
        work = torch.where(values.isnan(), nan_key, _float_key(values))
        fill = int(_float_key(torch.tensor(identity(op, torch.float32))))
    elif dtype == torch.uint32:
        work = values.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        fill = identity(op, dtype)
    elif dtype.is_floating_point:
        work, fill = values, 0  # sums add into +0.0
    else:
        work, fill = values.to(torch.int64), identity(op, dtype)
    out = torch.full((num_segments + 1, width), fill, dtype=work.dtype,
                     device=values.device)
    ids = seg_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out.scatter_reduce_(0, ids[:, None].expand(-1, width), work,
                        reduce=_REDUCE[op], include_self=True)
    out = out[:num_segments]
    if float_minmax:
        return _key_float(out, dtype)
    if dtype == torch.uint32:
        return out.to(torch.int32).view(torch.uint32)
    return out.to(dtype)


def segment_reduce_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int, op: str = "sum") -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`segment_reduce_ref`, for
    sorted ids and the value dtypes of the port's tables."""
    _check(values, seg_ids, op)
    if values.dtype not in _DTYPE_CODE:
        names = ", ".join(str(d).removeprefix("torch.") for d in _DTYPE_CODE)
        raise TypeError(f"segment_reduce_cuda takes {names} values, got {values.dtype}")
    if not (values.is_cuda and seg_ids.is_cuda):
        raise ValueError("segment_reduce_cuda needs CUDA tensors")
    values = values.contiguous()
    seg_ids = seg_ids.contiguous()
    # a view may start off the 16-byte grid; a copy does not
    if values.data_ptr() % _ALIGN:
        values = values.clone()
    if seg_ids.data_ptr() % _ALIGN:
        seg_ids = seg_ids.clone()
    n, width = values.shape
    if n == 0 or width == 0 or num_segments == 0:  # nothing to launch
        return torch.full((num_segments, width), identity(op, values.dtype),
                          dtype=values.dtype, device=values.device)
    out = torch.empty((num_segments, width), dtype=values.dtype, device=values.device)
    lib = cuda_lib.load()
    scratch = torch.empty(lib.segment_reduce_scratch_bytes(n, width, num_segments),
                          dtype=torch.uint8, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.segment_reduce_launch(
        values.data_ptr(), seg_ids.data_ptr(), n, width, num_segments,
        _DTYPE_CODE[values.dtype], _OP_CODE[op], out.data_ptr(), scratch.data_ptr(), stream)
    cuda_lib.check(err, "segment_reduce")
    registry.count_launch("segment_reduce")
    return out
