"""Hash-partition kernel: the shuffle build side (paper §4.2).

Replaces the TPU kernel ``src/repro/kernels/hash_partition.py``,
``hash_partition`` (bodies ``_kernel_dest_only`` and ``_kernel``): the
lowbias32 hash of every key column, the boost-style column combine, the
destination ``hash % P`` and, optionally, the (P,) destination histogram.

Bound on the card: bytes. A call reads ``4 * n_cols`` bytes and writes a
4-byte destination per row, ``N * (4 * n_cols + 4)`` bytes at 3.35 TB/s
(H100 SXM data sheet); the integer arithmetic is far below the compute
roof. The CUDA kernel (``csrc/hash_partition.cu``) runs one thread per row
in a grid-stride loop and masks the ragged edge itself, so nothing is padded
and the histogram needs no pad correction. The histogram counts in shared
memory per block and adds each block's counts with integer atomics.

:func:`hash_partition_ref` is the plain PyTorch version. It computes in
int64 with ``& 0xFFFFFFFF`` after every step, because torch has no uint32
shifts, adds or remainders on the CPU; the multiplies wrap in int64 and
their low 32 bits are the uint32 product.
"""

from __future__ import annotations

import torch

from . import cuda_lib, registry

__all__ = ["hash_partition_ref", "hash_partition_cuda", "MASK32", "lowbias32",
           "combine_hash", "MAX_PARTITIONS"]

MASK32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9

#: the kernel's shared-memory histogram holds one int32 per partition in
#: the default 48 KB of shared memory
MAX_PARTITIONS = 12288


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 tensors holding uint32 values; returns the same."""
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def combine_hash(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Boost-style ``h ^ (x + golden + (h << 6) + (h >> 2))`` in uint32
    arithmetic on int64 tensors."""
    return h ^ ((x + _GOLDEN + ((h << 6) & MASK32) + (h >> 2)) & MASK32)


def _u32(keys: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the uint32 values."""
    return keys.to(torch.int64) & MASK32


def hash_partition_ref(keys: torch.Tensor, num_partitions: int,
                       with_hist: bool = True):
    """Plain version: (dest (N,) int32, hist (P,) int32 or None).

    ``keys`` is (N,) or (N, n_cols) int32 holding uint32 bit patterns
    (``partition.u32_normalize``)."""
    if keys.ndim == 1:
        keys = keys[:, None]
    h = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    for c in range(keys.shape[1]):
        h = combine_hash(h, lowbias32(_u32(keys[:, c])))
    dest = (h % num_partitions).to(torch.int32)
    if not with_hist:
        return dest, None
    hist = torch.bincount(dest, minlength=num_partitions).to(torch.int32)
    return dest, hist


def hash_partition_cuda(keys: torch.Tensor, num_partitions: int,
                        with_hist: bool = True):
    """The CUDA kernel: same contract as :func:`hash_partition_ref`."""
    if keys.ndim == 1:
        keys = keys[:, None]
    if not keys.is_cuda:
        raise ValueError(f"hash_partition_cuda needs a CUDA tensor, got {keys.device}")
    if keys.dtype != torch.int32:
        raise TypeError(f"hash_partition_cuda takes int32 key bits, got {keys.dtype}")
    if keys.ndim != 2:
        raise ValueError(f"keys must be (N,) or (N, n_cols), got {tuple(keys.shape)}")
    if not 1 <= num_partitions <= MAX_PARTITIONS:
        raise ValueError(f"num_partitions must be in [1, {MAX_PARTITIONS}]")
    keys = keys.contiguous()
    n, n_cols = keys.shape
    dest = torch.empty(n, dtype=torch.int32, device=keys.device)
    hist = (torch.zeros(num_partitions, dtype=torch.int32, device=keys.device)
            if with_hist else None)
    if n == 0:
        return dest, hist  # nothing to launch
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = lib.hash_partition_launch(
        keys.data_ptr(), n, n_cols, num_partitions, dest.data_ptr(),
        hist.data_ptr() if with_hist else None, stream)
    cuda_lib.check(err, "hash_partition")
    registry.count_launch("hash_partition")
    return dest, hist
