"""The yardstick's peaks and the kernels' byte formulas, frozen.

Peaks of one NVIDIA H100 SXM, from NVIDIA's data sheet (dense, no
sparsity): 3.35 TB/s of HBM and 989 TFLOP/s in bf16. The dataframe kernels
do no floating-point products, so their least time is their bytes over the
bandwidth: each input byte read once, each output byte written once, as
the port's kernel table has counted them (hash_partition at 200M x 1 int32
keys: 0.4776 ms; segment_reduce at 400,000,512 x 1 int32 rows with as many
segments: 1.4328 ms).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def hash_partition_bytes(n: int, n_cols: int, num_partitions: int, with_hist: bool) -> float:
    """The int32 keys read; the int32 destinations (and the histogram)
    written."""
    return float(n * (4 * n_cols + 4) + (4 * num_partitions if with_hist else 0))


def segment_reduce_bytes(n: int, width: int, num_segments: int, itemsize: int) -> float:
    """The int32 segment ids and the values read; one output row per
    segment written."""
    return float(n * (4 + width * itemsize) + num_segments * width * itemsize)


def least_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3
