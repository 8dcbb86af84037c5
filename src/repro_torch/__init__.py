"""PyTorch/CUDA port of the ``repro`` distributed-dataframe engine.

The P workers of the reference's device mesh are the leading dimension of
every tensor on one NVIDIA H100; the hash-partition and segment-reduce hot
paths run hand-written Hopper kernels (``repro_torch/csrc``). The package
imports ``torch`` and numpy only.
"""
