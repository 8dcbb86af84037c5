"""Hand-written Hopper kernels behind device dispatch.

- ``hash_partition`` -- the shuffle build side (destinations + histogram);
- ``segment_reduce`` -- the groupby combine and merge legs;
- ``flash_attention`` -- the model layer's full-sequence attention;
- ``ssd_scan`` -- the Mamba-2 mixer's chunked state-space scan.

``ops`` holds the dispatching wrappers, ``registry`` the mode override and
the launch counts, ``cuda_lib`` the build of ``csrc/*.cu``. Each kernel's
module also holds its plain PyTorch version, which runs on CPU tensors.
"""

from . import ops, registry  # noqa: F401
from .ops import (  # noqa: F401
    flash_attention,
    hash_partition,
    partition_histogram,
    segment_reduce,
    segment_reduce_partials,
    ssd_scan,
)
from .registry import (  # noqa: F401
    dispatch_signature,
    get_backend,
    launch_counts,
    reset_launch_counts,
    resolve,
    set_backend,
    use_backend,
)

__all__ = [
    "ops",
    "registry",
    "hash_partition",
    "partition_histogram",
    "segment_reduce",
    "segment_reduce_partials",
    "flash_attention",
    "ssd_scan",
    "set_backend",
    "get_backend",
    "use_backend",
    "resolve",
    "dispatch_signature",
    "launch_counts",
    "reset_launch_counts",
]
