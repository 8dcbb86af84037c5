"""The paper's own workload config: two-int64-column uniform tables at 90%
cardinality (paper §6), driving the DDF operator benchmarks. A host-only
dataclass, copied from the reference's ``configs/paper_cylon.py``; it is not
a model, so it stays out of ``ARCHS``."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class CylonWorkload:
    rows_per_worker: int = 25_000_000   # paper weak-scaling: 25M/worker
    n_columns: int = 2
    dtype: str = "int64"                # int32 under default jax x64=off; the port's tables are int32
    cardinality: float = 0.9            # worst case for key ops (paper §6)
    key_column: str = "c0"


CONFIG = CylonWorkload()


def smoke_config():
    return CylonWorkload(rows_per_worker=2000)
