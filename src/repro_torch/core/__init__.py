"""The paper's core: distributed dataframe patterns over the P workers of
one card.

Public surface:
- ``Table`` -- the batched (P, capacity) row partitions
- ``DDF`` / ``DDFContext`` -- the distributed dataframe + execution env
- ``operators`` -- the distributed operators of this slice
- ``cost_model`` / ``patterns`` -- costs and strategy selection (§5.4)
- ``comm`` -- the communicator and table collectives
"""

from . import comm, cost_model, local_ops, operators, partition, patterns  # noqa: F401
from .api import DDF, DDFContext  # noqa: F401
from .dataframe import Table, from_numpy, to_numpy  # noqa: F401
