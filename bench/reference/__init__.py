"""The benchmark's plain reference: the same relational answers worked out
again in plain PyTorch from the inputs the benchmark hands to the program,
and the comparisons that decide ``correct``.

Nothing here imports the program, JAX or the JAX package: the answers come
from bincounts, scatter reductions and one sort, on whatever device the
inputs lie on.
"""

from .compare import rows_not_in, rows_off, seq_off, sorted_pairs
from .dataframe import join_groupby, readme_lazy, sort_rows, unique_rows
from .digest import order_violations, row_digest

__all__ = ["join_groupby", "readme_lazy", "sort_rows", "unique_rows", "row_digest",
           "order_violations", "rows_off", "rows_not_in", "seq_off", "sorted_pairs"]
