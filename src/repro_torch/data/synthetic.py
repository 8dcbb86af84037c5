"""Synthetic data (paper §6 methodology): uniformly random int tables at a
controlled key cardinality. Numpy only; the same generator as the
reference's ``data/synthetic.py``, so both packages get the same rows from a
seed."""

from __future__ import annotations

import numpy as np

__all__ = ["uniform_table"]


def uniform_table(n_rows: int, cardinality: float = 0.9, n_cols: int = 2,
                  seed: int = 0, dtype=np.int32) -> dict[str, np.ndarray]:
    """Paper §6: uniform random, cardinality C => keys drawn from C*n values."""
    rng = np.random.default_rng(seed)
    n_keys = max(int(n_rows * cardinality), 1)
    cols = {"c0": rng.integers(0, n_keys, size=n_rows).astype(dtype)}
    for i in range(1, n_cols):
        cols[f"c{i}"] = rng.integers(0, np.iinfo(np.int32).max, size=n_rows).astype(dtype)
    return cols
