"""Synthetic data (paper §6 methodology): uniformly random int tables at a
controlled key cardinality, zipf-skewed variants, and a token corpus.
Numpy only; the same generators as the reference's ``data/synthetic.py``,
so both packages get the same rows from a seed."""

from __future__ import annotations

import numpy as np

__all__ = ["uniform_table", "zipf_table", "synthetic_token_corpus"]


def uniform_table(n_rows: int, cardinality: float = 0.9, n_cols: int = 2,
                  seed: int = 0, dtype=np.int32) -> dict[str, np.ndarray]:
    """Paper §6: uniform random, cardinality C => keys drawn from C*n values."""
    rng = np.random.default_rng(seed)
    n_keys = max(int(n_rows * cardinality), 1)
    cols = {"c0": rng.integers(0, n_keys, size=n_rows).astype(dtype)}
    for i in range(1, n_cols):
        cols[f"c{i}"] = rng.integers(0, np.iinfo(np.int32).max, size=n_rows).astype(dtype)
    return cols


def zipf_table(n_rows: int, a: float = 1.5, n_cols: int = 2, seed: int = 0,
               dtype=np.int32) -> dict[str, np.ndarray]:
    """Skewed keys (paper §5.4.2 data-distribution discussion)."""
    rng = np.random.default_rng(seed)
    keys = rng.zipf(a, size=n_rows).astype(dtype)
    cols = {"c0": keys}
    for i in range(1, n_cols):
        cols[f"c{i}"] = rng.integers(0, np.iinfo(np.int32).max, size=n_rows).astype(dtype)
    return cols


def synthetic_token_corpus(n_docs: int, vocab: int, mean_len: int = 512,
                           dup_fraction: float = 0.2, seed: int = 0):
    """Documents with controlled duplication (for the dedup stage) and
    variable lengths (for the sort/bucketing stage)."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(8, rng.poisson(mean_len, n_docs)).astype(np.int32)
    doc_id = np.arange(n_docs, dtype=np.int32)
    # duplicated docs share a content hash
    n_unique = max(int(n_docs * (1 - dup_fraction)), 1)
    content = rng.integers(0, n_unique, size=n_docs).astype(np.int32)
    lens = lens[content % len(lens)]  # duplicates share length
    return {"doc_id": doc_id, "content_hash": content, "length": lens,
            "quality": rng.random(n_docs).astype(np.float32)}
