"""The comparisons that decide ``correct``: each returns how many rows or
positions of an answer differ from the reference's, so that an exact
answer reads 0."""

from __future__ import annotations

import torch

from .digest import bits64


def rows_off(got: dict, exp: dict, key: str) -> int:
    """Rows of ``got`` (flat columns in any row order) that differ from
    ``exp`` (flat columns sorted by the unique ``key``), comparing 32-bit
    patterns, so a float must match bit for bit. Different column names or
    row counts make every row count as off."""
    n_got, n_exp = int(got[key].numel()), int(exp[key].numel())
    if set(got) != set(exp) or n_got != n_exp:
        return max(n_got, n_exp, 1)
    order = torch.argsort(got[key].to(torch.int64), stable=True)
    bad = torch.zeros(n_exp, dtype=torch.bool, device=exp[key].device)
    for name, e in exp.items():
        bad |= bits64(got[name][order]) != bits64(e)
    return int(bad.sum())


def seq_off(got: torch.Tensor, exp: torch.Tensor) -> int:
    """Positions at which two sequences differ (every position when their
    lengths do)."""
    if got.numel() != exp.numel():
        return max(int(got.numel()), int(exp.numel()), 1)
    if got.dtype != torch.int64:  # 32-bit columns compare by their patterns
        got, exp = bits64(got), bits64(exp)
    return int((got != exp).sum())


def rows_not_in(got: dict, table_rows: torch.Tensor) -> int:
    """Rows ``(c0, c1)`` of ``got`` that are no row of the table whose
    ``sorted_pairs`` are ``table_rows``."""
    x = (got["c1"].to(torch.int64) << 32) | bits64(got["c0"])
    if x.numel() == 0:
        return 0
    if table_rows.numel() == 0:
        return int(x.numel())
    at = torch.searchsorted(table_rows, x).clamp(max=table_rows.numel() - 1)
    return int((table_rows[at] != x).sum())


def sorted_pairs(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The rows ``(v, k)`` packed into int64 and sorted: equal for two
    tables that hold the same rows in any order."""
    return torch.sort((v.to(torch.int64) << 32) | bits64(k)).values
