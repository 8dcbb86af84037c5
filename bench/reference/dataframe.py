"""Plain-PyTorch answers of the benchmark's dataframe pipelines.

Every function takes the flat input columns (1-D int32 tensors, as the
benchmark generated them) and returns the answer as flat columns sorted by
key. The engine's semantics, as its documentation states them: int32 sums
wrap modulo 2**32, counts are exact, min and max are of the left values, a
mean is ``float32(sum) / float32(count)``, and after a join on ``c0`` the
left table's ``c1`` keeps its name.

A join followed by a groupby on the join key needs no join rows: key ``k``
has ``cnt_l[k] * cnt_r[k]`` of them, and each left value appears
``cnt_r[k]`` times among them.

``control=True`` is the benchmark's control: the same answer with every
sum accumulated in float32 (a 24-bit significand) instead of exactly, the
step below int32 that a faster aggregation would tempt; the sort's control
orders the int32 keys by their float32 values, and the unique's control
tells keys apart by their float32 values.
"""

from __future__ import annotations

import torch

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values to int32 modulo 2**32, as int32 sums wrap."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)


def _key_space(*keys: torch.Tensor) -> int:
    return max([int(k.max()) + 1 for k in keys if k.numel()] + [1])


def _left_aggregates(kl, vl, nk: int, control: bool):
    """Per key of the left rows: count, sum (int64, or float32 for the
    control), min and max of the values."""
    kl = kl.long()
    cnt = torch.bincount(kl, minlength=nk)
    if control:
        total = torch.zeros(nk, dtype=torch.float32, device=kl.device).index_add_(
            0, kl, vl.to(torch.float32))
    else:
        total = torch.zeros(nk, dtype=torch.int64, device=kl.device).index_add_(0, kl, vl.long())
    lo = torch.full((nk,), INT32_MAX, dtype=torch.int64, device=kl.device).scatter_reduce_(
        0, kl, vl.long(), "amin")
    hi = torch.full((nk,), INT32_MIN, dtype=torch.int64, device=kl.device).scatter_reduce_(
        0, kl, vl.long(), "amax")
    return cnt, total, lo, hi


def _scaled_sum(total: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """``total * times`` wrapped to int32; a float32 total (the control)
    is multiplied in float32 too."""
    if total.dtype == torch.float32:
        return wrap32((total * times.to(torch.float32)).to(torch.float64).round().long())
    return wrap32(total * times)


def join_groupby(lk, lv, rk, control: bool = False) -> dict:
    """``L.join(R, on=c0)`` then ``groupby(c0)`` with sum, min, max, count
    and mean of the left ``c1``. Returns the groups sorted by ``c0`` and
    ``join_rows``, the join's row count."""
    nk = _key_space(lk, rk)
    cnt_l, total, lo, hi = _left_aggregates(lk, lv, nk, control)
    cnt_r = torch.bincount(rk.long(), minlength=nk)
    keys = torch.nonzero((cnt_l > 0) & (cnt_r > 0)).squeeze(1)
    s = _scaled_sum(total[keys], cnt_r[keys])
    count = (cnt_l[keys] * cnt_r[keys]).to(torch.int32)
    return {"c0": keys.to(torch.int32), "c1_sum": s, "c1_min": lo[keys].to(torch.int32),
            "c1_max": hi[keys].to(torch.int32), "c1_count": count,
            "c1_mean": s.to(torch.float32) / count.to(torch.float32),
            "join_rows": int((cnt_l * cnt_r).sum())}


def readme_lazy(lk, lv, rk, select_below: int, flag_below: int, control: bool = False) -> dict:
    """The README's lazy query: keep the left rows with ``c1 <
    select_below``, add ``c2 = 1 if c1 < flag_below else 0``, join with
    the right table on ``c0``, group by ``c0``: sum, min, max, count of
    ``c1``, its mean as ``avg``, and the sum of ``c2``."""
    keep = lv < select_below
    kl, vl = lk[keep], lv[keep]
    nk = _key_space(kl, rk)
    cnt_l, total, lo, hi = _left_aggregates(kl, vl, nk, control)
    flagged = torch.bincount(kl[vl < flag_below].long(), minlength=nk)
    cnt_r = torch.bincount(rk.long(), minlength=nk)
    keys = torch.nonzero((cnt_l > 0) & (cnt_r > 0)).squeeze(1)
    s = _scaled_sum(total[keys], cnt_r[keys])
    count = (cnt_l[keys] * cnt_r[keys]).to(torch.int32)
    return {"c0": keys.to(torch.int32), "c1_sum": s, "c1_min": lo[keys].to(torch.int32),
            "c1_max": hi[keys].to(torch.int32), "c1_count": count,
            "avg": s.to(torch.float32) / count.to(torch.float32),
            "c2_sum": wrap32(flagged[keys] * cnt_r[keys])}


def sort_rows(k, v, control: bool = False) -> dict:
    """``sort_values("c1")`` of the table ``(c0=k, c1=v)``: the rows in
    ascending ``c1``. Rows with equal ``c1`` may come in any order, so a
    comparison holds ``c1``'s sequence and the multiset of rows. The
    control orders by ``c1`` in float32."""
    key = v.to(torch.float32) if control else v
    order = torch.argsort(key, stable=True)
    return {"c0": k[order], "c1": v[order]}


def unique_rows(k, v, control: bool = False) -> dict:
    """``unique(c0)`` of the table ``(c0=k, c1=v)``: one row per distinct
    key, sorted by key. Which row of a key stays is the program's choice,
    so a comparison holds the keys and checks that every row kept is a row
    of the table; here the first row of each key stays. The control keeps
    one row per distinct float32 key, that key rounded back to int32."""
    key = k.to(torch.float32) if control else k
    keys, inverse = torch.unique(key, return_inverse=True)
    n = torch.arange(k.numel(), device=k.device)
    first = torch.full((keys.numel(),), k.numel(), dtype=n.dtype, device=k.device)
    first.scatter_reduce_(0, inverse, n, "amin")
    return {"c0": keys.to(torch.int32), "c1": v[first]}
