"""What the pipelines share: reading a program's DDF back as flat live
columns (after the window), its padded buffers with their live counts
(inside it), and the overflow counters of its operators' infos."""

from __future__ import annotations

import torch


def live_columns(ddf):
    """Yield ``(name, flat live values)`` of a DDF's columns, worker by
    worker in worker order, one column at a time."""
    counts = ddf.counts
    for name in sorted(ddf.columns):
        v = ddf.columns[name]
        mask = torch.arange(v.shape[1], device=v.device)[None, :] < counts[:, None]
        yield name, v[mask]


def live(ddf) -> dict:
    return dict(live_columns(ddf))


def padded(ddf, names=None) -> tuple[dict, torch.Tensor]:
    """A DDF's ``(P, capacity)`` columns (all, or ``names``) and its live
    row counts, as it holds them: nothing is copied."""
    return {n: ddf.columns[n] for n in (names or ddf.columns)}, ddf.counts


def overflow(*infos) -> torch.Tensor:
    """The sum of every overflow counter in the operators' infos."""
    return sum(v.to(torch.int64).sum() for info in infos for k, v in info.items()
               if k.startswith("overflow") or ":overflow" in k)
