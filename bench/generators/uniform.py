"""The generator ``uniform``: the paper's tables (section 6), made on the
device from the seed.

The generator of the port's ``data/synthetic.uniform_table``, frozen here
so that a change to the program cannot move it: ``c0`` uniform over
``max(int(n * cardinality), 1)`` keys, every other column uniform over
``[0, 2**31 - 1)``, with ``n`` the rows of one table. The draws come from a
``torch.Generator`` on the device, in one call per column, so a 100M-row
table takes a fraction of a second and never crosses the host.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


def uniform_table(rows_per_worker: int, workers: int, cardinality: float, n_cols: int,
                  gen: torch.Generator, device) -> dict:
    """``{"c0": (P, rows), "c1": ..., }`` int32 columns: worker ``w``'s
    rows are row ``w * rows_per_worker`` on of the whole table."""
    n = rows_per_worker * workers
    n_keys = max(int(n * cardinality), 1)
    shape = (workers, rows_per_worker)
    cols = {"c0": torch.randint(0, n_keys, shape, generator=gen, device=device,
                                dtype=torch.int32)}
    for i in range(1, n_cols):
        cols[f"c{i}"] = torch.randint(0, INT32_MAX, shape, generator=gen, device=device,
                                      dtype=torch.int32)
    return cols


def tables(cfg: dict, seed: int, device) -> dict:
    """``{"left": ..., "right": ...}``: a configuration's two tables, drawn
    in that order."""
    g = generator(seed, device)
    args = (cfg["rows_per_worker"], cfg["workers"], cfg["cardinality"], cfg["columns"])
    return {"left": uniform_table(*args, g, device), "right": uniform_table(*args, g, device)}
