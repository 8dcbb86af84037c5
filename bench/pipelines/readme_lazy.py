"""The pipeline ``readme_lazy``: the README's lazy query, frozen here as
the port's smoke run writes it with int32 thresholds, built anew and
collected each iteration.

Select ``c1 < select_below``, ``with_column`` ``c2`` (1 where ``c1 <
flag_below``), project, shuffle join with the right table on ``c0``,
groupby ``c0`` with sum, min, max, count, mean (as ``avg``) of ``c1`` and
the sum of ``c2``. The planner pushes the select below the join and
elides the groupby's shuffle.

Traffic parameters: ``select_below``, ``flag_below``.
"""

from __future__ import annotations

import torch

import reference as ref
from benchlib import digest, frames


class Pipeline:
    def __init__(self, traffic: dict):
        self.select_below = traffic["select_below"]
        self.flag_below = traffic["flag_below"]

    def rows(self, tables: dict) -> int:
        return tables["left"].num_rows() + tables["right"].num_rows()

    def query(self, L, R):
        from repro_torch.expr import col, when

        return (L.lazy().select(col("c1") < self.select_below)
                .with_column("c2", when(col("c1") < self.flag_below).then(1).otherwise(0))
                .project(["c0", "c1", "c2"])
                .join(R.lazy(), on=("c0",), strategy="shuffle")
                .groupby(("c0",), [col("c1").sum(), col("c1").min(), col("c1").max(),
                                   col("c1").count(), col("c1").mean().alias("avg"),
                                   col("c2").sum()]))

    def run(self, tables: dict, span) -> dict:
        q = self.query(tables["left"], tables["right"])
        out = span("collect", q.collect)
        return {"result": out, "overflow": frames.overflow(q.last_info or {})}

    def digest(self, out) -> torch.Tensor:
        return digest.row_digest(*frames.padded(out["result"]))

    def answer(self, out) -> dict:
        return frames.live(out["result"])

    def reference(self, inputs: dict, control: bool = False) -> dict:
        left = inputs["left"]
        return ref.readme_lazy(left["c0"], left["c1"], inputs["right"]["c0"], self.select_below,
                               self.flag_below, control=control)

    def reference_digest(self, exp: dict) -> torch.Tensor:
        return digest.row_digest(exp)

    def compare(self, got: dict, exp: dict) -> dict:
        return {"groups_off": ref.rows_off(got, exp, "c0")}
