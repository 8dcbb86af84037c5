"""The pipeline ``join_groupby_unique``: the paper's core loop.

Each iteration runs ``left.join(right)`` on the key, ``groupby`` the key
of the join with aggregates of the left ``c1``, then ``unique`` of the
left table's key, back to back. The unique has the left table's
duplicate keys to remove, so it is held to its own answer: the left
table's key set, each row it keeps a row of that table.

Traffic parameters: ``on`` (the key), ``strategy`` (the join's),
``aggs`` (of ``c1``), ``pre_combine`` (the groupby's).
"""

from __future__ import annotations

import torch

import reference as ref
from benchlib import digest, frames


class Pipeline:
    def __init__(self, traffic: dict):
        self.on = tuple(traffic["on"])
        self.strategy = traffic["strategy"]
        self.ops = tuple(traffic["aggs"])
        self.pre_combine = traffic["pre_combine"]
        self.names = ("c0",) + tuple(f"c1_{op}" for op in self.ops)

    def rows(self, tables: dict) -> int:
        """Input rows an iteration reads: both tables'."""
        return tables["left"].num_rows() + tables["right"].num_rows()

    def run(self, tables: dict, span) -> dict:
        L, R = tables["left"], tables["right"]
        J, ji = span("join", lambda: L.join(R, on=self.on, strategy=self.strategy))
        join_rows = J.counts.sum().to(torch.int64).reshape(1)
        G, gi = span("groupby", lambda: J.groupby(self.on, {"c1": self.ops},
                                                  pre_combine=self.pre_combine))
        del J
        U, ui = span("unique", lambda: L.unique(self.on))
        return {"join_rows": join_rows, "groupby": G, "unique": U,
                "overflow": frames.overflow(ji, gi, ui)}

    def digest(self, out) -> torch.Tensor:
        return torch.cat([out["join_rows"], digest.row_digest(*frames.padded(out["groupby"])),
                          digest.row_digest(*frames.padded(out["unique"], self.on))])

    def answer(self, out) -> dict:
        return {"join_rows": int(out["join_rows"]), "groupby": frames.live(out["groupby"]),
                "unique": frames.live(out["unique"])}

    def reference(self, inputs: dict, control: bool = False) -> dict:
        lk, lv = inputs["left"]["c0"], inputs["left"]["c1"]
        exp = ref.join_groupby(lk, lv, inputs["right"]["c0"], control=control)
        return {"join_rows": exp["join_rows"], "groupby": {k: exp[k] for k in self.names},
                "unique": ref.unique_rows(lk, lv, control=control),
                "left_rows": ref.sorted_pairs(lk, lv)}

    def reference_digest(self, exp: dict) -> torch.Tensor:
        g = digest.row_digest(exp["groupby"])
        rows = torch.tensor([exp["join_rows"]], dtype=torch.int64, device=g.device)
        return torch.cat([rows, g, digest.row_digest({"c0": exp["unique"]["c0"]})])

    def compare(self, got: dict, exp: dict) -> dict:
        keys = ref.rows_off({"c0": got["unique"]["c0"]}, {"c0": exp["unique"]["c0"]}, "c0")
        return {"join_rows_off": abs(got["join_rows"] - exp["join_rows"]),
                "groups_off": ref.rows_off(got["groupby"], exp["groupby"], "c0"),
                "unique_off": keys + ref.rows_not_in(got["unique"], exp["left_rows"])}
