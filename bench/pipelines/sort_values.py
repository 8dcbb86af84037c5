"""The pipeline ``sort_values``: the sample sort over the workers of the
left table by one column.

Traffic parameters: ``by`` (the int32 column sorted on).
"""

from __future__ import annotations

import torch

import reference as ref
from benchlib import digest, frames


class Pipeline:
    def __init__(self, traffic: dict):
        self.by = traffic["by"]

    def rows(self, tables: dict) -> int:
        return tables["left"].num_rows()

    def run(self, tables: dict, span) -> dict:
        L = tables["left"]
        S, si = span("sort", lambda: L.sort_values(self.by))
        return {"sorted": S, "overflow": frames.overflow({"overflow": si["overflow_shuffle"]})}

    def digest(self, out) -> torch.Tensor:
        cols, counts = frames.padded(out["sorted"])
        return torch.cat([digest.row_digest(cols, counts),
                          digest.order_violations(cols[self.by], counts)])

    def answer(self, out) -> dict:
        return frames.live(out["sorted"])

    def reference(self, inputs: dict, control: bool = False) -> dict:
        return ref.sort_rows(inputs["left"]["c0"], inputs["left"]["c1"], control=control)

    def reference_digest(self, exp: dict) -> torch.Tensor:
        return torch.cat([digest.row_digest(exp), digest.order_violations(exp[self.by])])

    def compare(self, got: dict, exp: dict) -> dict:
        return {"order_off": ref.seq_off(got[self.by], exp[self.by]),
                "rows_off": ref.seq_off(ref.sorted_pairs(got["c0"], got["c1"]),
                                        ref.sorted_pairs(exp["c0"], exp["c1"]))}
