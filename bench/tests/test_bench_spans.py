"""The split of a window's device time by the program's spans
(``benchlib.spans``): the interval arithmetic on synthetic intervals, and a
run of each cell on the CPU with the program's spans on."""

import pytest
from conftest import ROOT

from benchlib import spans, spec

CELLS = [w["name"] for w in spec.load(ROOT)["workloads"]]


def test_merge_subtract_overlap():
    assert spans.merge([(5, 7), (0, 2), (1, 3), (7, 8), (4, 4)]) == [[0, 3], [5, 8]]
    assert spans.subtract([[0, 10]], [[2, 3], [5, 6], [9, 12]]) == [[0, 2], [3, 5], [6, 9]]
    assert spans.subtract([[0, 2], [4, 6]], [[1, 5]]) == [[0, 1], [5, 6]]
    assert spans.overlap([[0, 4], [6, 9]], [[3, 7], [8, 20]]) == 1 + 1 + 1


def test_nested_ranges_and_a_gap_inside_a_span():
    # a shuffle [0, 10) holding its buffers [0, 4) and its compaction [6, 10);
    # the device idles over [4, 5) inside the shuffle
    busy = spans.merge([(0, 4), (5, 10)])
    ranges = {"shuffle": [(0, 10)], "shuffle.buffers": [(0, 4)], "compact": [(6, 10)]}
    assert spans.inside(busy, ranges["shuffle"]) == 9
    assert spans.inside(busy, ranges["shuffle"], ranges["shuffle.buffers"] + ranges["compact"]) == 1
    out = spans.split(busy, ranges)
    assert out["by_layer"]["exchange"] == 1 and out["by_layer"]["compact"] == 4
    assert out["by_layer"]["shuffle_buffers"] == 4 and out["coverage"] == 1


def test_overlapping_device_ops_count_once():
    busy = spans.merge([(0, 6), (2, 4), (3, 8)])  # three operations, overlapping
    assert busy == [[0, 8]]
    assert spans.inside(busy, [(1, 5)]) == 4


def test_an_op_outside_every_span_and_the_digest():
    busy = spans.merge([(0, 2), (3, 4), (5, 9)])  # local.sort, nothing, the digest
    ranges = {"local.sort": [(0, 2)], spans.DIGEST: [(5, 9)]}
    out = spans.split(busy, ranges)
    assert out["busy"] == 7 and out["coverage"] == pytest.approx(2 / 3)
    assert out["by_layer"]["local"] == 2 and out["by_layer"]["partition"] == 0


def test_local_ops_leave_their_compaction_to_compact():
    busy = [[0, 10]]
    ranges = {"local.join": [(0, 10)], "compact": [(7, 9)], "local.unique": [(20, 30)]}
    out = spans.split(busy, ranges)
    assert out["by_layer"]["local"] == 8 and out["by_layer"]["compact"] == 2


def test_open_at_and_idle_by_innermost_host_span():
    host = [(0, 10, "shuffle"), (0, 4, "shuffle.buffers"), (6, 10, "compact"), (12, 14, "local.sort")]
    assert spans.open_at(host, [0, 5, 7, 11, 13]) == [
        ["shuffle", "shuffle.buffers"], ["shuffle"], ["shuffle", "compact"], [], ["local.sort"]]
    idle = spans.idle_by_span([(1, 0.5), (5, 1.0), (11, 2.0), (8, 0.25)], host)
    assert idle == {"shuffle.buffers": 0.5, "shuffle": 1.0, "compact": 0.25,
                    "outside any program span": 2.0}


def _window(device_ops, host_ops):
    """Synthetic profiler events: the window [0, 100), host ranges
    ``(name, start, end, correlation)``, device operations ``(name, start,
    end, launched by)``."""
    evs = [("bench.window", False, 0, 100, 1, 0)]
    evs += [(n, False, s, e, c, 0) for n, s, e, c in host_ops]
    evs += [(n, True, s, e, 1000 + i, c) for i, (n, s, e, c) in enumerate(device_ops)]
    return evs


def test_read_attributes_each_operation_by_its_launch():
    host = [("shuffle", 0, 30, 2), ("shuffle.buffers", 1, 10, 3), ("aten::sort", 2, 3, 4),
            ("compact", 12, 20, 5), ("aten::cumsum", 13, 14, 6), ("aten::add", 25, 26, 7),
            ("aten::mul", 40, 41, 8)]
    dev = [("radix", 20, 40, 4), ("scan", 40, 70, 6), ("add", 70, 75, 7), ("mul", 80, 85, 8),
           ("copy", 90, 95, 99),  # its launch is not in the trace
           ("shuffle", 20, 75, 0)]  # the profiler's device range of the span: not work
    out = spans.read(_window(dev, host), {"shuffle", "shuffle.buffers", "compact"})
    assert out["busy"] == 65e-9 and out["linked_share"] == pytest.approx(60 / 65)
    assert out["by_span"] == {"shuffle": 55e-9, "shuffle.buffers": 20e-9, "compact": 30e-9}
    assert out["by_layer"]["exchange"] == 5e-9 and out["coverage"] == pytest.approx(55 / 65)
    # idle from 0 (the shuffle's host range is open), 75, 85 and 95 (none is)
    assert out["idle_by_span"] == {"shuffle": 20e-9, "outside any program span": 15e-9}
    assert ["compact", "scan", 30e-9] in out["kernels"] and ["", "mul", 5e-9] in out["kernels"]
    assert ["", "copy", 5e-9] in out["kernels"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_run_with_the_program_spans_on(name):
    res = spans.run_cell(ROOT, name, 2**31 + 17, 0.3, device="cpu",
                         overrides={"rows_per_worker": 20_000})
    assert res["correct"], res["checks"]
    ops = {m["name"] for m in spec.per_layer(spec.load(ROOT), name)
           if m["name"].startswith("op_ms.")}
    assert ops and ops <= set(res["metrics"])
    sp = res["spans"]
    # no device trace on the CPU: no device time, no coverage
    assert all(sp[f"dev_ms.{k}"] is None for k in
               ("partition", "shuffle", "shuffle_buffers", "compact", "local"))
    assert sp["coverage_pct"] is None
    # the counters need no device: every cell shuffles with its slots padded
    assert 20 < sp["shuffle_fill_pct"] < 60
    assert (sp["host_ms.plan_build"] is not None) == (name == "uniform.lazy-readme")
