"""The engine's spans (``repro_torch.obs.trace``) on the CPU: where they
open and how they nest, that they are ``torch.profiler`` ranges of the same
names while tracing is on and cost nothing while it is off, and the
``shuffle`` span's counts.

Tiny tables, P = 4 workers of 500 rows. Every case runs with tracing on
and off and must give the same answers by bits."""

from collections import Counter

import pytest
import torch

from repro_torch.core import DDF, DDFContext, Table, from_arrays
from repro_torch.core.comm import collectives
from repro_torch.core.partition import hash_partition_ids
from repro_torch.obs import trace

P, N = 4, 500
LOCAL = {"local.sort", "local.unique", "local.groupby", "local.join", "local.anti_join"}


def _frames(n=N, seed=5):
    ctx = DDFContext(nworkers=P, device="cpu")
    g = torch.Generator().manual_seed(seed)

    def ddf():
        c0 = torch.randint(0, int(0.9 * n * P), (P, n), generator=g, dtype=torch.int32)
        c1 = torch.randint(0, 2**31 - 1, (P, n), generator=g, dtype=torch.int32)
        t = from_arrays({"c0": c0, "c1": c1}, device="cpu")
        return DDF(t.columns, t.nvalid, ctx)

    return ddf(), ddf()


def _lazy(L, R):
    from repro_torch.expr import col, when

    return (L.lazy().select(col("c1") < 2**30)
            .with_column("c2", when(col("c1") < 2**29).then(1).otherwise(0))
            .project(["c0", "c1", "c2"])
            .join(R.lazy(), on=("c0",), strategy="shuffle")
            .groupby(("c0",), [col("c1").sum(), col("c1").min(), col("c1").max(),
                               col("c1").count(), col("c1").mean().alias("avg"),
                               col("c2").sum()])
            .collect())


# each case: the call, and the spans it opens by name
CASES = {
    "join": (lambda L, R: L.join(R, on=("c0",), strategy="shuffle")[0],
             {"partition.hash": 2, "shuffle": 2, "shuffle.buffers": 2, "compact": 3,
              "local.join": 1}),
    "groupby": (lambda L, R: L.groupby(("c0",), {"c1": ("sum", "min", "max", "count", "mean")},
                                       pre_combine=True)[0],
                {"local.groupby": 2, "partition.hash": 1, "shuffle": 1, "shuffle.buffers": 1,
                 "compact": 1}),
    "unique": (lambda L, R: L.unique(("c0",))[0],
               {"local.unique": 2, "partition.hash": 1, "shuffle": 1, "shuffle.buffers": 1,
                "compact": 3}),
    "sort": (lambda L, R: L.sort_values("c1")[0],
             {"local.sort": 2, "partition.range": 1, "shuffle": 1, "shuffle.buffers": 1,
              "compact": 1}),
    "lazy": (_lazy,
             {"plan.build": 1, "plan.execute": 1, "compact": 4, "partition.hash": 2,
              "shuffle": 2, "shuffle.buffers": 2, "local.join": 1, "local.groupby": 1}),
}


def _bits(ddf: DDF) -> dict:
    t = ddf.table()
    cols = {k: (v.view(torch.int32) if v.dtype == torch.float32 else v)
            for k, v in t.columns.items()}
    return {**cols, "__nvalid": t.nvalid}


def _traced(fn):
    with trace.tracing():
        mark = trace.mark()
        out = fn()
        return out, trace.get_trace(mark).spans


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_where_the_work_is_and_change_no_answer(case):
    fn, want = CASES[case]
    L, R = _frames()
    off = _bits(fn(L, R))
    out, spans = _traced(lambda: fn(L, R))
    on = _bits(out)
    assert off.keys() == on.keys() and all(torch.equal(off[k], on[k]) for k in off)

    assert Counter(s.name for s in spans) == want
    by_id = {s.sid: s for s in spans}

    def parent(s):
        return by_id[s.parent].name if s.parent in by_id else None

    children = Counter((parent(s), s.name) for s in spans)
    for s in spans:
        if s.name == "shuffle":
            # one buffer build and one receive compaction inside, and no
            # shuffle inside a local operator
            assert children[("shuffle", "shuffle.buffers")] == want["shuffle"]
            assert children[("shuffle", "compact")] == want["shuffle"]
            assert parent(s) not in LOCAL
        elif s.name == "shuffle.buffers":
            assert parent(s) == "shuffle"
        elif s.name.startswith("partition."):
            assert parent(s) not in LOCAL | {"shuffle"}
    if case == "lazy":
        assert all(parent(s) == "plan.execute" for s in spans
                   if s.name in ("shuffle", "local.join", "local.groupby"))


class _CountingRange:
    """Stands in for ``torch.profiler.record_function`` and counts entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_tracing_off_records_nothing_and_enters_no_profiler_range(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRange)
    _CountingRange.entered = 0
    L, R = _frames()
    assert not trace.enabled()
    mark = trace.mark()
    L.join(R, on=("c0",), strategy="shuffle")
    L.sort_values("c1")
    assert trace.mark() == mark and _CountingRange.entered == 0
    assert trace.span("shuffle") is trace.span("compact") is trace._NULL

    _, spans = _traced(lambda: L.join(R, on=("c0",), strategy="shuffle"))
    assert _CountingRange.entered == len(spans) > 0


def test_every_span_is_a_profiler_range_inside_its_parents():
    L, R = _frames(n=50)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, spans = _traced(lambda: L.join(R, on=("c0",), strategy="shuffle"))
    names = {s.name for s in spans}
    events = [e for e in prof.events() if e.name in names]
    assert Counter(e.name for e in events) == Counter(s.name for s in spans)

    def enclosing(e):  # the innermost program range around a profiler range
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        return p

    by_id = {s.sid: s.name for s in spans}
    want = Counter((s.name, by_id.get(s.parent)) for s in spans)
    got = Counter()
    for e in events:
        p = enclosing(e)
        if p is not None:
            assert p.time_range.start <= e.time_range.start
            assert e.time_range.end <= p.time_range.end
        got[(e.name, p.name if p is not None else None)] += 1
    assert got == want


@pytest.mark.parametrize("how", ["native", "bruck", "pipelined"])
def test_shuffle_span_counts_its_slots_and_live_rows(how):
    L, _ = _frames()
    t = Table(L.table().columns, torch.tensor([N, 0, N // 2, 7], dtype=torch.int32))
    dest = hash_partition_ids(t, ["c0"], P)
    quota = 40  # about half of a full worker's rows per destination: some overflow
    if how == "pipelined":
        def fn():
            return collectives.shuffle_table_pipelined(t, dest, quota, num_chunks=3)
    else:
        def fn():
            return collectives.shuffle_table(t, dest, quota, algorithm=how)
    (out, overflow), spans = _traced(fn)
    (sp,) = [s for s in spans if s.name == "shuffle"]
    sent = int(t.nvalid.sum()) - int(overflow.sum())
    assert int(overflow.sum()) > 0
    assert sp.attrs["slots"] == P * P * quota
    assert int(sp.attrs["rows"]) == sent == int(out.nvalid.sum())
