"""The port's query service (``repro_torch.service``) against the reference's
(``repro.service``).

- The reference's mixed load (3 streamed groupbys over one 4000-row
  dataset, 3 lazy join -> groupby, an eager sort, a lazy select; the
  dataset written once by the reference's writer and read by both
  packages) goes through both packages' ``QueryService`` under both
  policies at P = 1: every port result equals the reference's serial
  result by bits (rows in a canonical order, the sort's in its own).
- ``estimate_query_bytes`` is equal across the packages for each query, and
  one scripted sequence of ``offer`` / ``release`` / ``observe`` gives the
  same verdicts, backlog order and ``stats()`` on both controllers.
- Port only, at P = 4: interleaved equals serial, cancel mid-stream and
  while pending, a failed query, shed on overflow, submit after shutdown,
  lifecycle transitions, bad inputs, the cache window, ``_LRUCache``
  under threads, and the morsel wait: each ``next()`` of a query's steps
  ends in ``executor.sync`` with the query's device.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest

from repro import service as ref_service
from repro import stream as ref_stream
from repro.core import DDF as RefDDF
from repro.core import DDFContext as RefContext
from repro.data.dataset import write_dataset
from repro.expr import col as ref_col
from repro_torch import service as port_service
from repro_torch import stream as port_stream
from repro_torch.core import DDF, DDFContext
from repro_torch.core.api import _LRUCache
from repro_torch.expr import col
from repro_torch.obs import trace
from repro_torch.plan import executor
from repro_torch.service import (
    AdmissionError,
    CacheManager,
    MorselScheduler,
    QueryCancelled,
    QueryService,
    QueryState,
    SessionManager,
)

AGGS = {"v": ("sum", "count")}
TIMEOUT = 120


def _table(n, nkeys=120, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, nkeys, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32)}


def _right():
    return {"k": np.arange(120, dtype=np.int32), "w": np.arange(120, dtype=np.int32) % 9}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("svc")
    return write_dataset(_table(4000, seed=1), str(root / "ds"), chunk_rows=512)


@pytest.fixture(scope="module")
def ref_ctx():
    return RefContext(mesh=jax.make_mesh((1,), ("data",)), axes=("data",))


def _port_ctx(P=1):
    return DDFContext(nworkers=P, device="cpu")


def _ref_tables(ctx):
    return (RefDDF.from_numpy(_table(240, seed=2), ctx, capacity=480, mode="eager"),
            RefDDF.from_numpy(_right(), ctx, capacity=240, mode="eager"))


def _port_tables(ctx):
    return (DDF.from_numpy(_table(240, seed=2), ctx, capacity=480),
            DDF.from_numpy(_right(), ctx, capacity=240))


def _mixed_queries(S, c, ctx, directory, tables):
    """The reference test's 8 queries across all three submission kinds,
    for either package (S its stream module, c its ``col``)."""
    L, R = tables
    qs = [("stream", S.scan_dataset(directory, ctx, batch_rows=500).groupby(("k",), AGGS))
          for _ in range(3)]
    qs += [("lazy", L.lazy().join(R.lazy(), on=("k",)).groupby(("k",), AGGS))
           for _ in range(3)]
    qs.append(("eager", lambda: L.sort_values("k")[0]))
    qs.append(("lazy", L.lazy().select(c("v") > 500)))
    return qs


def _ref_queries(ctx, dataset):
    return _mixed_queries(ref_stream, ref_col, ctx, dataset.directory, _ref_tables(ctx))


def _port_queries(dataset, P=1):
    ctx = _port_ctx(P)
    return _mixed_queries(port_stream, col, ctx, dataset.directory, _port_tables(ctx))


def _serial(kind, q):
    if kind == "eager":
        return q()
    if kind == "stream":
        return q.collect_stream()
    return q.collect()


def _host(ddf) -> dict:
    return {k: np.asarray(v) for k, v in ddf.to_numpy().items()}


def _canon(host):
    order = np.lexsort(tuple(host[k] for k in sorted(host)))
    return {k: v[order] for k, v in host.items()}


def _same_bits(got: dict, want: dict, ordered: bool) -> None:
    assert sorted(got) == sorted(want)
    if not ordered:
        got, want = _canon(got), _canon(want)
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), k


def _run_service(svc_module, queries, policy, **kw):
    with svc_module.QueryService(policy=policy, max_running=4, **kw) as svc:
        handles = [svc.submit(q) for _, q in queries]
        results = [h.result(timeout=TIMEOUT) for h in handles]
        stats = svc.stats()
    return results, stats


@pytest.fixture(scope="module")
def ref_serial(ref_ctx, dataset):
    return [_host(_serial(k, q)) for k, q in _ref_queries(ref_ctx, dataset)]


# -- the headline: the port's service gives the reference's serial results ----------

@pytest.mark.parametrize("policy", ["fair", "round_robin"])
def test_service_matches_the_reference_serial(ref_ctx, dataset, ref_serial, policy):
    ref_results, ref_stats = _run_service(ref_service, _ref_queries(ref_ctx, dataset), policy)
    queries = _port_queries(dataset)
    results, stats = _run_service(port_service, queries, policy)
    for (kind, _), want, ref_got, got in zip(queries, ref_serial, ref_results, results):
        ordered = kind == "eager"  # the sort's row order is part of its result
        _same_bits(_host(ref_got), want, ordered)
        _same_bits(_host(got), want, ordered)
    for st in (stats, ref_stats):
        assert st["sessions"]["DONE"] == len(queries) and st["sessions"]["FAILED"] == 0
        assert st["scheduler"]["morsels_total"] > len(queries)
    # the same number of morsels: 8 batches for each of the 3 scans, 1 each else
    assert stats["scheduler"]["morsels_total"] == ref_stats["scheduler"]["morsels_total"]


def test_stats_schema_matches_the_reference(ref_ctx, dataset):
    def keys(d):  # span names recorded by earlier tests are not part of the schema
        return {k: keys(v) if isinstance(v, dict) and k != "by_name" else None
                for k, v in d.items()}

    def run(svc_module, q):
        with svc_module.QueryService() as svc:
            svc.submit(q).result(timeout=TIMEOUT)
            return svc.stats()

    ref_st = run(ref_service, _ref_queries(ref_ctx, dataset)[-1][1])
    st = run(port_service, _port_queries(dataset)[-1][1])
    assert keys(st) == keys(ref_st)
    assert set(st["queries"][0]) == set(ref_st["queries"][0])


# -- admission: the same estimates and the same decisions ---------------------------

@pytest.mark.parametrize("factor", [1.0, 4.0, 8.0])
def test_estimates_match_the_reference(ref_ctx, dataset, factor):
    ref_qs = _ref_queries(ref_ctx, dataset)
    port_qs = _port_queries(dataset)
    # a scan with a selective predicate: the sketches tighten the morsel guess
    ref_qs.append(("stream", ref_stream.scan_dataset(dataset.directory, ref_ctx, batch_rows=500,
                                                     predicate=ref_col("v") < 100)))
    port_qs.append(("stream", port_stream.scan_dataset(dataset.directory, _port_ctx(),
                                                       batch_rows=500,
                                                       predicate=col("v") < 100)))
    got = [port_service.estimate_query_bytes(q, factor) for _, q in port_qs]
    want = [ref_service.estimate_query_bytes(q, factor) for _, q in ref_qs]
    assert got == want
    assert got[0] > 0 and got[3] > 0 and got[6] == 0.0 and got[-1] < got[0]


def _admission_script(S, max_running, max_backlog, budget):
    """One fixed sequence of offers, cancels, finishes, observations and
    releases on package ``S``'s controller; returns what each step gave."""
    adm = S.AdmissionController(max_running=max_running, max_backlog=max_backlog,
                                memory_budget_bytes=budget)
    mgr = S.SessionManager()
    sessions, log = [], []

    def new(cost, key=None):
        s = mgr.create(lambda: None, {})
        s.cost_bytes = s.cost_base = cost
        s.admission_key = key
        sessions.append(s)
        return s

    def offer(s):
        try:
            log.append(("offer", sessions.index(s), adm.offer(s), s.state))
        except S.AdmissionError:
            log.append(("offer", sessions.index(s), "shed", s.state))

    def finish(s, peak=None):
        if s.state == S.QueryState.ADMITTED:
            s._transition(S.QueryState.RUNNING)
        s._finish(S.QueryState.DONE, info={"peak_working_set_bytes": peak} if peak else None)
        adm.observe(s)
        log.append(("release", sessions.index(s),
                    [sessions.index(x) for x in adm.release(s)], adm.stats()))

    a, b, c, d = new(60.0, "shape"), new(50.0), new(10.0, "shape"), new(10.0)
    for s in (a, b, c, d):
        offer(s)
    e = new(5.0)
    offer(e)
    c.cancel()  # cancelled while queued (or after admission: a cooperative flag)
    finish(a, peak=45.0)  # learns 45 * 4 / 60 = 3.0 for "shape"
    f = new(20.0, "shape")
    offer(f)
    log.append(("cost", sessions.index(f), f.cost_bytes))
    for s in (b, d, e, f):
        if s.state in (S.QueryState.ADMITTED, S.QueryState.RUNNING):
            finish(s, peak=1e12)  # clamped at 8x
    log.append(("stats", adm.stats(), adm.backlog_depth(), adm.learned_ratio(sessions[0].query)))
    return log


@pytest.mark.parametrize("max_running,max_backlog,budget",
                         [(2, 2, 100.0), (1, 4, 1e9), (4, 1, 70.0)])
def test_admission_decisions_match_the_reference(max_running, max_backlog, budget):
    got = _admission_script(port_service, max_running, max_backlog, budget)
    want = _admission_script(ref_service, max_running, max_backlog, budget)
    assert got == want
    assert any(step[2] == "queued" for step in got if step[0] == "offer")


# -- port only, at P = 4 -----------------------------------------------------------

@pytest.mark.parametrize("policy", ["fair", "round_robin"])
def test_interleaved_equals_serial_at_p4(dataset, policy):
    queries = _port_queries(dataset, P=4)
    serial = [_host(_serial(k, q)) for k, q in queries]
    results, stats = _run_service(port_service, queries, policy)
    for want, got in zip(serial, results):
        _same_bits(_host(got), want, ordered=True)
    assert stats["sessions"]["DONE"] == len(queries)
    assert stats["scheduler"]["morsels_total"] == 3 * _morsels(queries[0][1]) + 5


def _morsels(scan) -> int:
    """The events of a scan's steps when run alone: its morsels."""
    return sum(1 for _ in port_stream.StreamExecution(scan).steps())


def _gate_thunk(gate, started):
    def thunk():
        started.set()
        assert gate.wait(timeout=TIMEOUT)
        return 1
    return thunk


def test_cancel_mid_stream(dataset):
    """The scan's first morsel has run when a thunk holds the one scheduler
    thread; the scan is cancelled then, and stops at its next turn."""
    ctx = _port_ctx(4)
    scan = port_stream.scan_dataset(dataset.directory, ctx, batch_rows=100).groupby(("k",), AGGS)
    gate, started = threading.Event(), threading.Event()
    earlier = {t for t in threading.enumerate() if t.name == "repro-stream-prefetch"}
    with QueryService(policy="round_robin") as svc:
        h = svc.submit(scan)
        deadline = time.monotonic() + TIMEOUT
        while h.morsels < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        blocker = svc.submit(_gate_thunk(gate, started))
        assert started.wait(timeout=TIMEOUT)
        assert h.state == QueryState.RUNNING and svc.cancel(h.qid)
        gate.set()
        with pytest.raises(QueryCancelled):
            h.result(timeout=TIMEOUT)
        assert blocker.result(timeout=TIMEOUT) == 1
    assert h.state == QueryState.CANCELLED and 1 <= h.morsels < 40
    assert svc.cancel(h.qid) is False
    # the closed generator stopped its prefetch thread

    def ours():
        return [t for t in threading.enumerate()
                if t.name == "repro-stream-prefetch" and t not in earlier]

    deadline = time.monotonic() + 10
    while ours() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not ours()


def test_cancelled_scan_frees_its_batches(dataset, monkeypatch):
    """Once a cancelled scan's service has drained, every batch table the
    scan made is freed, with the cyclic collector off: nothing of the query
    waits for the collector to give its memory back (on the card,
    ``torch.cuda.memory_allocated`` shows it)."""
    import gc
    import weakref

    from repro_torch.stream import runner

    made = []
    real = runner.DDF.from_numpy

    def from_numpy(*a, **k):
        out = real(*a, **k)
        made.extend(weakref.ref(v) for v in out.columns.values())
        return out

    monkeypatch.setattr(runner.DDF, "from_numpy", staticmethod(from_numpy))
    scan = port_stream.scan_dataset(dataset.directory, _port_ctx(4), batch_rows=100)
    gate, started = threading.Event(), threading.Event()
    gc.collect()
    gc.disable()
    try:
        with QueryService(policy="round_robin") as svc:
            h = svc.submit(scan.groupby(("k",), AGGS))
            deadline = time.monotonic() + TIMEOUT
            while h.morsels < 3 and time.monotonic() < deadline:
                time.sleep(0.001)
            blocker = svc.submit(_gate_thunk(gate, started))
            assert started.wait(timeout=TIMEOUT) and svc.cancel(h.qid)
            gate.set()
            blocker.result(timeout=TIMEOUT)
        assert h.state == QueryState.CANCELLED and len(made) >= 6
        alive = [r() for r in made if r() is not None]
        assert not alive, [tuple(t.shape) for t in alive]
    finally:
        gc.enable()


def test_cancel_while_pending(dataset):
    L, _ = _port_tables(_port_ctx(4))
    s = SessionManager().create(lambda: None, {})
    assert s.cancel() is True and s.state == QueryState.CANCELLED
    with pytest.raises(QueryCancelled):
        s.result(timeout=1)
    assert s.cancel() is False
    gate, started = threading.Event(), threading.Event()
    with QueryService(max_running=1) as svc:
        first = svc.submit(_gate_thunk(gate, started))
        assert started.wait(timeout=TIMEOUT)
        queued = svc.submit(L.lazy().select(col("v") > 500))
        assert queued.state == QueryState.PENDING and svc.admission.backlog_depth() == 1
        assert queued.cancel() and queued.state == QueryState.CANCELLED
        assert svc.admission.backlog_depth() == 0
        gate.set()
        assert first.result(timeout=TIMEOUT) == 1
        with pytest.raises(QueryCancelled):
            queued.result(timeout=1)
    assert queued.morsels == 0


def test_failed_query_keeps_its_error():
    def boom():
        raise RuntimeError("exploded in the query")

    with QueryService() as svc:
        h = svc.submit(boom)
        with pytest.raises(RuntimeError, match="exploded"):
            h.result(timeout=TIMEOUT)
        assert h.state == QueryState.FAILED
        assert svc.submit(lambda: 42).result(timeout=TIMEOUT) == 42
        assert svc.stats()["sessions"]["FAILED"] == 1


@pytest.mark.parametrize("max_backlog", [0, 1])
def test_shed_on_overflow(max_backlog):
    L, _ = _port_tables(_port_ctx(4))
    gate, started = threading.Event(), threading.Event()
    svc = QueryService(max_running=1, max_backlog=max_backlog)
    try:
        h = svc.submit(_gate_thunk(gate, started))
        queued = [svc.submit(L.lazy().select(col("v") > 500)) for _ in range(max_backlog)]
        with pytest.raises(AdmissionError, match="backlog full"):
            svc.submit(L.lazy().select(col("v") > 500))
        gate.set()
        assert h.result(timeout=TIMEOUT) == 1
        for q in queued:
            assert q.result(timeout=TIMEOUT).to_numpy()["v"].min() > 500
        st = svc.stats()
        assert st["admission"]["rejected_total"] == 1 and st["sessions"]["FAILED"] == 1
    finally:
        gate.set()
        svc.shutdown(cancel=True, timeout=30)


def test_submit_after_shutdown_rejected():
    L, _ = _port_tables(_port_ctx(4))
    svc = QueryService()
    svc.shutdown()
    with pytest.raises(AdmissionError, match="shut down"):
        svc.submit(L.lazy().select(col("v") > 500))
    svc.shutdown()  # idempotent


def test_session_lifecycle_transitions():
    mgr = SessionManager()
    s = mgr.create(lambda: None, {}, label="t")
    assert s.state == QueryState.PENDING
    s._transition(QueryState.ADMITTED)
    s._transition(QueryState.RUNNING)
    with pytest.raises(RuntimeError, match="illegal transition"):
        s._transition(QueryState.PENDING)
    s._finish(QueryState.DONE, result=7)
    assert s.result(timeout=1) == 7 and s.done() and s.cancel() is False
    assert s.describe()["label"] == "t" and s.describe()["state"] == QueryState.DONE
    assert len({mgr.create(lambda: None, {}).qid for _ in range(10)}) == 10
    assert mgr.counts()[QueryState.PENDING] == 10 and len(mgr) == 11


def test_scheduler_rejects_bad_inputs():
    L, _ = _port_tables(_port_ctx(4))
    with pytest.raises(ValueError, match="policy"):
        MorselScheduler(policy="nope")
    with QueryService() as svc:
        with pytest.raises(TypeError, match="lazy"):
            svc.submit(L).result(timeout=TIMEOUT)
        with pytest.raises(ValueError, match="stream options"):
            svc.submit(L.lazy().select(col("v") > 500), batch_rows=64).result(timeout=TIMEOUT)
        with pytest.raises(TypeError, match="unsupported query type"):
            svc.submit(5).result(timeout=TIMEOUT)
        h = svc.submit(L.lazy().select(col("v") > 500), weight=2.5, label="filter")
        h.result(timeout=TIMEOUT)
        desc = next(d for d in svc.stats()["queries"] if d["qid"] == h.qid)
    assert desc["label"] == "filter" and desc["weight"] == 2.5 and desc["morsels"] == 1


def test_cache_window_and_shared_caches(dataset):
    L, R = _port_tables(_port_ctx(4))
    mgr = CacheManager()
    L.lazy().select(col("v") > 500).collect()
    L.lazy().select(col("v") > 500).collect()
    w = mgr.stats()["op"]["window"]
    assert w["hits"] >= 1 and mgr.hit_rate("op") is not None
    mgr.mark()
    assert mgr.stats()["op"]["window"]["hits"] == 0 and mgr.hit_rate("plan") is None
    # queries of one shape share one optimizer pass and one callable
    with QueryService(max_running=8) as svc:
        for _ in range(3):
            svc.submit(L.lazy().join(R.lazy(), on=("k",)).groupby(("k",), AGGS))
        svc.shutdown()
        caches = svc.stats()["caches"]
    assert caches["plan"]["window"]["hits"] >= 2 and caches["op"]["window"]["hits"] >= 2


def test_lru_cache_under_threads():
    """16 threads put and get with a tiny switch interval: values stay
    consistent, the size bound holds, and every get is counted once as a
    hit or a miss (a lost counter update breaks the sum)."""
    c = _LRUCache(maxsize=64)
    errs = []

    def script(seed):
        rng = np.random.default_rng(seed)
        return [(int(rng.integers(0, 128)), bool(rng.random() < 0.5)) for _ in range(500)]

    scripts = [script(i) for i in range(16)]

    def work(ops):
        try:
            for k, put in ops:
                if put:
                    c.put(k, k)
                else:
                    v = c.get(k)
                    assert v is None or v == k
        except AssertionError as e:  # surfaced below
            errs.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(ops,)) for ops in scripts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and not errs
    st = c.stats()
    gets = sum(not put for ops in scripts for _, put in ops)
    assert st["hits"] + st["misses"] == gets and st["hits"] > 0
    assert len(c) <= 64 and st["size"] == len(c)


# -- the morsel wait ---------------------------------------------------------------

def test_each_morsel_waits_for_the_querys_device(dataset, monkeypatch):
    """Every ``next()`` of a query's steps (each morsel, and the one that
    finishes it) ends in ``executor.sync`` with the query's device; a thunk
    whose result lies on no device waits for nothing."""
    calls = []
    monkeypatch.setattr(executor, "sync", lambda dev: calls.append(dev))
    ctx = _port_ctx(4)
    L, R = _port_tables(ctx)
    queries = {
        "stream": port_stream.scan_dataset(dataset.directory, ctx, batch_rows=500)
        .groupby(("k",), AGGS),
        "lazy": L.lazy().join(R.lazy(), on=("k",)).groupby(("k",), AGGS),
        "eager": lambda: L.sort_values("k")[0],
        "host": lambda: 42,
    }
    with QueryService() as svc:
        for name, q in queries.items():
            calls.clear()
            h = svc.submit(q)
            h.result(timeout=TIMEOUT)
            if name == "host":
                assert calls == []
            else:
                assert h.morsels == (_morsels(q) if name == "stream" else 1)
                assert calls == [ctx.device] * (h.morsels + 1), name


def test_service_spans_are_recorded():
    L, _ = _port_tables(_port_ctx(4))
    with trace.tracing():
        mark = trace.mark()
        with QueryService() as svc:
            svc.submit(L.lazy().select(col("v") > 500)).result(timeout=TIMEOUT)
            st = svc.stats()
        names = [s.name for s in trace.get_trace(mark).spans]
    assert st["trace"]["enabled"] is True
    # one span for the morsel and one for the step that finishes the query
    assert names.count("service.morsel") == 2 and names.count("service.query") == 1


# -- the smoke run's service phase, rehearsed on the CPU -----------------------------

def test_chip_smoke_service_path_runs_on_the_cpu():
    """The smoke run's service phase at a small size. On the CPU no kernel
    launches, so the dispatch points are wrapped to count into the launch
    registry: the concurrent run must reach them as often as the serial
    runs together, and never the histogram variant."""
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke
    from repro_torch.core import local_ops as lo
    from repro_torch.core import operators as opmod
    from repro_torch.kernels import registry

    hp, sr = opmod.hash_partition_ids, lo._seg_reduce_dispatch

    def counted(name, fn):
        def wrapped(*a, **k):
            registry.count_launch(name)
            return fn(*a, **k)
        return wrapped

    opmod.hash_partition_ids = counted("hash_partition", hp)
    lo._seg_reduce_dispatch = counted("segment_reduce", sr)
    try:
        res = chip_smoke.run_service_path(8, 6_000, 1_500, device="cpu", chunk_rows=4096,
                                          memory_budget_bytes=48_000, cancel_batch_rows=480)
    finally:
        opmod.hash_partition_ids, lo._seg_reduce_dispatch = hp, sr
    conc, serial = res["concurrent"]["launches"], res["serial_launches"]
    assert conc == serial and conc["hash_partition"] > 0 and conc["segment_reduce"] > 0
    assert conc["hash_partition_hist"] == 0
    assert res["batches"] == 4 and res["sessions"]["DONE"] == 10
    assert res["cancel"]["state"] == QueryState.CANCELLED and res["shed"] == "AdmissionError"
