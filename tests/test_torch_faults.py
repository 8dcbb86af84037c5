"""Fault tolerance of the port's streaming engine (``repro_torch.testing``,
``repro_torch.stream.recovery`` / ``checkpoint``).

- A ``FaultPlan`` seed fires at the same sites and ordinals in both
  packages, and error classification and retry backoff are the
  reference's.
- In the port, a query killed at each fault site the reference's chaos
  tests kill at (``tests/test_fault_tolerance.py::KILL_CASES``) and then
  resumed gives the fault-free run's rows bit for bit, restarts from the
  snapshotted cursor and clears its store. Transient faults under the retry
  budget change nothing; a crash while publishing keeps the previous
  snapshot; a snapshot of another query, or of other vocabularies, is
  refused; an adaptive stream resumes mid-correction bit-identically.
"""

import os
import zipfile

import numpy as np
import pytest

from repro import testing as ref_testing
from repro.stream import recovery as ref_recovery
from repro_torch import stream
from repro_torch.core import DDFContext
from repro_torch.data.dataset import write_dataset
from repro_torch.expr import col
from repro_torch.stream import (
    RETRYABLE_EXCEPTIONS,
    RetryPolicy,
    StreamCheckpoint,
    call_with_retry,
    classify_error,
)
from repro_torch.testing import FAULT_SITES, FaultPlan, InjectedFault, fault_scope
from repro_torch.testing import faults as port_faults


def _ctx(P=1):
    return DDFContext(nworkers=P, device="cpu")


def _table(n, nkeys, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, nkeys, n).astype(np.int64),
            "v": (rng.integers(-400, 400, n) / 4).astype(np.float32)}


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    """The reference's chaos datasets: 4096 rows / batch_rows=512 -> 8
    morsels; ``sleft`` has dict-encoded string keys."""
    root = tmp_path_factory.mktemp("faultds")
    left = write_dataset(_table(4096, 50, 0), str(root / "left"), chunk_rows=256)
    rng = np.random.default_rng(1)
    right = write_dataset({"k": rng.integers(0, 50, 1536).astype(np.int64),
                           "w": (rng.integers(-400, 400, 1536) / 4).astype(np.float32)},
                          str(root / "right"), chunk_rows=192)
    t = _table(4096, 50, 2)
    words = np.asarray([f"city{i:02d}" for i in range(50)])
    sleft = write_dataset({"k": words[t["k"]], "v": t["v"]}, str(root / "sleft"),
                          chunk_rows=256)
    return left, right, sleft


def _pipeline(name, ds, P=1):
    left, right, sleft = ds
    ctx = _ctx(P)
    scan = lambda m: stream.scan_dataset(m, ctx, batch_rows=512)
    if name == "groupby":
        return scan(left).groupby(("k",), {"v": ("sum", "count")})
    if name == "strgroupby":
        return scan(sleft).groupby(("k",), {"v": ("sum", "count")})
    if name == "unique":
        return scan(left).unique(("k",))
    if name == "sort":
        return scan(left).sort_values("v")
    if name == "join":
        return (scan(left).join(scan(right), on=("k",))
                .groupby(("k",), {"v": ("sum",), "w": ("sum",)}))
    if name == "multi":
        return scan(left).unique(("k",)).sort_values("k")
    raise ValueError(name)


def _run(name, ds, P=1, **opts):
    lz = _pipeline(name, ds, P)
    out = lz.collect_stream(**opts).to_numpy()
    return out, lz.last_info


def _assert_same(ref, out):
    assert set(ref) == set(out)
    for k in ref:
        assert ref[k].dtype == out[k].dtype, k
        np.testing.assert_array_equal(ref[k].view(np.uint8), out[k].view(np.uint8), err_msg=k)


# -- the harness and recovery units against the reference ---------------------------

def _fire_sequence(testing, seed, **plan_kw):
    plan = testing.FaultPlan(seed=seed, **plan_kw)
    with testing.fault_scope(plan):
        for i in range(200):
            site = testing.FAULT_SITES[(i * 7) % len(testing.FAULT_SITES)]
            try:
                testing.check(site)
            except testing.InjectedFault as e:
                assert (e.site, e.ordinal) == plan.fired[-1]
    return plan.fired, {s: plan.invocations(s) for s in testing.FAULT_SITES}


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_fault_plan_fires_as_the_reference(seed):
    assert FAULT_SITES == ref_testing.FAULT_SITES
    for kw in ({"rates": {"chunk_decode": 0.3, "device_op": 0.5, "spill_write": 0.1}},
               {"rates": {"prefetch": 0.7}, "max_failures": 5},
               {"kill_after": {"checkpoint_publish": 9}, "rates": {"device_op": 0.2}}):
        assert _fire_sequence(port_faults, seed, **kw) == \
            _fire_sequence(ref_testing.faults, seed, **kw)
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(rates={"nope": 1.0})


def test_recovery_units_match_the_reference():
    errors = (InjectedFault("device_op", 3), OSError("x"), EOFError(), zipfile.BadZipFile(),
              RuntimeError("overflow"), ValueError("schema"), KeyError("k"))
    ref_errors = (ref_testing.InjectedFault("device_op", 3),) + errors[1:]
    assert [classify_error(e) for e in errors] == \
        [ref_recovery.classify_error(e) for e in ref_errors]
    assert len(RETRYABLE_EXCEPTIONS) == len(ref_recovery.RETRYABLE_EXCEPTIONS)
    pol, ref_pol = RetryPolicy(max_retries=3, backoff_s=0.1), \
        ref_recovery.RetryPolicy(max_retries=3, backoff_s=0.1)
    assert [pol.delay(i) for i in range(8)] == [ref_pol.delay(i) for i in range(8)]
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("torn read")
        return "done"

    assert call_with_retry(flaky, pol, "chunk_decode", sleep=slept.append) == "done"
    assert slept == [pol.delay(0), pol.delay(1)]
    with pytest.raises(OSError):
        call_with_retry(lambda: (_ for _ in ()).throw(OSError("x")), RetryPolicy(max_retries=1),
                        "x", sleep=lambda s: None)
    with pytest.raises(ValueError):  # fatal: never retried
        call_with_retry(lambda: (_ for _ in ()).throw(ValueError("x")), pol, "x",
                        sleep=lambda s: pytest.fail("retried a fatal error"))


def test_checkpoint_store_lists_only_published_snapshots(tmp_path):
    store = StreamCheckpoint(str(tmp_path / "ck"))
    assert store.steps() == [] and store.latest() is None
    with pytest.raises(FileNotFoundError):
        store.load()
    store.save(0, {"a": 1}, {"x": np.arange(3)})
    store.save(2, {"a": 2}, {"x": np.arange(4)})
    os.makedirs(str(tmp_path / "ck" / "ckpt_00000005.tmp_0"))
    os.makedirs(str(tmp_path / "ck" / "ckpt_00000007"))  # partial: no manifest
    assert store.steps() == [0, 2]
    assert not os.path.exists(str(tmp_path / "ck" / "ckpt_00000005.tmp_0"))
    manifest, arrays = store.load()
    assert manifest == {"step": 2, "a": 2} and arrays["x"].tolist() == [0, 1, 2, 3]
    with pytest.raises(FileNotFoundError, match="valid steps"):
        store.load(1)
    store.prune(keep_last=1)
    assert store.steps() == [2]
    store.clear()
    assert store.steps() == []


# -- kill + resume in the port ----------------------------------------------------

KILL_CASES = [
    ("groupby", "device_op", 5),
    ("groupby", "chunk_decode", 5),
    ("unique", "device_op", 4),
    ("sort", "spill_write", 3),
    ("sort", "chunk_decode", 6),
    ("join", "prefetch", 8),
    ("join", "spill_write", 40),
    ("multi", "chunk_decode", 6),
    ("strgroupby", "device_op", 5),
    ("strgroupby", "chunk_decode", 5),
]


@pytest.mark.parametrize("name,site,after", KILL_CASES)
def test_kill_then_resume_bit_identical(ds, tmp_path, name, site, after):
    counter = FaultPlan(seed=0)  # no faults: invocation counts only
    with fault_scope(counter):
        ref, _ = _run(name, ds)
    full_decodes = counter.invocations("chunk_decode")
    assert full_decodes >= 8
    ck = str(tmp_path / "ck")
    plan = FaultPlan(seed=7, kill_after={site: after})
    with fault_scope(plan):
        with pytest.raises(InjectedFault):
            _run(name, ds, checkpoint_dir=ck, checkpoint_every=2)
    assert plan.invocations(site) > after
    store = StreamCheckpoint(ck)
    assert store.steps(), "the killed run must have published a snapshot"
    recount = FaultPlan(seed=0)
    with fault_scope(recount):
        out, _ = _run(name, ds, checkpoint_dir=ck, resume=True)
    _assert_same(ref, out)
    assert recount.invocations("chunk_decode") < full_decodes
    assert store.steps() == []


@pytest.mark.parametrize("name", ["groupby", "sort", "join"])
def test_transient_faults_retry_transparently(ds, name):
    ref, _ = _run(name, ds)
    plan = FaultPlan(seed=13, max_failures=4, rates={"chunk_decode": 0.5, "device_op": 0.5})
    with fault_scope(plan):
        out, info = _run(name, ds, max_retries=4, retry_backoff_s=0.001)
    _assert_same(ref, out)
    assert len(plan.fired) >= 1
    assert sum(v for k, v in info.items() if k.startswith("retries:")) == len(plan.fired)


def test_prefetch_thread_faults_reach_the_consumer(ds):
    plan = FaultPlan(kill_after={"chunk_decode": 0})
    with fault_scope(plan):
        with pytest.raises(InjectedFault):
            _run("groupby", ds, max_retries=0)
    with fault_scope(FaultPlan(kill_after={"prefetch": 2})):
        with pytest.raises(InjectedFault):
            _run("sort", ds)


def test_publish_crash_keeps_the_previous_snapshot(ds, tmp_path):
    ref, _ = _run("groupby", ds)
    ck = str(tmp_path / "ck")
    with fault_scope(FaultPlan(kill_after={"checkpoint_publish": 1})):
        with pytest.raises(InjectedFault):
            _run("groupby", ds, checkpoint_dir=ck, checkpoint_every=2)
    assert any(".tmp_" in n for n in os.listdir(ck))
    store = StreamCheckpoint(ck)
    assert store.steps() == [0]
    manifest, arrays = store.load()
    # the carry table is snapshotted as host numpy: (P, capacity) columns
    # and the int32 per-worker counts
    assert arrays["active/counts"].dtype == np.int32
    assert arrays["active/col/k"].ndim == 2
    out, _ = _run("groupby", ds, checkpoint_dir=ck, resume=True)
    _assert_same(ref, out)


def test_resume_refuses_another_query_or_vocabulary(ds, tmp_path):
    ck = str(tmp_path / "ck")
    with fault_scope(FaultPlan(kill_after={"device_op": 5})):
        with pytest.raises(InjectedFault):
            _run("groupby", ds, checkpoint_dir=ck, checkpoint_every=2)
    with pytest.raises(ValueError, match="different query"):
        _run("sort", ds, checkpoint_dir=ck, resume=True)
    t = _table(4096, 50, 3)
    qs = {}
    for stem in ("city", "town"):
        words = np.asarray([f"{stem}{i:02d}" for i in range(50)])
        man = write_dataset({"k": words[t["k"]], "v": t["v"]}, str(tmp_path / stem),
                            chunk_rows=256)
        qs[stem] = lambda m=man: stream.scan_dataset(m, _ctx(), batch_rows=512).groupby(
            ("k",), {"v": ("sum",)})
    ck2 = str(tmp_path / "ck2")
    with fault_scope(FaultPlan(kill_after={"device_op": 5})):
        with pytest.raises(InjectedFault):
            qs["city"]().collect_stream(checkpoint_dir=ck2, checkpoint_every=2)
    with pytest.raises(ValueError, match="different query"):
        qs["town"]().collect_stream(checkpoint_dir=ck2, resume=True)
    out = qs["city"]().collect_stream(checkpoint_dir=ck2, resume=True).to_numpy()
    assert sorted(out["k"].tolist()) == sorted(f"city{i:02d}" for i in range(50))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _run("groupby", ds, resume=True)


def test_checkpointing_without_faults_is_transparent(ds, tmp_path):
    for name in ("groupby", "join"):
        ref, _ = _run(name, ds)
        ck = str(tmp_path / f"ck_{name}")
        out, info = _run(name, ds, checkpoint_dir=ck, checkpoint_every=2)
        _assert_same(ref, out)
        assert info["checkpoints"] >= 1 and StreamCheckpoint(ck).steps() == []
        out, _ = _run(name, ds, checkpoint_dir=str(tmp_path / "empty"), resume=True)
        _assert_same(ref, out)


def test_to_batches_resume_re_yields_from_the_cursor(ds, tmp_path):
    ref = list(_pipeline("groupby", ds).to_batches())
    ck = str(tmp_path / "ck")
    got = []
    with fault_scope(FaultPlan(kill_after={"device_op": 5})):
        with pytest.raises(InjectedFault):
            for b in _pipeline("groupby", ds).to_batches(checkpoint_dir=ck,
                                                         checkpoint_every=2):
                got.append(b)
    resumed = list(_pipeline("groupby", ds).to_batches(checkpoint_dir=ck, resume=True))
    assert got == [] and len(resumed) == len(ref)
    for a, b in zip(ref, resumed):
        _assert_same(a, b)
    # a streamable plan yields per morsel; a kill mid-way resumes at the cursor
    lz = lambda: stream.scan_dataset(ds[0], _ctx(), batch_rows=512).select(
        col("v") > 0)
    whole = list(lz().to_batches())
    ck2 = str(tmp_path / "ck2")
    first = []
    with fault_scope(FaultPlan(kill_after={"chunk_decode": 5})):
        with pytest.raises(InjectedFault):
            for b in lz().to_batches(checkpoint_dir=ck2, checkpoint_every=2, prefetch=False):
                first.append(b)
    rest = list(lz().to_batches(checkpoint_dir=ck2, resume=True))
    assert len(first) == 5 and len(rest) == len(whole) - 4  # snapshot after batch 4
    for a, b in zip(first[:4] + rest, whole):
        _assert_same(a, b)


def test_adaptive_resume_mid_correction(tmp_path):
    rng = np.random.default_rng(3)
    k = np.concatenate([rng.integers(0, 300, 3000), np.full(3000, 7)]).astype(np.int32)
    man = write_dataset({"k": k, "v": rng.integers(0, 100, 6000).astype(np.int32)},
                        str(tmp_path / "skewed"), chunk_rows=500)
    q = lambda: stream.scan_dataset(man, _ctx(4), batch_rows=750).groupby(
        ("k",), {"v": ("sum", "count")})
    base = q().collect_stream().to_numpy()
    ck = str(tmp_path / "ck")
    with fault_scope(FaultPlan(kill_after={"device_op": 5})):
        with pytest.raises(InjectedFault):
            q().collect_stream(adaptive=True, replan_every=2, checkpoint_dir=ck,
                               checkpoint_every=1)
    manifest, _ = StreamCheckpoint(ck).load()
    state = manifest["active_meta"]["adaptive"]
    assert state["replans"] >= 1 and state["quota_override"] is not None
    res = q().collect_stream(adaptive=True, replan_every=2, checkpoint_dir=ck,
                             resume=True).to_numpy()
    canon = lambda h: {k: v[np.lexsort((h["v_sum"], h["k"]))] for k, v in h.items()}
    _assert_same(canon(base), canon(res))
