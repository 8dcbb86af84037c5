"""The port's streaming engine (``repro_torch.stream``) against the
reference's (``repro.stream``).

- The same seeded numpy tables, written once as chunked datasets (by the
  reference's writer, read by both packages), go through both packages'
  ``scan_dataset`` / ``scan_csv`` pipelines at the same explicit
  ``batch_rows``, at P = 1: EP concatenation, a streamed join with an
  in-memory table, groupby and unique carry merges, sort by spill, the
  scan x scan spill join, staged blocking nodes, string keys, chunk
  skipping. Rows are compared after a canonical sort: integer columns by
  bits, float sums within float32 rounding (the data are quarter-valued,
  so most are exact). ``last_info``'s ``batches``, ``chunks_decoded`` and
  ``chunks_skipped`` must be equal.
- ``to_batches``, ``collect()`` routing, ``collect(profile=True)`` and
  ``explain(analyze=True)`` (the same modeled patterns as the reference).
- The host key->partition mirror (``runner._np_hash_columns``) gives the
  port's ``hash_partition`` destinations by bits, NaN payloads and signed
  zeros included.
- At P = 4 (port only) every pipeline gives the P = 1 rows, and the
  adaptive re-plan is result-invariant.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from repro import expr as ref_expr
from repro import stream as ref_stream
from repro.core import DDFContext as RefContext
from repro.data import dataset as ref_dataset
from repro_torch import expr as port_expr
from repro_torch import obs as port_obs
from repro_torch import stream as port_stream
from repro_torch.core import DDF, DDFContext
from repro_torch.core.dataframe import Table
from repro_torch.core.partition import hash_partition_ids
from repro_torch.stream import runner as port_runner

WORDS = np.array([f"city{i:02d}" for i in range(40)])


@pytest.fixture(scope="module")
def ref_ctx():
    return RefContext(mesh=jax.make_mesh((1,), ("data",)), axes=("data",))


def _port_ctx(P=1):
    return DDFContext(nworkers=P, device="cpu")


def _table(n, nkeys, seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, nkeys, n).astype(np.int32),
            "v": rng.integers(0, 1000, n).astype(np.int32),
            "f": (rng.integers(-400, 400, n) / 4).astype(np.float32)}


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    root = tmp_path_factory.mktemp("streamds")
    left = _table(3000, 150, 1)
    left["a"] = np.arange(3000, dtype=np.int32)  # sorted: chunk skipping
    right = _table(900, 150, 2)
    right = {"k": right["k"], "w": right["v"]}
    t = _table(2000, 40, 3)
    strs = {"s": WORDS[t["k"]], "v": t["v"]}
    out = {"left": ref_dataset.write_dataset(left, str(root / "left"), chunk_rows=350),
           "right": ref_dataset.write_dataset(right, str(root / "right"), chunk_rows=200),
           "str": ref_dataset.write_dataset(strs, str(root / "str"), chunk_rows=300),
           "small": right}
    path = str(root / "left.csv")
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["k", "v", "f"])
        for i in range(1200):
            wr.writerow([left["k"][i], left["v"][i], left["f"][i]])
    out["csv"] = path
    out["root"] = str(root)
    return out


def _pipeline(name, S, X, ctx, ds, eager_table):
    """Named pipelines over the module's datasets, for either package (S the
    stream module, X the expression module, eager_table builds an eager
    DDF of that package from numpy)."""
    scan = lambda key, **kw: S.scan_dataset(ds[key].directory, ctx, batch_rows=400, **kw)
    c = X.col
    if name == "ep":
        return (scan("left").select((c("v") % 2).eq(0))
                .with_column("w2", c("v") * 2 + c("k")).project(["k", "v", "w2", "f"]))
    if name == "ep_callable":
        return scan("left").select(lambda t: t["v"] > 500, name="gt").project(["k", "f"])
    if name == "join_source":
        return (scan("left").project(["k", "v"])
                .join(eager_table(ds["small"]).lazy(), on=("k",), strategy="shuffle",
                      capacity=4000))
    if name == "groupby":
        return scan("left").groupby(("k",), {"v": ("sum", "count", "mean", "min", "max"),
                                             "f": ("sum", "max", "min")})
    if name == "groupby_exprs":
        return (scan("left", predicate=c("v") < 700)
                .with_column("c2", X.when(c("v") < 300).then(1).otherwise(0))
                .groupby(("k",), [c("v").sum(), c("v").min(), c("v").max(), c("v").count(),
                                  c("v").mean().alias("avg"), c("c2").sum()]))
    if name == "unique":
        return scan("left").project(["k", "v"]).unique(("k",))
    if name == "sort":
        return scan("left").project(["k", "v"]).sort_values("v")
    if name == "sort_desc":
        return scan("left").project(["v", "f"]).sort_values("f", descending=True)
    if name == "join":
        return (scan("left").project(["k", "v"]).join(scan("right"), on=("k",))
                .groupby(("k",), {"v": ("sum",), "w": ("sum", "count")}))
    if name == "multi":
        return scan("left").project(["k", "v"]).unique(("k",)).sort_values("k")
    if name == "strgroupby":
        return scan("str").groupby(("s",), {"v": ("sum", "count", "max")})
    if name == "skip":
        return scan("left", predicate=c("a") >= 2500, columns=("k", "v"))
    if name == "csv":
        return S.scan_csv([ds["csv"]], {"k": np.int32, "v": np.int32, "f": np.float32}, ctx,
                          chunk_rows=250, batch_rows=300).groupby(("k",), {"f": ("sum",)})
    raise ValueError(name)


PIPELINES = ("ep", "ep_callable", "join_source", "groupby", "groupby_exprs", "unique", "sort",
             "sort_desc", "join", "multi", "strgroupby", "skip", "csv")


def _port_pipeline(name, ds, P=1):
    ctx = _port_ctx(P)
    return _pipeline(name, port_stream, port_expr, ctx, ds,
                     lambda d: DDF.from_numpy(d, ctx))


def _ref_pipeline(name, ds, ctx):
    from repro.core import DDF as RefDDF
    return _pipeline(name, ref_stream, ref_expr, ctx, ds,
                     lambda d: RefDDF.from_numpy(d, ctx, mode="eager"))


def _canon(host):
    order = np.lexsort(tuple(host[k] for k in sorted(host)))
    return {k: v[order] for k, v in host.items()}


def _same_rows(got, want, ordered=False):
    assert sorted(got) == sorted(want)
    if not ordered:
        got, want = _canon(got), _canon(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=2e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


COUNTERS = ("batches", "chunks_decoded", "chunks_skipped")


@pytest.mark.parametrize("name", PIPELINES)
def test_collect_stream_matches_the_reference(ds, ref_ctx, name):
    ref_lz = _ref_pipeline(name, ds, ref_ctx)
    want = ref_lz.collect_stream().to_numpy()
    port_lz = _port_pipeline(name, ds)
    got = port_lz.collect_stream().to_numpy()
    # sorts and EP concatenation keep the reference's row order too
    _same_rows(got, want, ordered=name in ("ep", "ep_callable", "sort", "skip"))
    for k in COUNTERS:
        assert port_lz.last_info[k] == ref_lz.last_info[k], k
    overflow = {k: int(v.sum()) for k, v in port_lz.last_info.items() if "overflow" in k}
    assert not any(overflow.values())
    assert set(overflow) == {k for k in ref_lz.last_info if "overflow" in k}
    if name == "skip":
        assert port_lz.last_info["chunks_skipped"] > 0


def test_to_batches_matches_the_reference(ds, ref_ctx):
    for name in ("ep", "groupby", "strgroupby"):
        ref_parts = list(_ref_pipeline(name, ds, ref_ctx).to_batches())
        port_parts = list(_port_pipeline(name, ds).to_batches())
        assert len(port_parts) == len(ref_parts)
        for a, b in zip(port_parts, ref_parts):
            _same_rows(a, b, ordered=name == "ep")
    assert len(port_parts) == 1 and port_parts[0]["s"].dtype.kind == "U"  # decoded


def test_collect_routes_scans_to_the_runner(ds):
    lz = _port_pipeline("groupby", ds)
    plain = lz.collect().to_numpy()
    assert lz.last_info["batches"] == 8  # 3000 rows / 400-row morsels
    _same_rows(plain, _port_pipeline("groupby", ds).collect_stream().to_numpy())
    with pytest.raises(ValueError, match="level"):
        lz.collect(level="plan-only")
    off = _port_pipeline("groupby", ds).collect_stream(prefetch=False).to_numpy()
    _same_rows(off, plain)


def test_profile_and_analyze_match_the_references_patterns(ds, ref_ctx):
    for name in ("groupby", "join_source"):
        ref_lz = _ref_pipeline(name, ds, ref_ctx)
        ref_lz.collect(profile=True)
        port_lz = _port_pipeline(name, ds)
        port_lz.collect(profile=True)
        ref_rep = ref_lz.last_profile.report()["model"]
        port_rep = port_lz.last_profile.report()["model"]
        assert {p: d["count"] for p, d in port_rep.items()} == \
            {p: d["count"] for p, d in ref_rep.items()}
        assert all(d["observed_s"] > 0 and d["predicted_s"] > 0 for d in port_rep.values())
        assert not port_obs.trace.enabled()
    text = _port_pipeline("groupby", ds).explain(analyze=True)
    assert "-- profile (predicted vs observed) --" in text
    assert "-- per-pattern model error --" in text and "partitioned_io" in text
    # an in-memory plan profiles through the executor's program records
    from repro.core import DDF as RefDDF
    ref_lz = RefDDF.from_numpy(ds["small"], ref_ctx, mode="lazy").groupby(("k",), {"w": ("sum",)})
    ref_lz.collect(profile=True)
    lz = DDF.from_numpy(ds["small"], _port_ctx()).lazy().groupby(("k",), {"w": ("sum",)})
    lz.collect(profile=True)
    assert set(lz.last_profile.report()["model"]) == \
        set(ref_lz.last_profile.report()["model"]) == {"combine_shuffle_reduce"}


@pytest.mark.parametrize("P", [1, 3, 8])
def test_host_hash_mirror_gives_the_kernel_destinations(P):
    rng = np.random.default_rng(P)
    n = 4000
    f = rng.standard_normal(n).astype(np.float32)
    bits = f.view(np.uint32)
    bits[:8] = [0x00000000, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7FC00123, 0xFFBFFFFF,
                0x7F800000, 0xFF800000]  # +-0, NaNs of both signs and with payloads, +-inf
    host = {"k": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), "f": f,
            "b": rng.random(n) < 0.5, "s": rng.integers(-100, 100, n).astype(np.int16)}
    for keys in (("k",), ("f",), ("f", "k"), ("b", "s", "f")):
        mirror = port_runner._np_hash_columns(host, keys) % np.uint32(P)
        t = Table({k: torch.from_numpy(host[k].copy())[None, :] for k in keys},
                  torch.tensor([n], dtype=torch.int32))
        dest = hash_partition_ids(t, keys, P)[0].numpy()
        np.testing.assert_array_equal(dest.astype(np.uint32), mirror.astype(np.uint32))


@pytest.mark.parametrize("name", ["ep", "join_source", "groupby", "unique", "sort", "join",
                                  "multi", "strgroupby", "skip"])
def test_more_workers_give_the_same_rows(ds, name):
    one = _port_pipeline(name, ds).collect_stream().to_numpy()
    lz = _port_pipeline(name, ds, P=4)
    four = lz.collect_stream().to_numpy()
    _same_rows(four, one, ordered=name in ("sort",))
    assert not any(int(v.sum()) for k, v in lz.last_info.items() if "overflow" in k)


def _skewed(tmp_path, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    k = np.concatenate([rng.integers(0, 300, n // 2), np.full(n - n // 2, 7)]).astype(np.int32)
    v = rng.integers(0, 100, n).astype(np.int32)
    return ref_dataset.write_dataset({"k": k, "v": v}, str(tmp_path / "skewed"), chunk_rows=500)


def test_adaptive_replan_is_result_invariant(tmp_path):
    man = _skewed(tmp_path)
    q = lambda: port_stream.scan_dataset(man.directory, _port_ctx(4), batch_rows=750) \
        .groupby(("k",), {"v": ("sum", "count")})
    base = q().collect_stream().to_numpy()
    lz = q()
    adpt = lz.collect_stream(adaptive=True, replan_every=2).to_numpy()
    assert lz.last_info["replans"] >= 1
    _same_rows(adpt, base)
    with port_obs.profiled() as prof:  # tracing on: quota accuracy records
        q().collect_stream(adaptive=True, replan_every=2)
    assert any(r.pattern == "shuffle_quota" for r in prof.records)


def test_stream_execution_steps_and_metrics(ds):
    before = port_obs.registry().counters().get("stream.batches", 0)
    ex = port_stream.StreamExecution(_port_pipeline("groupby", ds), batch_rows=1000)
    assert ex.nominal_batch_rows == 1000
    events = list(ex.steps())
    assert events.count("carry") == 3 and ex.info["batches"] == 3
    assert port_obs.registry().counters()["stream.batches"] == before + 3
    with pytest.raises(RuntimeError, match="once"):
        next(ex.steps())
    _same_rows(ex.result.to_numpy(), _port_pipeline("groupby", ds).collect().to_numpy())


def test_scan_rejects_bad_inputs(ds):
    ctx = _port_ctx()
    with pytest.raises(KeyError, match="unknown column"):
        port_stream.scan_dataset(ds["left"].directory, ctx, columns=("zz",))
    with pytest.raises(TypeError, match="expression"):
        port_stream.scan_dataset(ds["left"].directory, ctx, predicate=lambda c: c["v"] > 3)
    # a float predicate is not host-portable: it stays a device SELECT
    lz = port_stream.scan_dataset(ds["left"].directory, ctx, batch_rows=500,
                                  predicate=port_expr.col("f") * 2 > 1.5)
    assert "SELECT" in lz.explain(optimized=False)
    got = lz.collect_stream().to_numpy()
    host = ref_dataset.read_rows(ds["left"], 0, 3000)
    keep = host["f"] * np.float32(2) > 1.5
    _same_rows(got, {k: v[keep] for k, v in host.items()}, ordered=True)


def test_chip_smoke_stream_path_runs_on_the_cpu():
    """The smoke run's streaming phase at a small size. On the CPU no kernel
    launches, so the dispatch points are wrapped to count into the launch
    registry: the steps with a shuffle reach both, the EP and sort steps
    neither, and none reaches the histogram variant."""
    import sys

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
        res = chip_smoke.run_stream_path(8, 6_000, device="cpu", small_rows_per_worker=1_500,
                                         csv_rows=5_000, chunk_rows=4096,
                                         memory_budget_bytes=48_000)
    finally:
        opmod.hash_partition_ids, lo._seg_reduce_dispatch = hp, sr
    steps = res["steps"]
    assert res["batches"] == steps["groupby"]["batches"] == 4 and res["groups"] > 0
    assert steps["groupby"]["launches"]["hash_partition"] == 4  # one shuffle per batch
    for name in ("groupby", "killed", "resumed", "spill_join", "scan_csv"):
        la = steps[name]["launches"]
        assert la["hash_partition"] > 0 and la["segment_reduce"] > 0, name
    for name in ("to_batches", "sort"):
        assert not any(steps[name]["launches"].values()), name
    assert not any(s["launches"]["hash_partition_hist"] for s in steps.values())
    assert {"partitioned_io"} <= set(res["model_report"])
