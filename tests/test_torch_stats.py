"""The port's datasets, statistics and cost-model pieces
(``repro_torch.data``, ``repro_torch.stats``, ``repro_torch.core.cost_model``)
against the reference's.

- The same seeded numpy columns written by either package's
  ``write_dataset`` / ``csv_to_dataset`` give the same ``manifest.json``
  text (sketches included) and the same chunk members, and each package
  opens and reads the other's dataset identically.
- Sketches (``hash32``, ``ColumnStats``, merges, backfill) are equal.
- Estimates over the same predicates are equal: ``chunk_skip_mask``,
  ``predicate_selectivity``, ``key_cardinality``, ``plan_stats``, and the
  ``explain()`` text a sketch-informed plan prints.
- ``choose_batch_rows``, ``pattern_cost`` and the Table 3/4 costs are equal
  given the same explicit ``CostParams`` values.
- The adaptive controller makes the same decisions from the same
  observations, and partitioned CSV I/O lays out the same partitions.
"""

import csv
import dataclasses
import json
import os
import re

import jax
import numpy as np
import pytest

from repro import expr as ref_expr
from repro import stats as ref_stats
from repro import stream as ref_stream
from repro.core import DDFContext as RefContext
from repro.core import cost_model as ref_cost
from repro.core.comm.communicator import FabricProfile as RefFabric
from repro.data import dataset as ref_dataset
from repro.data import io as ref_io
from repro.plan import logical as ref_logical
from repro_torch import expr as port_expr
from repro_torch import stats as port_stats
from repro_torch import stream as port_stream
from repro_torch.core import DDFContext
from repro_torch.core import cost_model as port_cost
from repro_torch.data import dataset as port_dataset
from repro_torch.data import io as port_io
from repro_torch.plan import logical as port_logical

PKGS = {"ref": ref_dataset, "port": port_dataset}
WORDS = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen"])


def _columns(seed=0, n=1000):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n).astype(np.float32)
    f[::97] = np.nan  # NaN rows: unusable bounds in the chunks that hold one
    return {"i64": rng.integers(-2**40, 2**40, n),
            "i32": np.sort(rng.integers(0, 5000, n)).astype(np.int32),
            "f32": f,
            "f64": rng.random(n),
            "b": rng.random(n) < 0.3,
            "s": WORDS[rng.integers(0, 8, n)]}


def _manifest_text(directory):
    with open(os.path.join(directory, "manifest.json")) as f:
        return f.read()


def _sketches(man):
    return None if man.stats is None else [cs.to_json() for cs in man.stats]


def _same_chunk(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8))


@pytest.mark.parametrize("compress", [True, False])
def test_write_dataset_gives_the_references_files(tmp_path, compress):
    data = _columns()
    out = {name: mod.write_dataset(data, str(tmp_path / name), chunk_rows=300,
                                   compress=compress)
           for name, mod in PKGS.items()}
    assert _manifest_text(out["ref"].directory) == _manifest_text(out["port"].directory)
    assert _sketches(out["ref"]) == _sketches(out["port"]) is not None
    for fname, _ in out["ref"].chunks:
        with np.load(os.path.join(out["ref"].directory, fname)) as a, \
                np.load(os.path.join(out["port"].directory, fname)) as b:
            _same_chunk({k: a[k] for k in a.files}, {k: b[k] for k in b.files})


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_dataset_reads_identically_in_the_other_package(tmp_path, writer, reader):
    data = _columns(seed=1)
    man = PKGS[writer].write_dataset(data, str(tmp_path / "ds"), chunk_rows=256)
    theirs = PKGS[reader].open_dataset(man.directory)
    mine = PKGS[writer].open_dataset(man.directory)
    assert (theirs.schema, theirs.chunks, theirs.vocabs, theirs.stats_k) == \
        (mine.schema, mine.chunks, mine.vocabs, mine.stats_k)
    assert _sketches(theirs) == _sketches(mine) is not None
    assert theirs.row_bytes() == mine.row_bytes()
    for i in range(len(man.chunks)):
        _same_chunk(PKGS[reader].read_chunk(theirs, i), PKGS[writer].read_chunk(mine, i))
    skip = [i % 3 == 1 for i in range(len(man.chunks))]
    for lo, hi in ((0, 1000), (100, 733), (700, 701)):
        _same_chunk(PKGS[reader].read_rows(theirs, lo, hi, ("i32", "s"), skip_chunks=skip),
                    PKGS[writer].read_rows(mine, lo, hi, ("i32", "s"), skip_chunks=skip))


def test_writer_resume_and_backfill_match_the_reference(tmp_path):
    data = _columns(seed=2, n=700)
    mans = {}
    for name, mod in PKGS.items():
        w = mod.DatasetWriter(str(tmp_path / name), chunk_rows=200)
        w.append({k: v[:450] for k, v in data.items()})
        chunks, buffered = w.state()
        w2 = mod.DatasetWriter.resume(w.directory, w._schema, chunks, buffered,
                                      chunk_rows=200)
        w2.append({k: v[450:] for k, v in data.items()})
        man = w2.close()
        assert man.stats is None  # resumed writers close without sketches
        mans[name] = mod.open_dataset(man.directory)
    ref_back = ref_stats.backfill_stats(mans["ref"].directory)
    port_back = port_stats.backfill_stats(mans["port"].directory)
    assert _sketches(ref_back) == _sketches(port_back) is not None
    assert _manifest_text(mans["ref"].directory) == _manifest_text(mans["port"].directory)


def test_csv_ingestion_matches_the_reference(tmp_path):
    path = str(tmp_path / "in.csv")
    rng = np.random.default_rng(3)
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["b", "a", "s"])
        for i in range(130):
            wr.writerow([rng.integers(-9, 9) * 0.25, i, WORDS[i % 5]])
    schema = {"a": np.int32, "b": np.float32, "s": "dict"}
    mans = {name: mod.csv_to_dataset([path], schema, str(tmp_path / name), chunk_rows=40)
            for name, mod in PKGS.items()}
    assert _manifest_text(mans["ref"].directory) == _manifest_text(mans["port"].directory)
    _same_chunk(port_dataset.read_rows(mans["port"], 0, 130),
                ref_dataset.read_rows(mans["ref"], 0, 130))
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as f:
        f.write("a,b,s\n1,x,y\n")
    for mod in PKGS.values():
        with pytest.raises(mod.DatasetSchemaError, match="'b'"):
            mod.csv_to_dataset([bad], schema, str(tmp_path / "bad"))


# -- sketches ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int64", "uint64", "int32", "int8", "bool", "float32",
                                   "float64", "float16", "str", "dups"])
def test_hash32_and_column_sketch_equal_by_bits(dtype):
    rng = np.random.default_rng(4)
    if dtype == "dups":  # many rows per distinct value: the sketch's prefix grows
        x = rng.integers(0, 150, 20_000).astype(np.int32)
    elif dtype == "str":
        x = WORDS[rng.integers(0, 8, 500)]
    elif dtype == "bool":
        x = rng.random(500) < 0.5
    elif dtype.startswith("float"):
        x = rng.standard_normal(500).astype(dtype)
        x[:4] = [0.0, -0.0, np.inf, np.nan]
    else:
        x = rng.integers(0, 120, 500).astype(dtype) * (3 if dtype != "int8" else 1)
    np.testing.assert_array_equal(port_stats.hash32(x), ref_stats.hash32(x))
    for k in (8, 128):
        assert port_stats.ColumnStats.from_array(x, k).to_json() == \
            ref_stats.ColumnStats.from_array(x, k).to_json()


def test_chunk_sketches_merge_like_the_reference():
    rng = np.random.default_rng(5)
    parts = [{"x": rng.integers(lo, lo + 900, 3000), "y": rng.standard_normal(3000)}
             for lo in (0, 400, 5000)]
    for mod in (ref_stats, port_stats):
        assert mod.merge_chunk_stats([]).count == 0
    ref_m = ref_stats.merge_chunk_stats([ref_stats.ChunkStats.from_columns(p) for p in parts])
    port_m = port_stats.merge_chunk_stats([port_stats.ChunkStats.from_columns(p)
                                           for p in parts])
    assert port_m.to_json() == ref_m.to_json()
    assert port_m.column("x").distinct() == ref_m.column("x").distinct()
    again = port_stats.ChunkStats.from_json(json.loads(json.dumps(port_m.to_json())))
    assert again == port_m


# -- estimates -----------------------------------------------------------------

def _preds(X):
    c = X.col
    return {"gt": c("a") > 800, "le": c("a") <= 10, "and": (c("a") >= 100) & (c("b") < 50),
            "eq": c("b").eq(999), "sum": (c("a") + c("b")) > 1500, "ne": c("a").ne(5),
            "or": (c("a") < 50) | (c("a") > 990), "cast": c("a").cast("float32") < 30.5,
            "neg": -c("a") > -20, "when": X.when(c("a") > 500).then(1).otherwise(0) > 0,
            "mod": (c("b") % 7).eq(3), "str": c("s").eq("cat")}


def _scan_ds(tmp_path, seed=11):
    rng = np.random.default_rng(seed)
    data = {"a": np.sort(rng.integers(0, 1000, 2000)).astype(np.int32),
            "b": rng.integers(0, 1000, 2000).astype(np.int32),
            "s": np.sort(WORDS[rng.integers(0, 8, 2000)])}
    return {name: mod.write_dataset(data, str(tmp_path / name), chunk_rows=250)
            for name, mod in PKGS.items()}


def _bind(X, e, man):
    return X.prepare_row_expr(e, man.column_names, "scan", vocabs=man.vocab_map)


@pytest.mark.parametrize("pred", sorted(_preds(ref_expr)))
def test_skip_mask_and_selectivity_equal(tmp_path, pred):
    mans = _scan_ds(tmp_path)
    r_e = _bind(ref_expr, _preds(ref_expr)[pred], mans["ref"])
    p_e = _bind(port_expr, _preds(port_expr)[pred], mans["port"])
    np.testing.assert_array_equal(port_stats.chunk_skip_mask(mans["port"], (p_e,)),
                                  ref_stats.chunk_skip_mask(mans["ref"], (r_e,)))
    vocabs = mans["ref"].vocab_map
    for i in range(len(mans["ref"].chunks)):
        rcs, pcs = mans["ref"].stats[i], mans["port"].stats[i]
        assert port_stats.predicate_selectivity(p_e, pcs, mans["port"].schema, vocabs) == \
            ref_stats.predicate_selectivity(r_e, rcs, mans["ref"].schema, vocabs)
    merged = ref_stats.merge_chunk_stats(mans["ref"].stats)
    assert port_stats.predicate_selectivity(
        p_e, port_stats.merge_chunk_stats(mans["port"].stats), mans["port"].schema,
        vocabs) == ref_stats.predicate_selectivity(r_e, merged, mans["ref"].schema, vocabs)


def test_expr_interval_equal():
    def intervals(X, S):
        ranges = {"a": S.Interval(0.0, 10.0), "b": S.Interval(-5.0, 5.0)}
        c = X.col
        got = [S.expr_interval(e, ranges) for e in (
            c("a") + c("b"), c("a") > 20, c("a") >= 0, (c("a") > 20) & (c("c") > 0),
            c("c") * 2, abs(c("b")), c("a") // 3, c("a") / c("b"), ~(c("a") > 3))]
        return [None if g is None else (g.lo, g.hi, g.boolish) for g in got]

    assert intervals(port_expr, port_stats) == intervals(ref_expr, ref_stats)


def _ref_ctx():
    return RefContext(mesh=jax.make_mesh((1,), ("data",)), axes=("data",))


def _scan_of(lazy, L):
    return next(n for n in L.walk(lazy._root) if isinstance(n, L.Scan))


def test_cardinality_row_estimates_and_plan_stats_equal(tmp_path):
    rng = np.random.default_rng(2)
    data = {"a": np.arange(10_000, dtype=np.int32),
            "k": rng.integers(0, 40, 10_000).astype(np.int32)}
    mans = {name: mod.write_dataset(data, str(tmp_path / name), chunk_rows=1000)
            for name, mod in PKGS.items()}
    assert port_stats.key_cardinality(mans["port"], ("k",)) == \
        ref_stats.key_cardinality(mans["ref"], ("k",))
    assert port_stats.key_cardinality(mans["port"], ("k", "a")) == \
        ref_stats.key_cardinality(mans["ref"], ("k", "a"))
    assert port_stats.key_cardinality(mans["port"], ("zz",)) is None
    ref_q = ref_stream.scan_dataset(mans["ref"], _ref_ctx(),
                                    predicate=ref_expr.col("a") >= 9000)
    port_q = port_stream.scan_dataset(mans["port"], DDFContext(nworkers=1, device="cpu"),
                                      predicate=port_expr.col("a") >= 9000)
    ref_scan, port_scan = _scan_of(ref_q, ref_logical), _scan_of(port_q, port_logical)
    assert port_stats.scan_row_estimate(mans["port"], port_scan) == \
        ref_stats.scan_row_estimate(mans["ref"], ref_scan)
    rps = ref_stats.plan_stats({ref_scan.sid: mans["ref"]})
    pps = port_stats.plan_stats({port_scan.sid: mans["port"]})
    assert rps.has(ref_scan.sid) and pps.has(port_scan.sid)
    assert pps.scan_selectivity(port_scan) == rps.scan_selectivity(ref_scan)
    assert pps.scan_rows(port_scan) == rps.scan_rows(ref_scan)
    rg = ref_q.groupby(("k",), {"a": ("sum",)})._root
    pg = port_q.groupby(("k",), {"a": ("sum",)})._root
    assert pps.groupby_cardinality(pg) == rps.groupby_cardinality(rg)
    ru, pu = ref_q.unique(("k",))._root, port_q.unique(("k",))._root
    assert pps.unique_cardinality(pu) == rps.unique_cardinality(ru)
    # the key is a content hash of the sketches: equal sketches, equal keys
    # when both packages number their scans alike
    assert port_stats.plan_stats({0: mans["port"]}).cache_key == \
        ref_stats.plan_stats({0: mans["ref"]}).cache_key
    assert port_stats.plan_stats({1: dataclasses.replace(mans["port"], stats=None)}) is None


def _renumber(text):
    return re.sub(r"SCAN#\d+", "SCAN#", text)


def test_sketch_informed_explain_matches_the_reference(tmp_path):
    rng = np.random.default_rng(8)
    data = {"a": np.arange(4000, dtype=np.int32),
            "k": rng.integers(0, 300, 4000).astype(np.int32),
            "v": rng.integers(0, 100, 4000).astype(np.int32)}
    mans = {name: mod.write_dataset(data, str(tmp_path / name), chunk_rows=500)
            for name, mod in PKGS.items()}

    def q(S, X, man, ctx):
        return (S.scan_dataset(man, ctx, batch_rows=1000, predicate=X.col("a") >= 3100)
                .groupby(("k",), {"v": ("sum", "max")}))

    for optimized in (True, False):
        ref_txt = q(ref_stream, ref_expr, mans["ref"], _ref_ctx()).explain(optimized)
        port_txt = q(port_stream, port_expr, mans["port"],
                     DDFContext(nworkers=1, device="cpu")).explain(optimized)
        assert "sel~" in port_txt
        assert _renumber(port_txt) == _renumber(ref_txt)


# -- cost model ----------------------------------------------------------------

def _params():
    port = port_cost.CostParams()
    ref = ref_cost.CostParams(RefFabric("device", port.alpha, port.beta),
                              port.gamma_s_per_row)
    return port, ref


@pytest.mark.parametrize("pattern", ["embarrassingly_parallel", "shuffle_compute",
                                     "sample_shuffle_compute", "combine_shuffle_reduce",
                                     "broadcast_compute", "globally_reduce", "halo_exchange",
                                     "partitioned_io"])
def test_pattern_cost_equals_the_reference(pattern):
    port, ref = _params()
    for core_op in ("groupby", "hash_join", "sort"):
        for k in (1, 4):
            kw = dict(P=8, n_rows=1e6, row_bytes=12.0, cardinality=0.3, core_op=core_op,
                      num_chunks=k)
            assert port_cost.pattern_cost(pattern, params=port, **kw) == \
                ref_cost.pattern_cost(pattern, params=ref, **kw)


def test_batch_rows_and_collective_costs_equal_the_reference():
    port, ref = _params()
    for P in (1, 3, 8):
        for rb in (1.0, 8.0, 36.5):
            for kw in ({}, {"total_rows": 5000}, {"memory_budget_bytes": 1e9},
                       {"dispatch_overhead_s": 1e-5, "min_rows": 1}):
                assert port_cost.choose_batch_rows(P, rb, port, **kw) == \
                    ref_cost.choose_batch_rows(P, rb, ref, **kw)
        for fn in ("t_broadcast", "t_reduce", "t_allreduce"):
            assert getattr(port_cost, fn)(P, 1e6, port) == getattr(ref_cost, fn)(P, 1e6, ref)
        assert port_cost.t_shuffle_pipelined(P, 1e6, 4, port, core_s=1e-3) == \
            ref_cost.t_shuffle_pipelined(P, 1e6, 4, ref, core_s=1e-3)
    for op in port_cost.LOCAL_COSTS:
        assert port_cost.t_local(op, 1e5, 0.2, port) == ref_cost.t_local(op, 1e5, 0.2, ref)
    for name in ("ADAPTIVE_REPLAN_EVERY", "ADAPTIVE_DRIFT", "ADAPTIVE_QUOTA_SAFETY",
                 "ADAPTIVE_CAPACITY_SAFETY"):
        assert getattr(port_cost, name) == getattr(ref_cost, name)
    # one card: every fabric name gives the card's profile
    assert port_cost.params_for_fabric("ici") == port_cost.params_for_fabric() == port


# -- adaptive controller ---------------------------------------------------------

def test_adaptive_controller_decides_as_the_reference():
    rng = np.random.default_rng(9)
    ctrls = [ref_stats.AdaptiveController(8, 100, 1000, replan_every=2),
             port_stats.AdaptiveController(8, 100, 1000, replan_every=2)]
    nodes = [L.GroupBy(L.Source(0, (("k", "int32", ()), ("v", "int32", ())), 1000), ("k",),
                       (("v", ("sum",)),), None, None, 100, 1000, 2)
             for L in (ref_logical, port_logical)]
    for step in range(12):
        hist = rng.integers(0, 60 + 40 * step, 8)
        obs = dict(rows_in=int(rng.integers(100, 900)), hist=hist,
                   groups_out=int(rng.integers(1, 400)),
                   max_worker_groups=int(rng.integers(1, 120)))
        decisions = []
        for c, node in zip(ctrls, nodes):
            c.observe(**obs)
            replan = c.should_replan()
            pinned = c.apply(node) if replan else c.pin(node)
            decisions.append((replan, c.state_dict(), pinned.quota, pinned.capacity,
                              pinned.num_chunks, pinned.cardinality_hint))
        assert decisions[0] == decisions[1]
    assert ctrls[1].replans >= 1
    again = port_stats.AdaptiveController.restore(ctrls[1].state_dict())
    assert again.state_dict() == ctrls[0].state_dict()


# -- partitioned CSV I/O ----------------------------------------------------------

def test_partitioned_csv_io_matches_the_reference(tmp_path):
    rng = np.random.default_rng(10)
    files = []
    for i, n in enumerate((7, 0, 12)):
        path = str(tmp_path / f"in{i}.csv")
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            if n:
                wr.writerow(["k", "v", "s"])
            for _ in range(n):
                wr.writerow([rng.integers(0, 50), rng.integers(-5, 5) * 0.5,
                             WORDS[rng.integers(0, 8)]])
        files.append(path)
    schema = {"k": np.int64, "v": np.float32, "s": "dict"}
    ref = ref_io.read_csv_dist(files, schema, _ref_ctx())
    port = port_io.read_csv_dist(files, schema, DDFContext(nworkers=1, device="cpu"))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    for k, v in ref.columns.items():
        np.testing.assert_array_equal(port.columns[k].numpy().reshape(-1), np.asarray(v))
    assert port.vocabs["s"].words == ref.vocabs["s"].words
    ports = port_io.write_csv_dist(port, str(tmp_path / "port_out"))
    refs = ref_io.write_csv_dist(ref, str(tmp_path / "ref_out"))
    for a, b in zip(ports, refs):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    port4 = port_io.read_csv_dist(files, schema, DDFContext(nworkers=4, device="cpu"))
    assert port4.counts.tolist() == [7, 0, 12, 0]
    with pytest.raises(ValueError, match="capacity"):
        port_io.read_csv_dist(files, schema, DDFContext(nworkers=1, device="cpu"),
                              capacity=3)


def test_synthetic_generators_match_the_reference():
    from repro.data import synthetic as ref_synth
    from repro_torch.data import synthetic as port_synth

    for name, kw in (("uniform_table", {"n_rows": 500, "cardinality": 0.3, "seed": 3}),
                     ("zipf_table", {"n_rows": 500, "a": 1.3, "seed": 4}),
                     ("synthetic_token_corpus", {"n_docs": 60, "vocab": 100, "seed": 5})):
        ref, port = getattr(ref_synth, name)(**kw), getattr(port_synth, name)(**kw)
        assert sorted(ref) == sorted(port)
        for k in ref:
            assert ref[k].dtype == port[k].dtype
            np.testing.assert_array_equal(ref[k], port[k])
