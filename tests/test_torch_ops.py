"""The rest of the port's eager DDF against the reference: expressions and
the embarrassingly-parallel ops, the sample sort, the set ops,
Globally-Reduce, the halo-exchange windows, rebalance / head / transpose,
and dict-encoded strings.

- At P=1 both packages run in this process; at P=8 the reference needs 8
  host devices, so this file re-runs itself under ``__main__`` in a
  subprocess (as ``tests/test_torch_ddf.py`` does). Both sides start from
  the same partition layout, and every result must be the reference's:
  each worker's live rows bit for bit (row order, padding excluded), the
  auxiliary outputs (overflow counters, pivots, halo flags), the scalars
  of ``agg`` / ``length``, and the vocabularies. The data are integer
  valued (floats in quarters), so every float32 sum is exact in any order;
  group means may differ by 1 float32 ulp.
- The local operators and collectives are held worker by worker against
  the reference's, and against their definitions.
- A seeded sweep of random pipelines holds the port at P in {1, 3, 8}
  against the numpy oracle (``tests/oracle.py``).
"""

import os
import sys

if __name__ == "__main__":  # the P=8 reference needs its devices before jax loads
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import subprocess
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle  # noqa: E402

from repro import expr as ref_expr  # noqa: E402
from repro.core import DDF as RefDDF  # noqa: E402
from repro.core import DDFContext as RefContext  # noqa: E402
from repro.core import dataframe as ref_df  # noqa: E402
from repro.core import local_ops as ref_local  # noqa: E402
from repro.core import partition as ref_partition  # noqa: E402
from repro_torch import expr as port_expr  # noqa: E402
from repro_torch.core import DDF, DDFContext, local_ops, partition  # noqa: E402
from repro_torch.core.comm import channels, collectives  # noqa: E402
from repro_torch.core.dataframe import Table  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORDS = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen", "ibis"])


def _tables(P, rows_per_worker, seed):
    rng = np.random.default_rng(seed)
    n = P * rows_per_worker

    def table(words):
        return {"k": rng.integers(0, max(n // 3, 2), n).astype(np.int32),
                "v": rng.integers(-1000, 1000, n).astype(np.int32),
                "f": (rng.integers(-200, 200, n) / 4).astype(np.float32),
                "s": words[rng.integers(0, len(words), n)]}

    return table(WORDS[:6]), table(WORDS[3:])


def _raw_parts(columns, counts, P):
    counts = np.asarray(counts)
    cols = {k: np.asarray(v).reshape(P, -1) for k, v in columns.items()}
    return [{k: v[w, : counts[w]] for k, v in cols.items()} for w in range(P)]


def _same_ddf(ref, port, what):
    P = port.ctx.nworkers
    exp = _raw_parts(ref.columns, ref.counts, P)
    got = _raw_parts({k: v.cpu() for k, v in port.columns.items()}, port.counts.cpu(), P)
    for w, (e, g) in enumerate(zip(exp, got)):
        assert set(e) == set(g), (what, w, sorted(e), sorted(g))
        for k in e:
            assert e[k].dtype == g[k].dtype, (what, w, k, e[k].dtype, g[k].dtype)
            if k.endswith(("_mean", "avg")):
                np.testing.assert_array_max_ulp(g[k], e[k], maxulp=1)
            else:
                np.testing.assert_array_equal(g[k], e[k], err_msg=f"{what} worker {w} {k}")
    assert {k: v.words for k, v in ref.vocabs.items()} == \
        {k: v.words for k, v in port.vocabs.items()}, what


def _same(ref, port, what):
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(ref) == len(port), what
        _same_ddf(ref[0], port[0], what)
        ref_info, port_info = ref[1], port[1]
        assert set(ref_info) == set(port_info), what
        for k in ref_info:
            exp = np.asarray(ref_info[k])
            got = port_info[k].cpu().numpy()
            assert got.dtype == exp.dtype, (what, k)
            np.testing.assert_array_equal(got, exp.reshape(got.shape), err_msg=f"{what} {k}")
    elif isinstance(ref, RefDDF):
        _same_ddf(ref, port, what)
    else:  # agg / length scalars
        assert type(port) is type(ref) or np.asarray(port).dtype == np.asarray(ref).dtype, \
            (what, type(ref), type(port))
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref), err_msg=what)


def pipeline(L, R, M, X, rows_per_worker):
    """Every DDF method of the slice on (L, R, M); ``X`` is the expression
    module of the package under test. Returns name -> result."""
    col, lit, when = X.col, X.lit, X.when
    out = {
        "select": L.select((col("v") > 0) & (col("k") % 3).ne(1)),
        "select_string": L.select(col("s") >= "dog"),
        "select_when": L.select(when(col("f") < 0).then(col("v") > 10)
                                .otherwise(col("v") < -10)),
        "select_in": L.select(col("s").is_in(["bee", "fox", "zebra"])),
        "with_column": L.with_column("w", (col("v") * 3 - col("k")) // 7 + lit(1, "int16")),
        "with_scalar": L.with_column("one", 1.5),
        "with_float": L.with_column("h", col("f") / 4 + col("v")),
        "project": L.project(["k", "s"]),
        "drop": L.drop(["f"]),
        "rename": L.rename({"v": "value"}),
        "map_columns": L.map_columns(lambda c: {"k": c["k"], "v1": c["v"] + 1}),
        "sort": L.sort_values("v"),
        "sort_desc": L.sort_values("v", descending=True),
        "sort_float": L.sort_values("f"),
        "sort_string_desc": L.sort_values("s", descending=True),
        "sort_chunked": L.sort_values("k", num_chunks=3),
        # at P > 1 most workers are empty: their max sentinels shift the
        # pivots, in both directions, as in the reference
        "sort_empty_workers": L.head(rows_per_worker + 3).sort_values("v"),
        "sort_desc_empty_workers": L.head(rows_per_worker + 3).sort_values("v", descending=True),
        "union": L.project(["k", "s"]).union(R.project(["k", "s"]), on=("k",)),
        "union_string": L.project(["s"]).union(R.project(["s"]), on=("s",)),
        "difference": L.difference(R, on=("k",)),
        "difference_string": L.difference(R, on=("s",), num_chunks=2),
        "join_string": L.join(R.rename({"v": "v2", "f": "f2", "k": "k2"}), on=("s",),
                              strategy="shuffle"),
        "groupby_exprs": L.groupby(("k",), [col("v").max(), col("v").mean().alias("avg"),
                                            col("f").sum(), col("s").min()],
                                   pre_combine=True),
        # the groupby's padding holds the min identity, an out-of-range
        # code, when the union recodes R's s_min into the merged vocabulary
        "union_string_min": R.groupby(("k",), [col("s").min()])[0].project(["s_min"]).union(
            L.project(["s"]).rename({"s": "s_min"}), on=("s_min",)),
        "groupby_string_key": L.groupby(("s",), {"v": ("sum", "count")}, pre_combine=False),
        "length": L.length(),
        "agg_string_max": L.agg("s", "max"),
        "rolling_sum": L.rolling_sum("v", 3),
        "rebalance": L.select(col("v") > 300).rebalance(),
        "head": L.head(rows_per_worker + 3),
        "transpose": M.transpose(),
    }
    for op in ("sum", "min", "max", "mean", "count"):
        out[f"agg_v_{op}"] = L.agg("v", op)
        out[f"agg_f_{op}"] = L.agg("f", op)
        out[f"rolling_{op}"] = L.rolling("f", 4, op) if op != "count" else L.rolling("v", 1)
    # 1/3 is not exact in float32: the mean multiplies by its rounding
    out["rolling_mean_w3"] = L.rolling("f", 3, "mean")
    return out


def run_patterns_against_reference(P, rows_per_worker, device="cpu"):
    mesh = jax.make_mesh((P,), ("data",))
    rctx = RefContext(mesh=mesh, axes=("data",))
    ctx = DDFContext(nworkers=P, device=device)
    left, right = _tables(P, rows_per_worker, seed=P)
    cap = rows_per_worker + 5
    small = {"a": np.arange(6, dtype=np.int32), "b": np.arange(6, dtype=np.float32) / 2,
             "c": np.arange(6) % 2 == 0}
    refs = [RefDDF.from_numpy(left, rctx, capacity=cap, mode="eager"),
            RefDDF.from_numpy(right, rctx, capacity=cap, mode="eager"),
            RefDDF.from_numpy(small, rctx, capacity=2, mode="eager")]

    def port(ref):
        return DDF.from_partitions({k: np.asarray(v) for k, v in ref.columns.items()},
                                   np.asarray(ref.counts), ctx,
                                   vocabs={k: v.words for k, v in ref.vocabs.items()})

    ports = [port(r) for r in refs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        exp = pipeline(*refs, ref_expr, rows_per_worker)
        got = pipeline(*ports, port_expr, rows_per_worker)
    for name in exp:
        _same(exp[name], got[name], f"P={P} {name}")
    return got


def test_patterns_match_reference_at_p1():
    got = run_patterns_against_reference(1, 60)
    assert got["sort"][0].num_rows() == 60 and got["union"][0].num_rows() > 0


def test_patterns_match_reference_at_p8():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, os.path.abspath(__file__)], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "PATTERNS MATCH REFERENCE AT P=8" in res.stdout


def test_kernel_launches_of_the_patterns_path():
    """On the CPU no kernel launches; the counts the card asserts are the
    calls of the kernels' dispatch points, counted here by wrapping them."""
    from repro_torch.core import local_ops as lo
    from repro_torch.core import partition as pt

    calls = {"hash_partition": 0, "segment_reduce": 0}
    hp, sr = pt.hash_partition_ids, lo._seg_reduce_dispatch

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    from repro_torch.core import operators as opmod

    ctx = DDFContext(nworkers=4, device="cpu")
    left, right = _tables(4, 30, seed=3)
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
    col = port_expr.col
    expected = {
        "union": (lambda: L.project(["k"]).union(R.project(["k"]), on=("k",)), 1, 0),
        "difference": (lambda: L.difference(R, on=("k",)), 2, 0),
        "join_string": (lambda: L.join(R.rename({"v": "v2", "f": "f2", "k": "k2"}),
                                       on=("s",), strategy="shuffle"), 2, 0),
        "groupby_exprs": (lambda: L.groupby(("k",), [col("v").max(), col("v").mean()],
                                            pre_combine=True), 1, 6),
        "sort": (lambda: L.sort_values("v"), 0, 0),
        "rolling": (lambda: L.rolling("v", 8, "max"), 0, 0),
        "agg": (lambda: L.agg("v", "sum"), 0, 0),
        "rebalance": (lambda: L.rebalance(), 0, 0),
        "head": (lambda: L.head(10), 0, 0),
        "transpose": (lambda: L.project(["k", "v"]).head(3).transpose(), 0, 0),
    }
    opmod.hash_partition_ids = count("hash_partition", hp)
    lo._seg_reduce_dispatch = count("segment_reduce", sr)
    try:
        for name, (fn, n_hash, n_seg) in expected.items():
            calls.update(hash_partition=0, segment_reduce=0)
            fn()
            assert calls == {"hash_partition": n_hash, "segment_reduce": n_seg}, (name, calls)
    finally:
        opmod.hash_partition_ids = hp
        lo._seg_reduce_dispatch = sr


# -- NaN bits: they pick the worker a row hashes to -----------------------------------

NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7FC00001, 0xFFC00007], np.uint32)


def _nan_table(P, rows_per_worker, seed):
    rng = np.random.default_rng(seed)
    n = P * rows_per_worker
    f = (rng.integers(-40, 40, n) / 4).astype(np.float32)
    nan = rng.random(n) < 0.15
    f.view(np.uint32)[nan] = rng.choice(NAN_BITS, nan.sum())
    return {"k": rng.integers(0, max(n // 6, 1), n).astype(np.int32), "f": f}


def run_nan_against_reference(P, rows_per_worker=24):
    """A groupby's float min/max over NaNs of both signs and with payloads,
    then ``unique`` on its max (the bits pick the workers), and ``unique``
    of a floordiv by zero: every worker's rows, by bits, and the overflow
    counters must be the reference's."""
    if P == jax.device_count():
        mesh = jax.make_mesh((P,), ("data",))
    else:
        mesh = jax.make_mesh((P,), ("data",), devices=jax.devices()[:P])
    rctx = RefContext(mesh=mesh, axes=("data",))
    ctx = DDFContext(nworkers=P, device="cpu")
    cap = rows_per_worker + 3
    ref = RefDDF.from_numpy(_nan_table(P, rows_per_worker, P), rctx, capacity=cap,
                            mode="eager")
    port = DDF.from_partitions({k: np.asarray(v) for k, v in ref.columns.items()},
                               np.asarray(ref.counts), ctx)
    results = {}
    for name, D, X in (("ref", ref, ref_expr), ("port", port, port_expr)):
        G = D.groupby(("k",), {"f": ("min", "max")}, pre_combine=True)
        results[name] = {"groupby": G, "unique_f_max": G[0].unique(("f_max",)),
                         "unique_floordiv": D.with_column("q", X.col("f") // 0.0)
                         .unique(("q",))}
    for what in results["ref"]:
        exp, got = results["ref"][what], results["port"][what]
        _same(exp, got, f"P={P} {what}")
        for w, (e, g) in enumerate(zip(_raw_parts(exp[0].columns, exp[0].counts, P),
                                       _raw_parts({k: v.cpu() for k, v in got[0].columns.items()},
                                                  got[0].counts.cpu(), P))):
            for k in e:
                if e[k].dtype.kind == "f":  # NaN bits too: _same compares by value
                    np.testing.assert_array_equal(g[k].view(np.uint32), e[k].view(np.uint32),
                                                  err_msg=f"P={P} {what} worker {w} {k}")
    return results["port"]


def test_nan_bits_match_reference_at_p1():
    got = run_nan_against_reference(1)
    assert bool(got["groupby"][0].columns["f_max"].isnan().any())


def test_nan_bits_match_reference_at_p4():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "nan"],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "NAN BITS MATCH REFERENCE AT P=4" in res.stdout


@pytest.mark.parametrize("op", ["min", "max"])
def test_global_minmax_with_a_nan(op):
    """Globally-Reduce min/max over a column holding NaNs: at P=1 the
    reference's NaN, by bits; at P > 1 the reference's cross-device min/max
    drops the NaN, so it disagrees with itself across P and with its own
    groupby. The port gives NaN at every P (a recorded difference)."""
    f = np.array([1.0, 3.0, -2.0, 0.5, 7.0, 2.5, -1.0, 4.0], np.float32)
    f.view(np.uint32)[[1, 5]] = [0x7FC00001, 0xFFC00007]
    data = {"f": f}
    rctx = RefContext(mesh=jax.make_mesh((1,), ("data",)), axes=("data",))
    exp = np.float32(RefDDF.from_numpy(data, rctx, mode="eager").agg("f", op))
    got = np.float32(DDF.from_numpy(data, DDFContext(nworkers=1, device="cpu")).agg("f", op))
    assert got.view(np.uint32) == exp.view(np.uint32), (hex(got.view(np.uint32)),
                                                         hex(exp.view(np.uint32)))
    assert np.isnan(DDF.from_numpy(data, DDFContext(nworkers=8, device="cpu")).agg("f", op))


@pytest.mark.parametrize("window", [0, -1])
def test_rolling_window_below_one_raises(window):
    """The reference returns meaningless columns for such a window; the port
    refuses it with a ValueError (a recorded difference)."""
    D = DDF.from_numpy({"v": np.arange(10, dtype=np.int32)}, DDFContext(nworkers=2, device="cpu"))
    with pytest.raises(ValueError, match="at least 1"):
        D.rolling("v", window, "mean")
    with pytest.raises(ValueError, match="at least 1"):
        D.rolling_sum("v", window)


# -- local operators against the reference, worker by worker --------------------------

def _data(P, cap, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(-6, 6, size=(P, cap)).astype(np.float32) / 2
    f[rng.random((P, cap)) < 0.1] = np.nan
    f[rng.random((P, cap)) < 0.1] = -0.0
    cols = {"k": rng.integers(-5, 5, size=(P, cap)).astype(np.int32),
            "v": rng.integers(-2**31, 2**31, size=(P, cap), dtype=np.int64).astype(np.int32),
            "f": f, "h": rng.integers(-100, 100, size=(P, cap)).astype(np.int16)}
    nvalid = rng.integers(0, cap + 1, size=P).astype(np.int32)
    nvalid[0] = cap
    return cols, nvalid


def _port(cols, nvalid):
    return Table({k: torch.from_numpy(v.copy()) for k, v in cols.items()},
                 torch.from_numpy(nvalid.copy()))


def _refs(cols, nvalid):
    return [ref_df.Table({k: jnp.asarray(v[w]) for k, v in cols.items()},
                         jnp.asarray(nvalid[w], jnp.int32)) for w in range(len(nvalid))]


def _same_live(port: Table, refs, what):
    for w, r in enumerate(refs):
        n = int(r.nvalid)
        assert int(port.nvalid[w]) == n, (what, w)
        assert set(port.columns) == set(r.columns), what
        for k, v in port.columns.items():
            np.testing.assert_array_equal(v[w].numpy()[:n], np.asarray(r.columns[k])[:n],
                                          err_msg=f"{what} worker {w} {k}")


@pytest.mark.parametrize("keys", [("k",), ("f",), ("k", "f"), ("h", "v")])
@pytest.mark.parametrize("descending", [False, True])
def test_local_sort_matches_reference(keys, descending):
    cols, nvalid = _data(3, 24, seed=len(keys) + descending)
    got = local_ops.local_sort(_port(cols, nvalid), keys, descending=descending)
    exp = [ref_local.local_sort(r, keys, descending=descending) for r in _refs(cols, nvalid)]
    _same_live(got, exp, f"local_sort {keys} {descending}")


@pytest.mark.parametrize("key,descending", [("k", False), ("k", True), ("h", True),
                                            ("f", False), ("f", True)])
def test_range_partition_ids_match_reference(key, descending):
    cols, nvalid = _data(3, 24, seed=7)
    cols["f"] = np.nan_to_num(cols["f"])
    piv = np.sort(cols[key].reshape(-1)[:3])
    if descending:
        piv = piv[::-1].copy()
    got = partition.range_partition_ids(_port(cols, nvalid), key, torch.from_numpy(piv), 4,
                                        descending=descending)
    for w, r in enumerate(_refs(cols, nvalid)):
        exp = ref_partition.range_partition_ids(r, key, jnp.asarray(piv), 4, descending)
        np.testing.assert_array_equal(got[w].numpy(), np.asarray(exp))


@pytest.mark.parametrize("keys", [("k",), ("k", "h")])
def test_local_anti_join_matches_reference(keys):
    lc, ln = _data(3, 24, seed=11)
    rc, rn = _data(3, 16, seed=12)
    got = local_ops.local_anti_join(_port(lc, ln), _port(rc, rn), keys)
    exp = [ref_local.local_anti_join(a, b, keys) for a, b in zip(_refs(lc, ln), _refs(rc, rn))]
    _same_live(got, exp, f"anti-join {keys}")


@pytest.mark.parametrize("name", ["k", "v", "h", "f"])
@pytest.mark.parametrize("op", ["sum", "mean", "min", "max", "count"])
def test_column_aggregate_local_matches_reference(name, op):
    cols, nvalid = _data(3, 24, seed=5)
    if op in ("sum", "mean") and name == "v":  # float32 sums of ints exact under 2**24
        cols["v"] = (cols["v"] % 1000).astype(np.int32)
    val, cnt = local_ops.column_aggregate_local(_port(cols, nvalid), name, op)
    for w, r in enumerate(_refs(cols, nvalid)):
        ev, ec = ref_local.column_aggregate_local(r, name, op)
        assert val[w].numpy().dtype == np.asarray(ev).dtype, (name, op)
        np.testing.assert_array_equal(val[w].numpy(), np.asarray(ev))
        np.testing.assert_array_equal(cnt[w].numpy(), np.asarray(ec))


@pytest.mark.parametrize("names", [("k", "v"), ("k", "h"), ("h", "f"), ("k", "v", "h")])
@pytest.mark.parametrize("op", ["sum", "min", "max", "mean"])
def test_row_aggregate_matches_reference(names, op):
    cols, nvalid = _data(2, 12, seed=9)
    cols["f"] = np.nan_to_num(cols["f"])
    got = local_ops.row_aggregate(_port(cols, nvalid), names, "out", op)
    for w, r in enumerate(_refs(cols, nvalid)):
        exp = np.asarray(ref_local.row_aggregate(r, names, "out", op).columns["out"])
        g = got.columns["out"][w].numpy()
        assert g.dtype == exp.dtype
        if op == "mean" and "v" in names:  # float32 sums of full-range ints: 2 ulp
            np.testing.assert_allclose(g, exp, rtol=2**-22)
        else:
            np.testing.assert_array_equal(g, exp)


@pytest.mark.parametrize("call", ["sort", "sort_desc", "rolling_min", "rolling_max",
                                  "agg_min", "agg_max"])
def test_bool_sentinel_ops_raise_like_reference(call):
    """The reference has no min/max sentinel for bool columns, so these ops
    fail there; the port refuses them with a TypeError."""
    data = {"b": np.arange(10) % 3 == 0, "v": np.arange(10, dtype=np.int32)}
    fns = {"sort": lambda D: D.sort_values("b"),
           "sort_desc": lambda D: D.sort_values("b", descending=True),
           "rolling_min": lambda D: D.rolling("b", 3, "min"),
           "rolling_max": lambda D: D.rolling("b", 3, "max"),
           "agg_min": lambda D: D.agg("b", "min"), "agg_max": lambda D: D.agg("b", "max")}
    rctx = RefContext(mesh=jax.make_mesh((1,), ("data",)), axes=("data",))
    with pytest.raises(ValueError):
        fns[call](RefDDF.from_numpy(data, rctx, mode="eager"))
    with pytest.raises(TypeError, match="bool"):
        fns[call](DDF.from_numpy(data, DDFContext(nworkers=2, device="cpu")))


def test_gather_rows_and_map_rows_match_reference():
    from repro_torch.core import dataframe

    cols, nvalid = _data(3, 12, seed=4)
    idx = np.random.default_rng(4).integers(0, 12, size=(3, 5)).astype(np.int32)
    got = dataframe.gather_rows(_port(cols, nvalid), torch.from_numpy(idx), 4)
    mapped = dataframe.map_rows(_port(cols, nvalid), lambda c: {"s": c["k"] * 2 + c["h"]})
    for w, r in enumerate(_refs(cols, nvalid)):
        exp = ref_df.gather_rows(r, jnp.asarray(idx[w]), 4)
        assert int(got.nvalid[w]) == int(exp.nvalid)
        for k in cols:
            np.testing.assert_array_equal(got.columns[k][w].numpy(), np.asarray(exp.columns[k]))
        exp_m = ref_df.map_rows(r, lambda c: {"s": c["k"] * 2 + c["h"]})
        np.testing.assert_array_equal(mapped.columns["s"][w].numpy(),
                                      np.asarray(exp_m.columns["s"]))


def test_chip_smoke_patterns_path_runs_on_the_cpu():
    """The smoke run's patterns phase and its numpy oracles, rehearsed on
    the CPU at a small size (no kernel launches there)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    left, right = chip_smoke.paper_tables(8, 3000)
    res = chip_smoke.run_patterns_path(8, 3000, left, right, device="cpu",
                                       coltype_rows_per_worker=3000)
    assert res["selected_rows"] == int((left["c1"] < 2**30).sum())
    assert all(not v for v in res["launches"].values())
    assert res["coltypes"]["join_rows"] > 0 and "coltype_join" in res["times_ms"]


# -- collectives and channels -------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 2, 3, 5, 8])
def test_bruck_all_to_all_equals_the_native_transpose(P):
    cols, nvalid = _data(P, 40, seed=P)
    t = _port(cols, nvalid)
    dest = torch.where(torch.arange(40)[None, :] < t.nvalid[:, None],
                       torch.from_numpy(np.random.default_rng(P).integers(0, P, (P, 40))
                                        .astype(np.int32)), P)
    native, ov_n = collectives.shuffle_table(t, dest, 30)
    bruck, ov_b = collectives.shuffle_table(t, dest, 30, algorithm="bruck")
    assert torch.equal(native.nvalid, bruck.nvalid) and torch.equal(ov_n, ov_b)
    for k in native.columns:
        assert torch.equal(native.columns[k].view(torch.int32 if k == "f" else native.columns[k].dtype),
                           bruck.columns[k].view(torch.int32 if k == "f" else bruck.columns[k].dtype)), k


def test_communicator_refuses_bruck_with_chunks():
    from repro_torch.core.comm.communicator import make_communicator

    cols, nvalid = _data(2, 8, seed=1)
    t = _port(cols, nvalid)
    dest = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="monolithic"):
        make_communicator(2).shuffle(t, dest, 8, algorithm="bruck", num_chunks=2)


def test_array_collectives_and_channels():
    x = torch.tensor([[1, -2, 2**31 - 1], [4, 5, 1], [7, 8, 9]], dtype=torch.int32)
    s = collectives.allreduce_array(x, "sum")
    assert s.dtype == torch.int32 and s.shape == (3, 3)
    assert s[0].tolist() == [12, 11, -2**31 + 9] and torch.equal(s[0], s[2])  # wraps
    assert collectives.allreduce_array(x, "min")[1].tolist() == [1, -2, 1]
    assert collectives.allreduce_array(x, "max")[2].tolist() == [7, 8, 2**31 - 1]
    xs = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    assert collectives.reduce_scatter_array(xs).tolist() == [[6, 8, 10], [12, 14, 16]]
    assert collectives.allgather_array(x).shape == (3, 3, 3)
    assert collectives.allgather_array(x, tiled=True)[1].tolist() == x.reshape(-1).tolist()
    assert channels.shift(x, 1)[0].tolist() == x[2].tolist()
    assert channels.send_recv(x, [(0, 2)]).tolist() == [[0, 0, 0], [0, 0, 0], x[0].tolist()]
    left, right = channels.halo_exchange(x, -x)
    assert left.tolist() == [[0, 0, 0], x[0].tolist(), x[1].tolist()]
    assert right.tolist() == [(-x[1]).tolist(), (-x[2]).tolist(), [0, 0, 0]]
    collectives.barrier()


def test_table_gather_broadcast_scatter():
    cols = {"a": torch.tensor([[1, 2, 0], [3, 0, 0], [4, 5, 6]], dtype=torch.int32),
            "f": torch.tensor([[-0.0, 1.0, 0.0], [2.0, 0.0, 0.0], [3.0, 4.0, 5.0]])}
    t = Table(cols, torch.tensor([2, 1, 3], dtype=torch.int32))
    g = collectives.gather_table(t, root=1)
    assert g.nvalid.tolist() == [0, 6, 0] and g.columns["a"][1, :6].tolist() == [1, 2, 3, 4, 5, 6]
    b = collectives.broadcast_table(t, root=0)
    assert b.nvalid.tolist() == [2, 2, 2] and b.columns["a"][2, :2].tolist() == [1, 2]
    assert not torch.signbit(b.columns["f"][1, 0])  # -0.0 + the zeros of the others
    sc, ov = collectives.scatter_table(t, root=2)
    assert sc.nvalid.tolist() == [1, 1, 1] and int(ov.sum()) == 0
    assert sorted(sc.columns["a"][w, 0].item() for w in range(3)) == [4, 5, 6]


# -- numpy oracle sweep ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(15))
def test_pipelines_match_oracle(seed):
    P = (1, 3, 8)[seed % 3]
    rng = np.random.default_rng(100 + seed)
    nl, nr = (int(x) for x in rng.integers(1, 90, 2))
    keys = int(rng.integers(1, 25))

    def table(n):
        return {"k": rng.integers(0, keys, n).astype(np.int32),
                "v": rng.integers(-50, 50, n).astype(np.int32),
                "s": WORDS[rng.integers(0, 5 + seed % 4, n)]}

    left, right = table(nl), table(nr)
    ctx = DDFContext(nworkers=P, device="cpu")
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
    col = port_expr.col
    t = int(rng.integers(-50, 50))
    sel = L.select(col("v") > t).with_column("w", col("v") * 2 + col("k"))
    exp_sel = oracle.o_select(left, left["v"] > t)
    exp_sel["w"] = exp_sel["v"] * 2 + exp_sel["k"]
    assert oracle.canonical(sel.to_numpy()) == oracle.canonical(exp_sel)
    big = max(L.capacity, R.capacity)
    key = ("k",) if seed % 2 else ("s",)
    U, ui = L.project(list(key)).union(R.project(list(key)), on=key, quota=2 * big)
    assert oracle.canonical(U.to_numpy()) == oracle.canonical(oracle.o_union(
        oracle.o_project(left, key), oracle.o_project(right, key), key))
    # a set op: the left side is deduplicated by key, so compare key sets
    D, di = L.project(list(key)).difference(R.project(list(key)), on=key, quota=big)
    assert oracle.canonical(D.to_numpy()) == oracle.canonical(oracle.o_unique(
        oracle.o_difference(oracle.o_project(left, key), oracle.o_project(right, key), key),
        key))
    by = "v" if seed % 2 else "s"
    S, si = L.sort_values(by, descending=bool(seed % 3 == 1), quota=L.capacity)
    s = S.to_numpy()
    assert oracle.is_sorted_by(s, by, descending=bool(seed % 3 == 1))
    assert oracle.canonical(s) == oracle.canonical(left)
    G, gi = L.groupby(("s",), [col("v").sum(), col("v").min(), col("k").count()],
                      quota=L.capacity)
    assert oracle.canonical(G.to_numpy()) == oracle.canonical(
        oracle.o_groupby(left, ("s",), {"v": ("sum", "min"), "k": ("count",)}))
    B, bi = sel.rebalance()
    c = B.counts.numpy()
    n = int(c.sum())
    assert sorted(c.tolist()) == sorted([n // P + (w < n % P) for w in range(P)])
    np.testing.assert_array_equal(B.to_numpy()["v"], sel.to_numpy()["v"])
    assert L.length() == nl and L.head(7).num_rows() == min(7, nl)
    for info in (ui, di, si, gi, bi):
        assert all(int(v.sum()) == 0 for k, v in info.items() if k != "pivots")


if __name__ == "__main__":
    assert len(jax.devices()) == 8, jax.devices()
    if sys.argv[1:] == ["nan"]:
        run_nan_against_reference(4)
        print("NAN BITS MATCH REFERENCE AT P=4")
    else:
        run_patterns_against_reference(8, 40)
        print("PATTERNS MATCH REFERENCE AT P=8")
