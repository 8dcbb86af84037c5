"""The port's lazy plans (``repro_torch.plan``) against the reference's
(``repro.plan``).

- The same seeded numpy tables (240 rows a side) go through both packages'
  ``LazyDDF``. Every optimizer pass, applied in turn, must print the same
  ``format_plan`` text, apart from the source ids (process-wide counters)
  and ``num_chunks``, which the port plans as 1 on one card.
- Collected, each pipeline's result must be the reference's: every
  worker's live rows bit for bit (means within the 1 float32 ulp the other
  port tests allow) and the same overflow counters, at P=1 in this
  process and at P=8 in a ``__main__`` subprocess (as
  ``tests/test_torch_ddf.py`` does). Where the steps have an eager form,
  the port's lazy result must also equal its own eager one by bits.
- Caches, the single row-count copy, the default mode, build-time
  validation (the same exception types as the reference) and the parts
  that wait for later modules.
"""

import os
import sys

if __name__ == "__main__":  # the P=8 reference needs its devices before jax loads
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import re
import subprocess
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.plan as ref_plan  # noqa: E402
import repro_torch.plan as port_plan  # noqa: E402
from repro import expr as ref_expr  # noqa: E402
from repro.core import DDF as RefDDF  # noqa: E402
from repro.core import DDFContext as RefContext  # noqa: E402
from repro.core import api as ref_api  # noqa: E402
from repro.core import cost_model as ref_cost  # noqa: E402
from repro.core.comm.communicator import ICI  # noqa: E402
from repro_torch import expr as port_expr  # noqa: E402
from repro_torch.core import DDF, DDFContext  # noqa: E402
from repro_torch.core import api, cost_model  # noqa: E402
from repro_torch.core.comm.communicator import FabricProfile  # noqa: E402
from repro_torch.plan import LazyDDF, executor, logical, optimizer  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
N = 240
WORDS = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen"])


def _tables(seed=7):
    rng = np.random.default_rng(seed)
    L = {"k": rng.integers(0, 120, N).astype(np.int32),
         "v": rng.integers(0, 1000, N).astype(np.int32),
         "junk": rng.integers(0, 5, N).astype(np.int32),
         "f": (rng.integers(-400, 400, N) / 4).astype(np.float32),
         "s": WORDS[rng.integers(0, 6, N)]}
    R = {"k": rng.integers(0, 120, N).astype(np.int32),
         "w": rng.integers(0, 1000, N).astype(np.int32),
         "junk2": rng.integers(0, 5, N).astype(np.int32),
         "s": WORDS[rng.integers(2, 8, N)]}
    small = {"k": np.arange(8, dtype=np.int32), "w": np.arange(8, dtype=np.int32) * 7}
    return L, R, small


# Each pipeline takes (left, right, small) LazyDDFs and the expression
# module of the package under test; callables use only operations that
# jax and torch arrays share.
PIPELINES = {
    "pushdown_left": lambda l, r, s, X: l.join(r, on=("k",), strategy="shuffle")
    .select(X.col("v") > 500),
    "pushdown_right_callable": lambda l, r, s, X: l.join(r, on=("k",), strategy="shuffle")
    .select(lambda c: c["w"] > 500, name="wbig"),
    "suffix_blocks_pushdown": lambda l, r, s, X: l.join(
        r.rename({"w": "v"}), on=("k",), strategy="shuffle").select(X.col("v_r") > 400),
    "conjunction_split": lambda l, r, s, X: l.join(r, on=("k",), strategy="shuffle")
    .select((X.col("v") > 100) & (X.col("w") < 900)),
    "below_sort": lambda l, r, s, X: l.sort_values("v").select((X.col("v") % 2).eq(0)),
    "sort_desc_project": lambda l, r, s, X: l.sort_values("v", descending=True)
    .project(["k", "v"]),
    "rebalance_project": lambda l, r, s, X: l.rebalance().project(["k"]),
    "difference": lambda l, r, s, X: l.difference(r, on=("k",)),
    "union": lambda l, r, s, X: l.project(["k", "v"]).union(
        r.rename({"w": "v"}).project(["k", "v"]), on=("k",)),
    "elided_groupby": lambda l, r, s, X: l.join(r, on=("k",), strategy="shuffle",
                                                capacity=4000)
    .groupby(("k",), {"v": ("sum", "count")}),
    "unique_after_join": lambda l, r, s, X: l.join(r, on=("k",), strategy="shuffle",
                                                   capacity=4000).unique(("k",)),
    "groupby_other_key": lambda l, r, s, X: l.join(r, on=("k",), strategy="shuffle",
                                                   capacity=4000)
    .groupby(("v",), {"w": ("sum",)}, pre_combine=False),
    "ep_chain": lambda l, r, s, X: l.select(lambda c: c["v"] % 2 == 0, name="even")
    .map_columns(lambda c: {"k": c["k"], "v": c["v"], "v2": c["v"] * 2}, name="double")
    .project(["k", "v2"]),
    "four_op": lambda l, r, s, X: l.select(lambda c: c["v"] % 2 == 0, name="even")
    .project(["k", "v"]).join(r, on=("k",), strategy="shuffle", capacity=4000)
    .groupby(("k",), {"v": ("sum", "count")}),
    "readme": lambda l, r, s, X: l.select(X.col("v") < 700)
    .with_column("c2", X.when(X.col("v") < 300).then(1).otherwise(0))
    .project(["k", "v", "c2", "f"])
    .join(r, on=("k",), strategy="shuffle", capacity=4000)
    .groupby(("k",), [X.col("v").sum(), X.col("v").min(), X.col("v").max(),
                      X.col("v").count(), X.col("v").mean().alias("avg"),
                      X.col("c2").sum(), X.col("f").max(), X.col("f").sum()]),
    "string_join_recode": lambda l, r, s, X: l.project(["s", "v"])
    .join(r.project(["s", "w"]), on=("s",), strategy="shuffle", capacity=8000)
    .groupby(("s",), {"v": ("max",), "w": ("min",)}),
    "broadcast_small": lambda l, r, s, X: l.join(s, on=("k",), strategy="broadcast",
                                                 capacity=480),
    "auto_join_groupby": lambda l, r, s, X: l.join(r, on=("k",), capacity=4000)
    .groupby(("k",), {"v": ("min", "max")}),
}
# the same steps on the eager DDF: (port lazy == port eager) by bits
EAGER = {
    "elided_groupby": lambda l, r, s, X: l.join(r, on=("k",), strategy="shuffle",
                                                capacity=4000)[0]
    .groupby(("k",), {"v": ("sum", "count")})[0],
    "four_op": lambda l, r, s, X: l.select(lambda c: c["v"] % 2 == 0, name="even")
    .project(["k", "v"]).join(r, on=("k",), strategy="shuffle", capacity=4000)[0]
    .groupby(("k",), {"v": ("sum", "count")})[0],
    "readme": lambda l, r, s, X: l.select(X.col("v") < 700)
    .with_column("c2", X.when(X.col("v") < 300).then(1).otherwise(0))
    .project(["k", "v", "c2", "f"])
    .join(r, on=("k",), strategy="shuffle", capacity=4000)[0]
    .groupby(("k",), [X.col("v").sum(), X.col("v").min(), X.col("v").max(),
                      X.col("v").count(), X.col("v").mean().alias("avg"),
                      X.col("c2").sum(), X.col("f").max(), X.col("f").sum()])[0],
}


def _ddfs(P):
    L, R, small = _tables()
    rctx = RefContext(mesh=jax.make_mesh((P,), ("data",)), axes=("data",))
    pctx = DDFContext(nworkers=P, device="cpu")
    cap = 2 * N // P
    ref = [RefDDF.from_numpy(t, rctx, capacity=c, mode="eager")
           for t, c in ((L, cap), (R, cap), (small, 8))]
    port = [DDF.from_numpy(t, pctx, capacity=c, mode="eager")
            for t, c in ((L, cap), (R, cap), (small, 8))]
    return ref, port


def _build(name, ddfs, X):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return PIPELINES[name](*(d.lazy() for d in ddfs), X)


def _normalized(text: str) -> str:
    """Source ids renumbered by first appearance; pipeline depths hidden."""
    seen: dict = {}
    text = re.sub(r"#(\d+)", lambda m: f"#{seen.setdefault(m.group(1), len(seen))}", text)
    return re.sub(r"num_chunks=\d+", "num_chunks=K", text)


@pytest.fixture(scope="module")
def p1():
    return _ddfs(1)


def _passes(mod, root, rows, params):
    o = mod.optimizer
    stages = [o.normalize_predicates(root)]
    stages.append(o.pushdown_predicates(stages[-1]))
    stages.append(o.pushdown_projections(stages[-1]))
    stages.append(o.pushdown_scans(stages[-1]))
    stages.append(o.plan_shuffles(stages[-1], 1, rows, params))
    stages.append(o.elide_shuffles(stages[-1]))
    stages.append(o.fuse_elementwise(stages[-1]))
    return stages


# the port's cost model with the reference's ICI (alpha, beta): the same
# inputs to every strategy choice
ICI_PARAMS = cost_model.CostParams(FabricProfile("ici", ICI.alpha_s, ICI.beta_s_per_byte))


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_optimizer_passes_print_the_reference_plan(p1, name):
    ref, port = p1
    rl, pl = _build(name, ref, ref_expr), _build(name, port, port_expr)
    rows_r, rows_p = rl._rows(), pl._rows()
    assert sorted(rows_r.values()) == sorted(rows_p.values())
    assert _normalized(logical.format_plan(pl.plan, rows_p)) == \
        _normalized(ref_plan.format_plan(rl.plan, rows_r))
    got = _passes(port_plan, pl.plan, rows_p, ICI_PARAMS)
    exp = _passes(ref_plan, rl.plan, rows_r, ref_cost.params_for_fabric("ici"))
    for i, (g, e) in enumerate(zip(got, exp)):
        assert _normalized(logical.format_plan(g, rows_p)) == \
            _normalized(ref_plan.format_plan(e, rows_r)), (name, i)
        assert logical.count_shuffles(g) == ref_plan.logical.count_shuffles(e)
        assert logical.partitioning_of(g) == ref_plan.logical.partitioning_of(e)
    assert _normalized(pl.explain()) == _normalized(rl.explain()) or \
        name == "auto_join_groupby"  # the card's cost model may choose otherwise


def test_auto_strategy_under_the_card_profile(p1):
    """Under the card's own DEVICE profile the plan may differ from the
    reference's ICI plan only in the join strategy (a recorded difference);
    every count and size is derived the same way."""
    ref, port = p1
    rl = _build("auto_join_groupby", ref, ref_expr)
    pl = _build("auto_join_groupby", port, port_expr)
    got = executor.optimized_plan(pl.plan, pl._ctx, pl._rows())
    exp = ref_plan.executor.optimized_plan(rl.plan, rl._ctx, rl._rows())
    norm = lambda t: re.sub(r"strategy=\w+", "strategy=S", _normalized(t))  # noqa: E731
    assert norm(logical.format_plan(got)) == norm(ref_plan.format_plan(exp))


def test_scan_pushdown_prints_the_reference_plan():
    """Scan leaves and their pass need nothing of streaming: projections and
    host-portable predicates sink into the scan as in the reference."""
    schema = (("a", "int32", ()), ("b", "float32", ()), ("c", "int32", ()))

    def build(mod, X):
        lg = mod.logical
        scan = lg.Scan(0, schema, 64)
        e1 = X.col("a") > 3
        e2 = (X.col("b") + 1.5) > 2  # float arithmetic: stays a device SELECT
        sel = lg.Select(scan, None, "p", ("a",), expr=e1)
        sel = lg.Select(sel, None, "q", ("b",), expr=e2)
        return lg.Project(sel, ("a", "b"))

    got = optimizer.pushdown_scans(build(port_plan, port_expr))
    exp = ref_plan.optimizer.pushdown_scans(build(ref_plan, ref_expr))
    assert logical.format_plan(got) == ref_plan.format_plan(exp)
    assert "SCAN#0 cols=('a', 'b')" in logical.format_plan(got)


def _worker_rows(ddf, P):
    counts = np.asarray(ddf.counts.cpu() if isinstance(ddf.counts, torch.Tensor)
                        else ddf.counts)
    cols = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).reshape(P, -1)
            for k, v in ddf.columns.items()}
    return [{k: v[w, : counts[w]] for k, v in cols.items()} for w in range(P)]


def _same_rows(exp, got, P, what):
    for w, (e, g) in enumerate(zip(_worker_rows(exp, P), _worker_rows(got, P))):
        assert set(e) == set(g), (what, w, sorted(e), sorted(g))
        for k in e:
            assert e[k].dtype == g[k].dtype, (what, w, k)
            if k.endswith(("_mean", "avg")):
                np.testing.assert_array_max_ulp(g[k], e[k], maxulp=1)
            elif e[k].dtype.kind == "f":
                np.testing.assert_array_equal(g[k].view(np.int32), e[k].view(np.int32),
                                              err_msg=f"{what} worker {w} {k}")
            else:
                np.testing.assert_array_equal(g[k], e[k], err_msg=f"{what} worker {w} {k}")


def run_pipelines_against_reference(P, names=None):
    ref, port = _ddfs(P)
    for name in names or sorted(PIPELINES):
        rl, pl = _build(name, ref, ref_expr), _build(name, port, port_expr)
        re_, pe = rl.collect(), pl.collect()
        _same_rows(re_, pe, P, f"P={P} {name}")
        assert {k: v.words for k, v in re_.vocabs.items()} == \
            {k: v.words for k, v in pe.vocabs.items()}, name
        assert set(rl.last_info) == set(pl.last_info), name
        for k, v in rl.last_info.items():
            np.testing.assert_array_equal(pl.last_info[k].numpy(),
                                          np.asarray(v).reshape(-1), err_msg=f"{name} {k}")
            assert int(pl.last_info[k].sum()) == 0, (name, k)
        for k, v in rl.to_numpy().items():
            g = pl.to_numpy()[k]
            assert np.array_equal(g.view(np.int32) if g.dtype.kind == "f" else g,
                                  v.view(np.int32) if v.dtype.kind == "f" else v), (name, k)
        if name in EAGER:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                eager = EAGER[name](*port, port_expr)
            for k, v in eager.to_numpy().items():
                g = pe.to_numpy()[k]
                assert np.array_equal(g.view(np.int32) if g.dtype.kind == "f" else g,
                                      v.view(np.int32) if v.dtype.kind == "f" else v), \
                    (name, "lazy vs eager", k)


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_lazy_matches_reference_at_p1(name):
    run_pipelines_against_reference(1, [name])


def test_lazy_matches_reference_at_p8():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, os.path.abspath(__file__)], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "LAZY PLANS MATCH REFERENCE AT P=8" in res.stdout


# -- caches, syncs, modes ----------------------------------------------------------------

def test_plan_callable_frees_its_inputs_without_the_cyclic_collector():
    """A run of the composed plan callable leaves no reference cycle behind:
    with the cyclic collector off, a table it was given is freed as soon as
    the caller drops it (a streamed batch's table, which on the card would
    otherwise stay allocated until the collector ran)."""
    import gc
    import weakref

    ctx = DDFContext(nworkers=2, device="cpu")
    L = DDF.from_numpy({"k": np.arange(40, dtype=np.int32) % 5,
                        "v": np.arange(40, dtype=np.int32)}, ctx)
    lz = L.lazy().select(port_expr.col("v") > 3).groupby(("k",), {"v": ("sum",)})
    plan = executor.optimized_plan(lz.plan, ctx, lz._rows())
    fn = executor._make_plan_fn(plan, tuple(sorted(lz._sources)))
    gc.collect()
    gc.disable()
    try:
        t = L.table()
        ref = weakref.ref(t)
        out, aux = fn(ctx.comm(), t)
        del t
        assert ref() is None
    finally:
        gc.enable()
    assert int(out.nvalid.sum()) == 5 and aux


def test_repeated_collect_hits_plan_and_op_caches(p1, monkeypatch):
    _, port = p1

    def build():
        return _build("elided_groupby", port, port_expr)

    build().collect()
    before = executor.cache_stats()
    n_ops = len(api._OP_CACHE)
    made = []
    make = executor._make_plan_fn
    monkeypatch.setattr(executor, "_make_plan_fn", lambda *a: made.append(a) or make(*a))
    build().collect()  # rebuilt pipeline over the same DDFs: both caches hit
    after = executor.cache_stats()
    assert len(api._OP_CACHE) == n_ops
    assert made == []  # a hit reuses the composed callable without building one
    for cache in ("plan", "op"):
        assert after[cache]["hits"] == before[cache]["hits"] + 1, cache
        assert after[cache]["misses"] == before[cache]["misses"], cache


def test_rewrites_change_no_result(p1):
    """``level="plan-only"`` skips every rewrite pass but the planning one;
    the rows are the same, and ``collect_with_info`` returns the counters."""
    _, port = p1
    for name in ("pushdown_left", "elided_groupby", "readme"):
        lz = _build(name, port, port_expr)
        a, info = lz.collect_with_info()
        b = lz.collect(level="plan-only")
        assert info and all(int(v.sum()) == 0 for v in info.values()), name
        for k, v in a.to_numpy().items():
            g = b.to_numpy()[k]
            assert np.array_equal(g.view(np.int32) if g.dtype.kind == "f" else g,
                                  v.view(np.int32) if v.dtype.kind == "f" else v), (name, k)


def test_source_row_counts_take_one_copy(monkeypatch):
    ctx = DDFContext(nworkers=4, device="cpu")
    port = [DDF.from_numpy(t, ctx) for t in _tables()]
    copies = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        copies.append(tuple(self.shape))
        return cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    sources = {i: d for i, d in enumerate(port)}
    rows = executor.source_row_counts(sources)
    assert rows == {0: N, 1: N, 2: 8} and copies == [(12,)]
    assert executor.source_row_counts(sources) == rows and len(copies) == 1
    assert all(d._nrows is not None for d in port)


def test_lru_cache_bound_and_recency():
    c = api._LRUCache(maxsize=2)
    c.put("a", 1), c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)  # evicts "b" (least recently used)
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert len(c) == 2 and c.stats()["evictions"] == 1


def test_callable_signatures_keep_lambdas_apart(p1):
    """Same-line lambdas that differ in a literal, and closures over
    hash-equal values (hash(-1) == hash(-2)), get distinct signatures, and
    their lazy selects do not alias in the caches."""
    _, port = p1
    L = _tables()[0]
    preds = [lambda c: c["v"] > 0, lambda c: c["v"] > 500]
    assert api.callable_signature(preds[0]) != api.callable_signature(preds[1])
    assert api.callable_signature(preds[0]) == ref_api.callable_signature(preds[0])

    def make(t):
        return lambda c: c["v"] > t

    assert api.callable_signature(make(-1)) != api.callable_signature(make(-2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for t in (-1, -2, 499, 500):
            got = port[0].lazy().select(make(t)).collect().num_rows()
            assert got == int((L["v"] > t).sum()), t
        lo = port[0].lazy().select(lambda c: c["v"] < 500).to_numpy()
        hi = port[0].lazy().select(lambda c: c["v"] >= 500).to_numpy()
    assert sorted(lo["v"]) == sorted(L["v"][L["v"] < 500])
    assert sorted(hi["v"]) == sorted(L["v"][L["v"] >= 500])


def test_default_mode_and_from_numpy_mode():
    ctx = DDFContext(nworkers=2, device="cpu")
    data = {"k": np.arange(16, dtype=np.int32)}
    assert port_plan.get_default_mode() == "eager"
    try:
        port_plan.set_default_mode("lazy")
        assert isinstance(DDF.from_numpy(data, ctx), LazyDDF)
        d = DDF.from_numpy(data, ctx, mode="eager")  # a pinned mode ignores the default
        assert isinstance(d, DDF) and isinstance(d.unique(("k",))[0], DDF)
        with pytest.raises(ValueError):
            port_plan.set_default_mode("nope")
    finally:
        port_plan.set_default_mode("eager")
    assert isinstance(DDF.from_numpy(data, ctx), DDF)
    lz = DDF.from_numpy(data, ctx, mode="lazy")
    assert isinstance(lz, LazyDDF) and lz.column_names == ("k",)
    d = DDF.from_numpy(data, ctx)
    assert d.lazy() is d.lazy() and d.eager() is d and d.column_names == ("k",)
    assert isinstance(lz.eager(), DDF) and lz.collect().ctx.device.type == "cpu"


# the reference's build-time checks: each must raise there and here, with
# the same exception type
BAD_BUILDS = {
    "project": lambda l, r, X: l.project(["nope"]),
    "drop": lambda l, r, X: l.drop(["nope"]),
    "rename_unknown": lambda l, r, X: l.rename({"nope": "x"}),
    "rename_duplicate": lambda l, r, X: l.rename({"v": "junk"}),
    "groupby_by": lambda l, r, X: l.groupby(("nope",), {"v": ("sum",)}),
    "groupby_aggs": lambda l, r, X: l.groupby(("k",), {"nope": ("sum",)}),
    "groupby_string_sum": lambda l, r, X: l.groupby(("k",), {"s": ("sum",)}),
    "sort": lambda l, r, X: l.sort_values("nope"),
    "join": lambda l, r, X: l.join(r, on=("nope",)),
    "join_right": lambda l, r, X: l.join(r.project(["w"]), on=("k",)),
    "union_schema": lambda l, r, X: l.union(r, on=("k",)),
    "difference": lambda l, r, X: l.difference(r, on=("nope",)),
    "unique": lambda l, r, X: l.unique(("nope",)),
    "select_expr": lambda l, r, X: l.select(X.col("typo") > 0),
    "select_callable": lambda l, r, X: l.select(lambda c: c["typo"] > 0),
    "map_unknown": lambda l, r, X: l.map_columns(lambda c: {"x": c["typo"]}),
    "map_not_mapping": lambda l, r, X: l.map_columns(lambda c: c["v"]),
    "with_column": lambda l, r, X: l.with_column("x", X.col("typo") + 1),
    "mixed_string": lambda l, r, X: l.join(r.with_column("s", X.col("k")), on=("k",)),
}


@pytest.mark.parametrize("name", sorted(BAD_BUILDS))
def test_build_time_validation_matches_reference(p1, name):
    ref, port = p1

    def raised(ddfs, X):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                BAD_BUILDS[name](ddfs[0].lazy(), ddfs[1].lazy(), X)
            except Exception as e:  # noqa: BLE001 -- the type is what is compared
                return e
        return None

    exp, got = raised(ref, ref_expr), raised(port, port_expr)
    assert exp is not None, name
    assert type(got) is type(exp), (name, exp, got)
    if isinstance(exp, KeyError) and "available schema" in str(exp):
        assert "available schema" in str(got)


def test_parts_that_wait_for_later_modules_raise(p1):
    """The terminals that waited for later modules (profiling, statistics,
    streaming) now run: on an in-memory plan they give collect()'s rows, as
    in the reference, and ``explain`` alone still executes nothing."""
    ref, port = p1
    lz = port[0].lazy().project(["k"]).unique(("k",))
    assert lz.last_info is None  # explain executes nothing
    assert "PROJECT" in lz.explain(optimized=False) and lz.last_info is None
    want = lz.collect().to_numpy()
    prof = lz.collect(profile=True).to_numpy()
    assert set(lz.last_profile.report()["model"]) == {"combine_shuffle_reduce"}
    text = lz.explain(analyze=True)
    assert "-- profile (predicted vs observed) --" in text
    streamed = lz.collect_stream().to_numpy()
    batches = list(lz.to_batches())
    assert len(batches) == 1
    for got in (prof, streamed, batches[0]):
        np.testing.assert_array_equal(got["k"], want["k"])
    ref_lz = ref[0].lazy().project(["k"]).unique(("k",))
    ref_lz.collect(profile=True)
    assert set(ref_lz.last_profile.report()["model"]) == set(lz.last_profile.report()["model"])
    np.testing.assert_array_equal(np.sort(ref_lz.collect_stream().to_numpy()["k"]),
                                  np.sort(want["k"]))


def test_execute_span_and_metrics(p1):
    from repro_torch import obs

    _, port = p1
    mark = obs.trace.mark()
    with obs.tracing():
        out = _build("elided_groupby", port, port_expr).collect()
    spans = [s for s in obs.get_trace(since=mark).spans if s.name == "plan.execute"]
    assert len(spans) == 1 and spans[0].attrs["out_rows"] == out.num_rows()
    assert spans[0].attrs["wall_s"] > 0 and not obs.trace.enabled()
    snap = obs.engine_snapshot()
    assert snap["kernel_backend"] == "auto" and snap["caches"]["op"]["size"] >= 1


def test_chunk_count_is_monolithic_on_one_card():
    assert cost_model.choose_chunk_count(8, 1e9) == 1
    assert cost_model.choose_chunk_count(8, 1e9, ICI_PARAMS) == 1
    # where the reference pipelines the same shuffle
    assert ref_cost.choose_chunk_count(8, 1e9, ref_cost.params_for_fabric("ici"),
                                       core_s=1e-2) > 1


# -- the smoke run's lazy phase, rehearsed on the CPU ---------------------------------------

def test_chip_smoke_lazy_path_runs_on_the_cpu():
    """The smoke run's lazy phase at a small size (no kernel launches on
    the CPU); the launches its plan implies are the dispatch points' calls,
    counted here by wrapping them."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.core import local_ops as lo
    from repro_torch.core import operators as opmod

    left, right = chip_smoke.paper_tables(8, 2000)
    res = chip_smoke.run_lazy_path(8, left, right, device="cpu")
    assert res["plan"][-1] == "shuffles: 1" and res["groups"] > 0
    assert not any(res["launches"].values())

    calls = {"hash_partition": 0, "segment_reduce": 0}
    hp, sr = opmod.hash_partition_ids, lo._seg_reduce_dispatch

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    ctx = DDFContext(nworkers=8, device="cpu")
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
    lz = chip_smoke._lazy_steps(L, R)
    plan = executor.optimized_plan(lz.plan, ctx, lz._rows())
    opmod.hash_partition_ids = count("hash_partition", hp)
    lo._seg_reduce_dispatch = count("segment_reduce", sr)
    try:
        lz.collect()
    finally:
        opmod.hash_partition_ids = hp
        lo._seg_reduce_dispatch = sr
    assert calls == chip_smoke._launches_of_plan(plan) == \
        {"hash_partition": 2, "segment_reduce": 5}


if __name__ == "__main__":
    assert len(jax.devices()) == 8, jax.devices()
    run_pipelines_against_reference(8)
    print("LAZY PLANS MATCH REFERENCE AT P=8")
