"""The port's DDF slice (join -> groupby -> unique) against the reference.

- At P=1 both packages run in this process; at P=8 the reference needs 8
  host devices, so this file re-runs itself under ``__main__`` in a
  subprocess with ``XLA_FLAGS`` set before jax is imported (as
  ``scripts/smoke_ddf.py`` does). Both sides start from the same partition
  layout through ``DDF.from_partitions``, and every worker's live rows must
  be equal: exactly, with float means compared at float32 ulp (1 ulp
  allowed; both sides divide with one correctly rounded float32 division).
- uint32 and vector columns (``test_torch_dist_cases.coltype_results``:
  join, groupby with wrapping uint32 sums, sorts both ways, unique, union,
  difference, rebalance, a lazy groupby and a lazy join) equal the
  reference by bits at P=1 here and at P=8 in the same subprocess; the
  reference's refusals (an int literal past int32, an aggregate of a
  vector column) are matched by exception class. ``from_arrays`` and
  ``empty`` build what the reference's build.
- A seeded sweep holds the port at P in {1, 4, 8} against the numpy oracle
  (``tests/oracle.py``) as row sets.
- Importing the port loads neither jax nor the reference package.
"""

import os
import sys

if __name__ == "__main__":  # the P=8 reference needs its devices before jax loads
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import subprocess
import tempfile

import jax
import numpy as np
import pytest
import torch

import oracle  # noqa: E402
import test_torch_dist_cases as cases  # noqa: E402

from repro.core import DDF as RefDDF  # noqa: E402
from repro.core import DDFContext as RefContext  # noqa: E402
from repro_torch.core import DDF, DDFContext  # noqa: E402
from repro_torch.data import uniform_table  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
AGGS = {"c1": ("sum", "min", "max", "count", "mean")}


def _ref_partitions(ddf):
    P = ddf.ctx.nworkers
    counts = np.asarray(ddf.counts)
    cols = {k: np.asarray(v).reshape(P, -1) for k, v in ddf.columns.items()}
    return [{k: v[w, : counts[w]] for k, v in cols.items()} for w in range(P)]


def assert_same_partitions(ref_ddf, port_ddf, what):
    exp, got = _ref_partitions(ref_ddf), port_ddf.partitions()
    assert len(exp) == len(got), what
    for w, (e, g) in enumerate(zip(exp, got)):
        assert set(e) == set(g), (what, w, sorted(e), sorted(g))
        for k in e:
            assert e[k].dtype == g[k].dtype, (what, w, k)
            if k.endswith("_mean"):
                np.testing.assert_array_max_ulp(g[k], e[k], maxulp=1)
            else:
                np.testing.assert_array_equal(g[k], e[k], err_msg=f"{what} worker {w} {k}")


def assert_same_counters(ref_info, port_info, what):
    assert set(ref_info) == set(port_info), what
    for k in ref_info:
        np.testing.assert_array_equal(port_info[k].cpu().numpy(), np.asarray(ref_info[k]),
                                      err_msg=f"{what} {k}")


def run_slice_against_reference(P, rows_per_worker, cardinality, device="cpu"):
    """Build both packages' DDFs from the same layout and hold every stage's
    partitions and overflow counters to the reference's."""
    mesh = jax.make_mesh((P,), ("data",))
    rctx = RefContext(mesh=mesh, axes=("data",))
    ctx = DDFContext(nworkers=P, device=device)
    n = P * rows_per_worker
    left = uniform_table(n, cardinality, seed=1)
    right = uniform_table(n, cardinality, seed=2)
    cap = rows_per_worker + 5
    rl = RefDDF.from_numpy(left, rctx, capacity=cap, mode="eager")
    rr = RefDDF.from_numpy(right, rctx, capacity=cap, mode="eager")

    def port(ref):
        return DDF.from_partitions({k: np.asarray(v) for k, v in ref.columns.items()},
                                   np.asarray(ref.counts), ctx)

    pl, pr = port(rl), port(rr)
    rj, rji = rl.join(rr, on=("c0",), strategy="shuffle")
    pj, pji = pl.join(pr, on=("c0",), strategy="shuffle")
    assert_same_partitions(rj, pj, "join")
    assert_same_counters(rji, pji, "join")
    rg, rgi = rj.groupby(("c0",), AGGS, pre_combine=True)
    pg, pgi = pj.groupby(("c0",), AGGS, pre_combine=True)
    assert_same_partitions(rg, pg, "groupby")
    assert_same_counters(rgi, pgi, "groupby")
    ru, rui = rg.unique(("c0",))
    pu, pui = pg.unique(("c0",))
    assert_same_partitions(ru, pu, "unique")
    assert_same_counters(rui, pui, "unique")
    # the other pattern variants of the same operators
    rb, _ = rl.join(rr, on=("c0",), strategy="broadcast")
    pb, _ = pl.join(pr, on=("c0",), strategy="broadcast")
    assert_same_partitions(rb, pb, "broadcast join")
    rc, _ = rl.join(rr, on=("c0", "c1"), strategy="shuffle", num_chunks=3)
    pc, _ = pl.join(pr, on=("c0", "c1"), strategy="shuffle", num_chunks=3)
    assert_same_partitions(rc, pc, "chunked two-key join")
    rs, _ = rj.groupby(("c0",), AGGS, pre_combine=False, num_chunks=2)
    ps, _ = pj.groupby(("c0",), AGGS, pre_combine=False, num_chunks=2)
    assert_same_partitions(rs, ps, "shuffle-compute groupby")
    return pj.num_rows(), pg.num_rows()


def test_slice_matches_reference_at_p1():
    joined, groups = run_slice_against_reference(1, 400, 0.5)
    assert joined > 0 and groups > 0


@pytest.fixture(scope="module")
def p8_run():
    """This file under ``__main__`` at P=8: the slice, then the column
    types."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, os.path.abspath(__file__)], capture_output=True,
                          text=True, timeout=600, env=env)


def test_slice_matches_reference_at_p8(p8_run):
    assert "PORT MATCHES REFERENCE AT P=8" in p8_run.stdout, \
        p8_run.stdout[-3000:] + p8_run.stderr[-3000:]


def test_column_types_match_reference_at_p8(p8_run):
    assert p8_run.returncode == 0, p8_run.stdout[-3000:] + p8_run.stderr[-3000:]
    assert "COLUMN TYPES MATCH REFERENCE AT P=8" in p8_run.stdout


# -- uint32 and vector columns ----------------------------------------------------------

def coltypes_against_reference(P: int) -> tuple[dict, dict]:
    """(port, reference) flat results of the column-type cases at P."""
    rctx = RefContext(mesh=jax.make_mesh((P,), ("data",)), axes=("data",))
    layout, exp = cases.reference_coltypes(RefDDF, rctx, P)
    return cases.coltype_cases(DDFContext(nworkers=P, device="cpu"), layout), exp


@pytest.fixture(scope="module")
def coltypes_p1():
    return coltypes_against_reference(1)


@pytest.mark.parametrize("case", cases.COLTYPE_CASES)
def test_column_types_match_reference_at_p1(coltypes_p1, case):
    got, exp = coltypes_p1
    assert any(k.startswith(f"{case}|0|") for k in exp), case
    assert not cases.coltype_mismatches(got, exp, case)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the class is what is compared
        return type(e)
    return None


REFUSALS = {
    # the literal enters as a weak int32, which it does not fit
    "overflowing literal": lambda d, col: d.select(col("k") > 4_000_000_003),
    # the (n,) row mask does not broadcast against (n, 3) rows
    "vector aggregate": lambda d, col: d.groupby(("k",), {"vec": ("sum", "min")}),
}


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_column_type_refusals_match_reference(refusal):
    from repro.expr import col as ref_col
    from repro_torch.expr import col

    data = cases.coltype_tables(40)["ct left"]
    ref = RefDDF.from_numpy(data, RefContext(mesh=jax.make_mesh((1,), ("data",)),
                                             axes=("data",)), mode="eager")
    port = DDF.from_numpy(data, DDFContext(nworkers=1, device="cpu"))
    exp = _raised(lambda: REFUSALS[refusal](ref, ref_col))
    assert exp is not None
    assert _raised(lambda: REFUSALS[refusal](port, col)) is exp


def test_from_arrays_and_empty_match_reference():
    from repro.core.dataframe import empty as ref_empty
    from repro.core.dataframe import from_arrays as ref_from_arrays
    from repro_torch.core import empty, from_arrays

    rng = np.random.default_rng(4)
    cols = {"a": np.arange(6, dtype=np.int32),
            "u": rng.integers(0, 2**32, 6, dtype=np.uint64).astype(np.uint32),
            "v": rng.standard_normal((6, 2)).astype(np.float32)}
    for nvalid in (None, 4):
        ref = ref_from_arrays(cols, nvalid=nvalid)
        port = from_arrays({k: v[None] for k, v in cols.items()},
                           nvalid=None if nvalid is None else [nvalid], device="cpu")
        np.testing.assert_array_equal(port.nvalid.numpy(), [int(ref.nvalid)])
        assert port.nvalid.dtype == torch.int32
        for k, v in ref.columns.items():
            got = port.columns[k].numpy()
            assert got.dtype == np.asarray(v).dtype and got.shape == (1,) + v.shape
            assert got.tobytes() == np.asarray(v).tobytes()
    bad = {"a": np.arange(4, dtype=np.int32), "b": np.arange(3, dtype=np.int32)}
    assert _raised(lambda: ref_from_arrays(bad)) is ValueError
    assert _raised(lambda: from_arrays({k: v[None] for k, v in bad.items()},
                                       device="cpu")) is ValueError
    schema = {"a": np.int32, "u": np.uint32, "f": np.float32}
    ref, port = ref_empty(schema, 5), empty(schema, 5, nworkers=3, device="cpu")
    assert int(ref.nvalid) == 0 and port.nvalid.tolist() == [0, 0, 0]
    for k, v in ref.columns.items():
        got = port.columns[k].numpy()
        assert got.dtype == np.asarray(v).dtype and got.shape == (3,) + v.shape
        assert not got.any()


# -- numpy oracle sweep -------------------------------------------------------------

def _canonical_without_mean(table):
    return oracle.canonical({k: v for k, v in table.items() if not k.endswith("_mean")})


@pytest.mark.parametrize("seed", range(20))
def test_slice_matches_oracle(seed):
    P = (1, 4, 8)[seed % 3]
    rng = np.random.default_rng(seed)
    nl, nr = (int(x) for x in rng.integers(1, 120, 2))
    keys = int(rng.integers(1, 30))
    left = {"k": rng.integers(0, keys, nl).astype(np.int32),
            "c1": rng.integers(-1000, 1000, nl).astype(np.int32)}
    right = {"k": rng.integers(0, keys, nr).astype(np.int32),
             "w": rng.integers(-1000, 1000, nr).astype(np.int32)}
    ctx = DDFContext(nworkers=P, device="cpu")
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
    # a quota of a whole partition: skewed keys cannot overflow a destination
    J, ji = L.join(R, on=("k",), strategy="shuffle", quota=max(L.capacity, R.capacity),
                   capacity=nl * nr + 1)
    exp_j = oracle.o_join(left, right, ("k",))
    assert oracle.canonical(J.to_numpy()) == oracle.canonical(exp_j)
    G, gi = J.groupby(("k",), AGGS, pre_combine=bool(seed % 2), quota=J.capacity)
    got_g, exp_g = G.to_numpy(), oracle.o_groupby(exp_j, ("k",), AGGS)
    assert _canonical_without_mean(got_g) == _canonical_without_mean(exp_g)
    order, exp_order = np.argsort(got_g["k"]), np.argsort(exp_g["k"])
    np.testing.assert_allclose(got_g["c1_mean"][order],
                               exp_g["c1_mean"][exp_order].astype(np.float32), rtol=2**-23)
    U, ui = J.unique(("k",), quota=J.capacity)
    assert sorted(U.to_numpy()["k"].tolist()) == sorted(oracle.o_unique(
        {"k": exp_j["k"]}, ("k",))["k"].tolist())
    for info in (ji, gi, ui):
        assert all(int(v.sum()) == 0 for v in info.values())


# -- package boundaries ---------------------------------------------------------------

def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, numpy, repro_torch, repro_torch.kernels, repro_torch.core, "
            "repro_torch.expr, repro_torch.core.vocab, repro_torch.core.comm.channels, "
            "repro_torch.core.comm.group, "
            "repro_torch.data, repro_torch.configs, repro_torch.models, "
            "repro_torch.models.convert, repro_torch.serve, repro_torch.plan, "
            "repro_torch.obs, repro_torch.stream, repro_torch.stats, repro_torch.testing, "
            "repro_torch.data.io, repro_torch.service, repro_torch.train, "
            "repro_torch.train.checkpoint, repro_torch.train.compress, "
            "repro_torch.train.elastic, repro_torch.data.pipeline, repro_torch.launch, "
            "repro_torch.launch.shapes, repro_torch.launch.roofline, repro_torch.launch.op_cost, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, repro_torch.launch.dryrun_ddf, "
            "repro_torch.configs.paper_cylon, repro_torch.sharding, tempfile, chip_smoke; "
            "assert repro_torch.launch.dryrun.run_cell('olmo-1b', 'decode_32k', save=False, "
            "verbose=False)['status'] == 'ok'; "
            "repro_torch.configs.get_config('zamba2-1.2b'); "
            "repro_torch.configs.get_config('mamba2-1.3b'); "
            "from repro_torch.core import DDF, DDFContext; "
            "lz = DDF.from_numpy({'k': numpy.arange(8, dtype=numpy.int32)}, "
            "DDFContext(nworkers=2, device='cpu'), mode='lazy'); "
            "lz.unique(('k',)).explain(); lz.unique(('k',)).collect(); "
            "d = tempfile.mkdtemp(); "
            "repro_torch.data.write_dataset({'k': numpy.arange(50, dtype=numpy.int32) % 5}, d, "
            "chunk_rows=8); "
            "repro_torch.stream.scan_dataset(d, DDFContext(nworkers=2, device='cpu'), "
            "batch_rows=16).groupby(('k',), {'k': ('count',)}).collect_stream(); "
            "svc = repro_torch.service.QueryService(); "
            "h = svc.submit(repro_torch.stream.scan_dataset(d, DDFContext(nworkers=2, "
            "device='cpu'), batch_rows=16).groupby(('k',), {'k': ('count',)})); "
            "assert int(h.result(timeout=60).to_numpy()['k_count'].sum()) == 50; "
            "svc.shutdown(); "
            "from repro_torch.models import build_model; "
            "from repro_torch.train.train_step import init_train_state, make_train_step; "
            "import torch; cfg = repro_torch.configs.get_smoke_config('olmo-1b'); "
            "from repro_torch.launch.mesh import make_production_mesh; "
            "assert make_production_mesh().size == 256; "
            "assert make_production_mesh(multi_pod=True).size == 512; "
            "assert not torch.cuda.is_initialized(); "
            "m = build_model(cfg, device='cpu'); "
            "st = init_train_state(m, torch.Generator().manual_seed(0)); "
            "pipe = repro_torch.data.pipeline.TokenPipeline(DDFContext(nworkers=2, "
            "device='cpu'), n_docs=400, vocab=cfg.vocab_size, seq_len=16, batch=2); "
            "st, met = make_train_step(m)(st, next(pipe)); "
            "assert bool(torch.isfinite(met['loss'])), met; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-3000:]


def test_chip_smoke_fails_without_the_repository():
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(ROOT, "chip_smoke.py")) as f:
            src = f.read()
        with open(os.path.join(d, "chip_smoke.py"), "w") as f:
            f.write(src)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=d, capture_output=True,
                             text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("capacity", [None, 40])
def test_from_numpy_layout_matches_reference(capacity):
    rng = np.random.default_rng(3)
    data = {"k": rng.integers(-2**40, 2**40, 33), "f": rng.random(33),
            "b": rng.random(33) < 0.5}
    ref = RefDDF.from_numpy(data, RefContext(mesh=jax.make_mesh((1,), ("data",)),
                                             axes=("data",)), capacity=capacity, mode="eager")
    port = DDF.from_numpy(data, DDFContext(nworkers=1, device="cpu"), capacity=capacity)
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    for k, v in ref.columns.items():
        np.testing.assert_array_equal(port.columns[k].numpy().reshape(-1), np.asarray(v))
    for k, v in ref.to_numpy().items():
        np.testing.assert_array_equal(port.to_numpy()[k], v)


def test_context_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert DDFContext(nworkers=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DDFContext(nworkers=2)
    assert DDFContext(nworkers=2, device="cpu").device.type == "cpu"


def test_from_numpy_runs_on_the_card_unless_asked():
    from repro_torch.core import dataframe

    data = {"k": np.arange(5, dtype=np.int32)}
    arrays = {"k": np.arange(6, dtype=np.int32).reshape(2, 3)}
    if torch.cuda.is_available():
        assert dataframe.from_numpy(data, 2).nvalid.device.type == "cuda"
        assert dataframe.from_arrays(arrays).nvalid.device.type == "cuda"
        assert dataframe.empty({"k": np.int32}, 3).nvalid.device.type == "cuda"
    else:
        for build in (lambda: dataframe.from_numpy(data, 2),
                      lambda: dataframe.from_arrays(arrays),
                      lambda: dataframe.empty({"k": np.int32}, 3)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
    t = dataframe.from_numpy(data, 2, device="cpu")
    assert t.nvalid.device.type == "cpu" and t.columns["k"].device.type == "cpu"


def test_unported_inputs_raise():
    ctx = DDFContext(nworkers=2, device="cpu")
    # a uint32 column, once refused, is held as the reference holds it
    u = np.array([1, 2**31, 2**32 - 1], np.uint32)
    ref = RefDDF.from_numpy({"u": u}, RefContext(mesh=jax.make_mesh((1,), ("data",)),
                                                 axes=("data",)), mode="eager")
    port = DDF.from_numpy({"u": u}, ctx)
    assert port.columns["u"].dtype == torch.uint32
    got, exp = port.to_numpy()["u"], ref.to_numpy()["u"]
    assert got.dtype == exp.dtype == np.uint32 and got.tobytes() == exp.tobytes()
    d = DDF.from_numpy({"k": np.arange(4, dtype=np.int64), "v": np.ones(4)}, ctx)
    assert d.columns["k"].dtype == torch.int32 and d.columns["v"].dtype == torch.float32
    with pytest.raises(TypeError, match="expr"):
        d.groupby(("k",), [("v", "sum")])
    with pytest.raises(KeyError):
        d.groupby(("k",), {"missing": ("sum",)})
    # the lazy plans' profiled collect, which waited for the cost-model
    # check, runs: the same rows, and a profile of the run
    lz = d.lazy()
    out = lz.collect(profile=True).to_numpy()
    assert lz.last_profile is not None and lz.last_profile.trace is not None
    for k, v in d.to_numpy().items():
        np.testing.assert_array_equal(out[k], v)


if __name__ == "__main__":
    assert len(jax.devices()) == 8, jax.devices()
    run_slice_against_reference(8, 150, 0.5)
    print("PORT MATCHES REFERENCE AT P=8", flush=True)
    got, exp = coltypes_against_reference(8)
    bad = [m for c in cases.COLTYPE_CASES for m in cases.coltype_mismatches(got, exp, c)]
    assert not bad, bad[:10]
    print("COLUMN TYPES MATCH REFERENCE AT P=8")
