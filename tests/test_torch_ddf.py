"""The port's DDF slice (join -> groupby -> unique) against the reference.

- At P=1 both packages run in this process; at P=8 the reference needs 8
  host devices, so this file re-runs itself under ``__main__`` in a
  subprocess with ``XLA_FLAGS`` set before jax is imported (as
  ``scripts/smoke_ddf.py`` does). Both sides start from the same partition
  layout through ``DDF.from_partitions``, and every worker's live rows must
  be equal: exactly, with float means compared at float32 ulp (1 ulp
  allowed; both sides divide with one correctly rounded float32 division).
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


def test_slice_matches_reference_at_p8():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, os.path.abspath(__file__)], capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "PORT MATCHES REFERENCE AT P=8" in res.stdout


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
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.data, chip_smoke; "
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


def test_unported_inputs_raise():
    ctx = DDFContext(nworkers=2, device="cpu")
    with pytest.raises(TypeError, match="ROADMAP queue A"):
        DDF.from_numpy({"s": np.array(["a", "b"])}, ctx)
    with pytest.raises(TypeError, match="ROADMAP queue A"):
        DDF.from_numpy({"u": np.array([1, 2], np.uint32)}, ctx)
    d = DDF.from_numpy({"k": np.arange(4, dtype=np.int64), "v": np.ones(4)}, ctx)
    assert d.columns["k"].dtype == torch.int32 and d.columns["v"].dtype == torch.float32
    with pytest.raises(TypeError, match="expr"):
        d.groupby(("k",), [("v", "sum")])
    with pytest.raises(KeyError):
        d.groupby(("k",), {"missing": ("sum",)})


if __name__ == "__main__":
    assert len(jax.devices()) == 8, jax.devices()
    run_slice_against_reference(8, 150, 0.5)
    print("PORT MATCHES REFERENCE AT P=8")
