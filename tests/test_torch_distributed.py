"""The port's eager DDF over a process group, against the reference at P = 8.

- The reference spreads P = 8 workers over 8 host devices, which need their
  flag before jax loads: this file re-runs itself under ``__main__`` to run
  the slice of ``tests/test_torch_ddf.py`` (shuffle, broadcast and chunked
  two-key joins, groupby with and without the combiner, unique) once, and
  writes the input layout and every stage's partitions and overflow
  counters to an ``.npz``.
- gloo groups of world 2 (4 workers a rank) and world 8 (1 worker a rank,
  the reference's own layout) run ``DDFContext(nworkers=8, device="cpu",
  group=WORLD)`` in spawned ranks (``tests/test_torch_dist_cases.py``, which
  imports no jax). Every rank starts from the reference's layout through
  ``from_partitions`` and must give the reference's partitions worker for
  worker, by bits (group means within 1 float32 ulp), and its counters.
  The column-type cases (uint32 keys and values, vector columns:
  ``cases.coltype_results``) start from the reference's layout too and
  must equal its partitions and counters by bits.
- The other cross-worker steps (sorts with their pivots, rebalance, head,
  rolling windows, transpose, length, agg with NaNs of both signs, union,
  difference, a string join, the Bruck and chunked shuffles, int16 / int8
  / bool / float16 columns through a shuffle, the Communicator's
  collectives, partitioned CSV input and output) must equal the
  one-process port at P = 8 by bits; that port is held to the reference
  by ``tests/test_torch_ops.py`` and ``tests/test_torch_stats.py``. The
  Communicator's barrier holds every rank until the last one enters.
- What a group refuses: P not divisible by the world, a backend that
  cannot move the device's tensors. The lazy plan, ``mode="lazy"`` and a
  streamed scan, which a group refused before it ran them, give the
  one-process port's bits (``tests/test_torch_distributed_plans.py`` holds
  those layers to the reference).

Every spawn and every group has a time limit, so a rank that raises fails
a test instead of hanging the run.
"""

import os
import sys

if __name__ == "__main__":  # the P=8 reference needs its devices before jax loads
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import subprocess

import numpy as np
import pytest
import torch.distributed as dist

import test_torch_dist_cases as cases  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import DDF, DDFContext  # noqa: E402
from repro_torch.core.comm import group  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORLDS = (2, 8)
SPAWN_TIMEOUT_S = 240.0
REFERENCE_TIMEOUT_S = 300
ROWS_PER_WORKER, CARDINALITY = 150, 0.5  # run_slice_against_reference(8, 150, 0.5)


# -- the reference, in a process of its own -------------------------------------------

def write_reference(path: str) -> None:
    import jax

    from repro.core import DDF as RefDDF
    from repro.core import DDFContext as RefContext
    from repro_torch.data import uniform_table

    assert len(jax.devices()) == cases.P, jax.devices()
    rctx = RefContext(mesh=jax.make_mesh((cases.P,), ("data",)), axes=("data",))
    n = cases.P * ROWS_PER_WORKER
    cap = ROWS_PER_WORKER + 5
    rl = RefDDF.from_numpy(uniform_table(n, CARDINALITY, seed=1), rctx, capacity=cap,
                           mode="eager")
    rr = RefDDF.from_numpy(uniform_table(n, CARDINALITY, seed=2), rctx, capacity=cap,
                           mode="eager")
    out = {}
    for side, d in (("left", rl), ("right", rr)):
        out.update({f"{side}|{k}": np.asarray(v) for k, v in d.columns.items()})
        out[f"{side}|counts"] = np.asarray(d.counts)

    def record(case, ddf, info):
        counts = np.asarray(ddf.counts)
        for k, v in ddf.columns.items():
            v = np.asarray(v).reshape(cases.P, -1)
            for w in range(cases.P):
                out[f"{case}|{w}|{k}"] = v[w, : counts[w]]
        out.update({f"{case}|info|{k}": np.asarray(v) for k, v in info.items()})

    rj, rji = rl.join(rr, on=("c0",), strategy="shuffle")
    record("join", rj, rji)
    rg, rgi = rj.groupby(("c0",), cases.SLICE_AGGS, pre_combine=True)
    record("groupby", rg, rgi)
    record("unique", *rg.unique(("c0",)))
    record("broadcast join", *rl.join(rr, on=("c0",), strategy="broadcast"))
    record("chunked two-key join", *rl.join(rr, on=("c0", "c1"), strategy="shuffle",
                                            num_chunks=3))
    record("shuffle-compute groupby", *rj.groupby(("c0",), cases.SLICE_AGGS,
                                                   pre_combine=False, num_chunks=2))
    layout, results = cases.reference_coltypes(RefDDF, rctx, cases.P)
    out.update(layout)
    out.update(results)
    np.savez(path, **out)


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "reference.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)],
                         capture_output=True, text=True, timeout=REFERENCE_TIMEOUT_S, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def reference(reference_path):
    return _load(reference_path)


# -- the grouped port, in spawned ranks ----------------------------------------------

def spawn_ranks(world: int, layout_path, out_dir) -> list[dict]:
    """Run ``cases.rank_main`` in ``world`` spawned gloo ranks; their results."""
    cases.write_io_inputs(os.path.join(out_dir, "csv_in"))
    cases.write_layer_dataset(os.path.join(out_dir, "layer_ds"))
    cases.spawn(cases.rank_main,
                (world, os.path.join(out_dir, "store"), str(layout_path), str(out_dir)),
                world, SPAWN_TIMEOUT_S, str(out_dir))
    return [_load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, reference_path, tmp_path_factory):
    return spawn_ranks(request.param, reference_path,
                       tmp_path_factory.mktemp(f"world{request.param}"))


@pytest.fixture(scope="module")
def one_card(tmp_path_factory):
    ctx = DDFContext(nworkers=cases.P, device="cpu")
    io_dir = tmp_path_factory.mktemp("one_card_io")
    cases.write_io_inputs(str(io_dir / "csv_in"))
    return {**cases.pattern_cases(ctx),
            **cases.layer_cases(ctx, cases.write_layer_dataset(str(io_dir / "layer_ds"))),
            **cases.io_cases(ctx, str(io_dir / "csv_in"), str(io_dir / "csv_out"))}


# -- comparisons -------------------------------------------------------------------------

def _same_bits(got: np.ndarray, exp: np.ndarray, what: str) -> None:
    assert got.dtype == exp.dtype and got.shape == exp.shape, \
        (what, got.dtype, got.shape, exp.dtype, exp.shape)
    assert got.tobytes() == exp.tobytes(), (what, got[:8], exp[:8])


def _of_case(flat: dict, case: str) -> dict:
    return {k: v for k, v in flat.items() if k.split("|")[0] == case}


@pytest.mark.parametrize("case", cases.SLICE_CASES)
def test_grouped_slice_matches_reference(ranks, reference, case):
    got = ranks[0]
    exp_parts = cases.partitions_of(reference, case)
    got_parts = cases.partitions_of(got, case)
    rows = sum(len(next(iter(p.values()), ())) for p in exp_parts)
    # c1 is drawn from all of int32: the two-key join matches no row, in
    # the reference as here
    assert (rows == 0) == (case == "chunked two-key join"), (case, rows)
    for w, (e, g) in enumerate(zip(exp_parts, got_parts)):
        assert set(e) == set(g), (case, w, sorted(e), sorted(g))
        for k in e:
            if k.endswith("_mean"):
                assert g[k].dtype == e[k].dtype, (case, w, k)
                np.testing.assert_array_max_ulp(g[k], e[k], maxulp=1)
            else:
                _same_bits(g[k], e[k], f"{case} worker {w} {k}")
    exp_info, got_info = cases.infos_of(reference, case), cases.infos_of(got, case)
    assert set(exp_info) == set(got_info), case
    for k in exp_info:
        _same_bits(got_info[k], exp_info[k], f"{case} {k}")


def test_grouped_join_census_equals_the_dry_run(ranks):
    """Each gloo rank's ``group.census()`` of the slice's shuffle join
    equals ``dryrun_ddf.run_rank`` of that rank on the meta device at the
    same P, capacity and quota (the join's defaults), kind for kind."""
    from repro_torch.launch import dryrun_ddf

    world = len(ranks)
    for r in (0, world - 1):
        got = cases.infos_of(ranks[r], "join census", "value")
        cap = int(got.pop("capacity"))
        rec = dryrun_ddf.run_rank(world, r, P=cases.P, capacity=cap, save=False,
                                  verbose=False)
        want = {k: [v["count"], v["bytes"]] for k, v in rec["collectives"]["per_op"].items()}
        assert {k: v.tolist() for k, v in got.items()} == want, (world, r)
        assert set(want) == {"all-to-all"} and want["all-to-all"][0] == 6


@pytest.mark.parametrize("case", cases.COLTYPE_CASES)
def test_grouped_column_types_match_reference(ranks, reference, case):
    assert any(k.startswith(f"{case}|0|") for k in reference), case
    assert not cases.coltype_mismatches(ranks[0], reference, case)


@pytest.mark.parametrize("case", cases.PATTERN_CASES + cases.IO_CASES)
def test_grouped_patterns_match_one_card(ranks, one_card, case):
    got, exp = _of_case(ranks[0], case), _of_case(one_card, case)
    assert exp and set(got) == set(exp), (case, sorted(set(got) ^ set(exp)))
    for k in exp:
        _same_bits(got[k], exp[k], k)


def test_grouped_bruck_equals_native(ranks):
    native, bruck = _of_case(ranks[0], "native"), _of_case(ranks[0], "bruck")
    assert native and len(native) == len(bruck)
    for k, v in native.items():
        _same_bits(bruck[k.replace("native", "bruck", 1)], v, k)


def test_grouped_barrier_waits_for_every_rank(ranks):
    times = cases.infos_of(ranks[0], "barrier", "value")["times"]  # (P, [enter, exit])
    assert times.shape == (cases.P, 2)
    # rank 0 (worker 0) enters late; no worker may leave before it entered
    assert (times[:, 1] >= times[0, 0]).all(), times


def test_every_rank_returns_every_worker(ranks):
    first = ranks[0]
    for r, other in enumerate(ranks[1:], 1):
        assert set(other) == set(first), r
        for k, v in first.items():
            _same_bits(other[k], v, f"rank {r} {k}")


def test_ranks_import_no_jax_and_refuse(ranks, one_card):
    """No rank loads jax; P not divisible by the world is refused; the lazy
    plan, ``mode="lazy"`` and a streamed scan, once refused, run and give
    one card's bits, their counters too."""
    for rank in ranks:
        assert rank["modules|value|jax"].size == 0, rank["modules|value|jax"]
    ref = cases.infos_of(ranks[0], "refusal", "value")
    assert set(ref) == {"indivisible"}, ref
    assert str(ref["indivisible"]).startswith("ValueError"), ref
    assert "P % world" in str(ref["indivisible"])
    for case in cases.LAYER_CASES:
        got, exp = _of_case(ranks[0], case), _of_case(one_card, case)
        assert any("|info|" in k for k in exp) and set(got) == set(exp), \
            (case, sorted(set(got) ^ set(exp)))
        for k in exp:
            _same_bits(got[k], exp[k], k)


# -- refusals in this process --------------------------------------------------------

def test_a_group_needs_an_initialised_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        DDFContext(nworkers=8, device="cpu", group=object())


@pytest.fixture
def one_rank_group(tmp_path, monkeypatch):
    """A gloo group of one rank in this process, left at the end."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    group.init_from_env(device="cpu", timeout=cases.GROUP_TIMEOUT_S,
                        init_method=f"file://{tmp_path / 'store'}")
    try:
        yield dist.group.WORLD
    finally:
        group.close()
    assert not dist.is_initialized()


def test_world_one_group_equals_one_card_and_refuses_one_device_layers(one_rank_group,
                                                                        tmp_path):
    """A group of one rank: the same bits as one card through the
    collectives, and through the layers a group once refused (a lazy plan,
    a streamed ``scan_csv``), which now run over it."""
    from repro_torch.stream import scan_csv

    ctx = DDFContext(nworkers=4, device="cpu", group=one_rank_group)
    one = DDFContext(nworkers=4, device="cpu")
    assert (ctx.workers.world, ctx.workers.local, ctx != one) == (1, 4, True)
    data = {"k": np.arange(50, dtype=np.int32) % 7, "v": np.arange(50, dtype=np.int32)}
    outs = []
    for c in (ctx, one):
        d = DDF.from_numpy(data, c)
        j, _ = d.join(d, on=("k",), strategy="shuffle")
        g, _ = j.groupby(("k",), {"v": ("sum", "max")})
        outs.append([g.partitions(), d.sort_values("v", descending=True)[0].partitions(),
                     d.rolling("v", 3, op="max")[0].partitions(), d.head(11).partitions()])
    for a, b in zip(*outs):
        for pa, pb in zip(a, b):
            assert set(pa) == set(pb)
            for k in pa:
                _same_bits(pa[k], pb[k], k)
    path = tmp_path / "in.csv"
    np.savetxt(path, np.stack([data["k"], data["v"]], axis=1), fmt="%d", delimiter=",",
               header="k,v", comments="")
    runs = []
    for c in (ctx, one):
        lz = DDF.from_numpy(data, c).lazy().join(DDF.from_numpy(data, c).lazy(), on=("k",),
                                                 strategy="shuffle")
        lz = lz.groupby(("k",), {"v": ("sum", "max")})
        sc = scan_csv([str(path)], {"k": np.int32, "v": np.int32}, c, batch_rows=12)
        sc = sc.sort_values("v", descending=True)
        runs.append([lz.collect().partitions(), sc.collect_stream().partitions(),
                     {k: v.cpu().numpy() for k, v in lz.last_info.items()}])
    for a, b in zip(runs[0][:2], runs[1][:2]):
        for pa, pb in zip(a, b):
            assert set(pa) == set(pb)
            for k in pa:
                _same_bits(pa[k], pb[k], k)
    assert runs[0][2].keys() == runs[1][2].keys() and runs[0][2]
    for k in runs[0][2]:
        _same_bits(runs[0][2][k], runs[1][2][k], k)


def test_nccl_with_a_cpu_device_raises(one_rank_group, monkeypatch):
    """A group whose backend cannot move the context's tensors is refused:
    gloo with a card, and (the backend's name stubbed) NCCL with the CPU."""
    with pytest.raises(ValueError, match="gloo process group cannot move cuda:0"):
        group.WorkerBlock(4, torch.device("cuda", 0), one_rank_group)
    with monkeypatch.context() as m:
        m.setattr(group.dist, "get_backend", lambda g=None: "nccl")
        with pytest.raises(ValueError, match="nccl process group cannot move cpu"):
            DDFContext(nworkers=4, device="cpu", group=one_rank_group)


def test_chip_smoke_grouped_main_path_runs_on_the_cpu(one_rank_group):
    """The smoke run's grouped phase at a small size: the main path over a
    group of one rank gives every worker the digests of the one-device run,
    which is held to the numpy oracle (no kernel launches on the CPU)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    left, right = chip_smoke.paper_tables(cases.P, 2000)
    one = chip_smoke.run_main_path(cases.P, 2000, {}, left, right, device="cpu")
    got = chip_smoke.run_main_path(cases.P, 2000, {}, left, right, group=one_rank_group,
                                   oracle=False, device="cpu")
    assert one["join_rows"] > 0 and got["join_rows"] == one["join_rows"]
    assert got["launches"] == one["launches"]
    assert set(got["digests"]) == set(chip_smoke.GROUPED_STEPS)
    assert got["digests"] == one["digests"]
    assert [len(v) for v in got["digests"].values()] == [cases.P] * 3


if __name__ == "__main__":
    write_reference(sys.argv[1])
    print("REFERENCE WRITTEN")


def test_chip_smoke_grouped_paths_run_on_the_cpu(one_rank_group, tmp_path):
    """The smoke run's extended grouped phase at a small size over a group of
    one rank: the main path, the column-types step, the lazy path, the streaming path's groupby
    killed and resumed on the one-device run's kept dataset, and the service
    mix give the one-device runs' launches (the dispatch points wrapped to
    count on the CPU) and every worker's digests."""
    sys.path.insert(0, ROOT)
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
    chip_smoke._Steps.expect_on_cpu = True
    rows, budget, ds = 2000, 48_000, str(tmp_path / "left")
    try:
        left, right = chip_smoke.paper_tables(cases.P, rows)
        one = {"main": chip_smoke.run_main_path(cases.P, rows, {}, left, right, device="cpu"),
               "coltypes": chip_smoke.run_coltype_steps(cases.P, rows, device="cpu"),
               "lazy": chip_smoke.run_lazy_path(cases.P, left, right, device="cpu"),
               "stream": chip_smoke.run_stream_path(
                   cases.P, 6_000, device="cpu", small_rows_per_worker=500, csv_rows=1_000,
                   chunk_rows=4096, memory_budget_bytes=budget, dataset_dir=ds),
               "service": chip_smoke.run_service_path(
                   cases.P, 6_000, 1_500, device="cpu", chunk_rows=4096,
                   memory_budget_bytes=budget, cancel_batch_rows=480)}
        got = chip_smoke.run_grouped_paths(one_rank_group, rows, ds, device="cpu",
                                           lazy_rows_per_worker=1_500,
                                           memory_budget_bytes=budget,
                                           coltype_rows_per_worker=rows)
    finally:
        opmod.hash_partition_ids, lo._seg_reduce_dispatch = hp, sr
        chip_smoke._Steps.expect_on_cpu = False
    total = chip_smoke.check_grouped(got, one)
    assert total["hash_partition"] > 0 and total["segment_reduce"] > 0
    assert total["hash_partition_hist"] == 0
    assert got["stream"]["batches"] == one["stream"]["batches"] >= 4
    assert len(got["service"]["digests"]) == 2 * chip_smoke.SERVICE_SCANS + 2
