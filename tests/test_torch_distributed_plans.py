"""Lazy plans, streamed queries and the query service over a process group,
against the reference at P = 8.

- The reference spreads P = 8 workers over 8 host devices, which need their
  flag before jax loads: this file re-runs itself under ``__main__`` to run,
  once, on ``uniform_table(8 * 150, 0.5, seed=1)`` and ``seed=2``: the
  README's lazy pipeline (``chip_smoke._lazy_steps``), a lazy ``unique`` and
  a lazy ``sort_values`` by ``collect()``; then, with the left and right
  tables written as chunked datasets (170-row chunks, whose edges do not
  line up with the 280-row batches: 5 batches), a streamed groupby through
  the carry, a streamed ``unique``, a sort through a spill and a scan x scan
  spill join. It writes the input layout, every result's partitions and
  every counter of ``last_info`` to an ``.npz`` beside the datasets.
- gloo groups of world 2 and 8 spawned as in ``tests/test_torch_distributed.py``
  run ``tests/test_torch_dist_cases.py::plan_rank_main`` (no jax) over
  ``DDFContext(nworkers=8, device="cpu", group=WORLD)`` from the reference's
  layout and the same dataset directory: the lazy cases at both worlds; at
  world 2 also the streamed cases, ``to_batches``, ``scan_csv`` (rank 0
  converts), each of a streamed groupby and sort killed at device_op 2 of 5
  with a snapshot every 2 morsels and resumed, the resume of a snapshot
  written by one process, and the query service: 2 streamed groupbys, 2
  lazy pipelines, an eager thunk and a scan-free select under
  ``policy="fair"``, ``max_running=2``, rank 1 submitting 0.3 s late each
  time, then a cancel.
- Every result equals the reference's partitions, worker for worker, by
  bits (means within 1 float32 ulp), and every rank's counters equal the
  reference's; the cases the reference does not run equal the one-process
  port's (P = 8 on one CPU device).

Every spawn and every group has a time limit.
"""

import os
import re
import sys

if __name__ == "__main__":  # the P=8 reference needs its devices before jax loads
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import shutil
import subprocess

import numpy as np
import pytest
import torch.distributed as dist

import test_torch_dist_cases as cases  # noqa: E402

from repro_torch.core import DDF, DDFContext  # noqa: E402
from repro_torch.core.comm import group  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORLDS = (2, 8)
SPAWN_TIMEOUT_S = 240.0
REFERENCE_TIMEOUT_S = 300
P = cases.P


# -- the reference, in a process of its own -------------------------------------------

def _ref_parts(ddf) -> list[dict]:
    counts = np.asarray(ddf.counts)
    cols = {k: np.asarray(v).reshape(P, -1) for k, v in ddf.columns.items()}
    return [{k: v[w, : counts[w]] for k, v in cols.items()} for w in range(P)]


def _ref_info(info) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in (info or {}).items()}


def write_reference(directory: str) -> None:
    import jax

    import chip_smoke
    from repro import expr as ref_expr
    from repro import stream as ref_stream
    from repro.core import DDF as RefDDF
    from repro.core import DDFContext as RefContext
    from repro.data import dataset as ref_dataset
    from repro_torch.data import uniform_table

    assert len(jax.devices()) == P, jax.devices()
    rctx = RefContext(mesh=jax.make_mesh((P,), ("data",)), axes=("data",))
    n = P * cases.PLAN_ROWS_PER_WORKER
    tables = {side: uniform_table(n, cases.PLAN_CARDINALITY, seed=seed)
              for side, seed in (("left", 1), ("right", 2))}
    out = {}
    ddfs = {}
    for side, t in tables.items():
        d = RefDDF.from_numpy(t, rctx, capacity=cases.PLAN_ROWS_PER_WORKER + 5, mode="eager")
        ddfs[side] = d
        out.update({f"{side}|{k}": np.asarray(v) for k, v in d.columns.items()})
        out[f"{side}|counts"] = np.asarray(d.counts)
        ref_dataset.write_dataset(t, os.path.join(directory, side),
                                  chunk_rows=cases.STREAM_CHUNK_ROWS)
    np.savetxt(os.path.join(directory, "left.csv"),
               np.stack([tables["left"]["c0"], tables["left"]["c1"]], axis=1), fmt="%d",
               delimiter=",", header="c0,c1", comments="")

    def readme(L, R):
        return chip_smoke._lazy_steps(L, R, X=ref_expr)

    for case, q in cases.lazy_queries(ddfs["left"], ddfs["right"], ref_expr, readme).items():
        cases.record_parts(out, case, _ref_parts(q.collect()), _ref_info(q.last_info))
    for case, q in cases.stream_queries(ref_stream, ref_expr, rctx,
                                        os.path.join(directory, "left"),
                                        os.path.join(directory, "right")).items():
        cases.record_parts(out, case, _ref_parts(q.collect_stream()), _ref_info(q.last_info))
    np.savez(os.path.join(directory, "reference.npz"), **out)


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def reference_path(tmp_path_factory):
    directory = tmp_path_factory.mktemp("reference")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep + ROOT + os.pathsep
                         + env.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), str(directory)],
                         capture_output=True, text=True, timeout=REFERENCE_TIMEOUT_S, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return directory / "reference.npz"


@pytest.fixture(scope="module")
def reference(reference_path):
    return _load(reference_path)


# -- the port: in one process, and over gloo groups ----------------------------------

@pytest.fixture(scope="module")
def one_process(reference_path, reference, tmp_path_factory):
    """The cases on one CPU device at P = 8; its killed runs' snapshots stay
    under ``<work>/<case>-kept`` for the group to resume."""
    ctx = DDFContext(nworkers=P, device="cpu")
    work = tmp_path_factory.mktemp("one_process")
    data_dir = os.path.dirname(reference_path)
    out = {**cases.plan_lazy_cases(ctx, reference),
           **cases.plan_stream_cases(ctx, data_dir),
           **cases.kill_cases(ctx, data_dir, str(work))}
    return {"flat": out, "work": str(work)}


def spawn_plan_ranks(world: int, layout_path, out_dir, one_work: str | None) -> list[dict]:
    """``cases.plan_rank_main`` in ``world`` spawned gloo ranks (the full
    set of cases when ``one_work``, the one-process snapshots, is given)."""
    if one_work is not None:
        shutil.copytree(one_work, os.path.join(out_dir, "one"))
    cases.spawn(cases.plan_rank_main,
                (world, os.path.join(out_dir, "store"), str(layout_path), str(out_dir),
                 one_work is not None),
                world, SPAWN_TIMEOUT_S, str(out_dir))
    return [_load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world2(reference_path, one_process, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("world2")
    return {"ranks": spawn_plan_ranks(2, reference_path, out_dir, one_process["work"]),
            "work": str(out_dir / "work")}


@pytest.fixture(scope="module")
def world8(reference_path, tmp_path_factory):
    return spawn_plan_ranks(8, reference_path, tmp_path_factory.mktemp("world8"), None)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def lazy_ranks(request):
    if request.param == 2:
        return request.getfixturevalue("world2")["ranks"]
    return request.getfixturevalue("world8")


# -- comparisons -------------------------------------------------------------------------

def _same_bits(got: np.ndarray, exp: np.ndarray, what: str) -> None:
    assert got.dtype == exp.dtype and got.shape == exp.shape, \
        (what, got.dtype, got.shape, exp.dtype, exp.shape)
    assert got.tobytes() == exp.tobytes(), (what, got.reshape(-1)[:8], exp.reshape(-1)[:8])


def _of_case(flat: dict, case: str) -> dict:
    return {k: v for k, v in flat.items() if k.split("|")[0] == case}


def _assert_case(got: dict, exp: dict, case: str, exp_case: str | None = None,
                 values: bool = True) -> None:
    """``case`` of ``got`` against ``exp_case`` (default ``case``) of
    ``exp``: partitions worker for worker by bits (means within 1 ulp),
    counters and (unless not ``values``) values by bits."""
    g, e = _of_case(got, case), _of_case(exp, exp_case or case)
    g = {k.split("|", 1)[1]: v for k, v in g.items() if values or "|value|" not in k}
    e = {k.split("|", 1)[1]: v for k, v in e.items() if values or "|value|" not in k}
    assert e and set(g) == set(e), (case, sorted(set(g) ^ set(e)))
    for k in e:
        if k.endswith("_mean") or k.endswith("|avg"):
            assert g[k].dtype == e[k].dtype, (case, k)
            np.testing.assert_array_max_ulp(g[k], e[k], maxulp=1)
        else:
            _same_bits(g[k], e[k], f"{case} {k}")


@pytest.mark.parametrize("case", cases.LAZY_CASES)
def test_grouped_lazy_collect_matches_reference(lazy_ranks, reference, case):
    rows = sum(len(v) for k, v in _of_case(reference, case).items() if k.endswith("|c0"))
    assert rows > 0, case
    assert any("|info|" in k for k in _of_case(reference, case)), case
    for rank in lazy_ranks:
        _assert_case(rank, reference, case)


@pytest.mark.parametrize("case", cases.STREAM_CASES)
def test_grouped_stream_matches_reference(world2, reference, case):
    assert int(reference[f"{case}|value|batches"]) >= 4
    for rank in world2["ranks"]:
        _assert_case(rank, reference, case)


@pytest.mark.parametrize("case", cases.PORT_STREAM_CASES)
def test_grouped_to_batches_and_scan_csv_match_one_process(world2, one_process, case):
    for rank in world2["ranks"]:
        _assert_case(rank, one_process["flat"], case)


def _without_source_ids(plan: str) -> str:
    """``explain()`` text with each ``SOURCE#<n>`` as ``SOURCE#``: ``n``
    counts the lazy frames the process built before (``plan/frame.py``'s
    process-wide ``_SIDS``), which a pytest worker shares with other files."""
    return re.sub(r"SOURCE#\d+", "SOURCE#", plan)


def test_grouped_explain_equals_one_process(world2, world8, one_process):
    """``explain()`` plans from global row counts: every rank prints one
    device's plan, row estimates and shuffle count included; only the
    process-wide source numbers may differ."""
    exp = str(one_process["flat"]["explain|value|lazy readme"])
    assert "shuffles: 1" in exp and "SOURCE#" in exp
    for rank in world2["ranks"] + world8:
        got = str(rank["explain|value|lazy readme"])
        assert _without_source_ids(got) == _without_source_ids(exp)


def test_traced_rows_are_global(world2, world8, one_process):
    """With tracing on, ``plan.execute`` and ``stream.device_op`` observe
    every worker's rows: the same on every rank as on one device."""
    for rank in world2["ranks"] + world8:
        for what in ("lazy rows", "stream rows"):
            key = f"traced|value|{what}"
            if key in rank:
                exp = one_process["flat"][key]
                assert (exp > 0).any(), what
                _same_bits(rank[key], exp, what)


@pytest.mark.parametrize("case", cases.KILL_CASES)
def test_killed_group_stream_resumes_to_the_same_bits(world2, case):
    """A group killed at device_op 2 of 5 resumes to its uninterrupted bits;
    rank 0 alone wrote the snapshots (one per publish) and the spill files,
    each once, and the resume cleared the store."""
    r0, r1 = world2["ranks"]
    for rank in (r0, r1):
        assert bool(rank[f"kill {case}|value|died"])
        # a resumed run's batch and chunk counts carry the killed run's
        _assert_case(rank, rank, f"kill {case} resumed", f"kill {case} whole", values=False)
        assert rank[f"kill {case}|value|left"].size == 0
    assert r0[f"kill {case}|value|kept"].tolist() == [0]
    for run, saves in (("killed", [0]), ("resumed", [1])):
        assert r0[f"kill {case}|value|{run} saves"].tolist() == saves, run
        assert r1[f"kill {case}|value|{run} saves"].size == 0, run
        assert r1[f"kill {case}|value|{run} files"].size == 0, run
        files = r0[f"kill {case}|value|{run} files"].tolist()
        assert files and len(files) == len(set(files)), (run, files)
    if case == "sort":  # its spill lives under the store: rank 0 wrote it
        assert any("/spill/" in f for f in r0[f"kill {case}|value|killed files"].tolist())


@pytest.mark.parametrize("case", cases.KILL_CASES)
def test_group_snapshot_resumes_in_one_process(world2, reference_path, case, tmp_path):
    """The world-2 group's snapshot resumes on one device at P = 8 to the
    group's bits."""
    from repro_torch import stream

    ck = tmp_path / "ckpt"
    shutil.copytree(os.path.join(world2["work"], f"{case}-kept"), ck)
    ctx = DDFContext(nworkers=P, device="cpu")
    left = os.path.join(os.path.dirname(reference_path), "left")
    if case == "groupby":
        from repro_torch import expr

        lz = cases.stream_queries(stream, expr, ctx, left, left)["stream groupby"]
    else:
        lz = stream.scan_dataset(left, ctx, batch_rows=cases.STREAM_BATCH_ROWS).sort_values("c1")
    got = lz.collect_stream(checkpoint_dir=str(ck), checkpoint_every=2, resume=True)
    out: dict = {}
    cases.record_parts(out, "resumed", got.partitions(), lz.last_info)
    _assert_case(out, world2["ranks"][0], "resumed", f"kill {case} whole", values=False)


@pytest.mark.parametrize("case", cases.KILL_CASES)
def test_one_process_snapshot_resumes_in_group(world2, one_process, case):
    for rank in world2["ranks"]:
        _assert_case(rank, one_process["flat"], f"kill {case} other world",
                     f"kill {case} whole", values=False)


@pytest.mark.parametrize("name", cases.SERVICE_QUERIES)
def test_grouped_service_equals_serial(world2, name):
    """Each query through the grouped service equals its serial grouped run
    by bits, on every rank, though rank 1 submitted later each time."""
    for rank in world2["ranks"]:
        _assert_case(rank, rank, f"service {name}", f"service {name} serial")


def test_grouped_service_ranks_take_the_same_turns(world2):
    r0, r1 = world2["ranks"]
    assert r0["service|value|states"].tolist() == ["DONE"] * len(cases.SERVICE_QUERIES)
    for k in ("states", "turns_total", "morsels_total", "morsels"):
        _same_bits(r1[f"service|value|{k}"], r0[f"service|value|{k}"], k)
    assert int(r0["service|value|turns_total"]) >= len(cases.SERVICE_QUERIES)


def test_grouped_service_cancel_ends_cancelled_on_every_rank(world2):
    """A scan cancelled after its first morsel (two thunks hold the
    scheduler around it) ends CANCELLED on both ranks, with no hang."""
    r0, r1 = world2["ranks"]
    for rank in (r0, r1):
        assert bool(rank["service cancel|value|raised"])
        assert rank["service cancel|value|states"].tolist() == ["CANCELLED", "DONE", "DONE"]
        # rank 0 ran the scan's first morsel, then the second holder, then
        # took its cancel at the scan's next turn; rank 1 followed
        assert int(rank["service cancel|value|morsels"]) == 1
    _same_bits(r1["service cancel|value|turns_total"], r0["service cancel|value|turns_total"],
               "turns_total")


def test_ranks_agree_and_import_no_jax(world2, world8):
    """Every rank of a group returns the same results (the files each wrote
    aside); none loads jax; rank 0's ints reach every rank; and a group
    whose ranks cannot see rank 0's converted CSV raises on every rank."""
    for ranks in (world2["ranks"], world8):
        first = ranks[0]
        for r, other in enumerate(ranks):
            assert other["modules|value|jax"].size == 0, other["modules|value|jax"]
            mine = {k for k in first if not k.endswith((" files", " saves", "|ints"))
                    and "blind scan" not in k}
            assert mine <= set(other), r
            for k in mine:
                _same_bits(other[k], first[k], f"rank {r} {k}")
    for rank in world2["ranks"]:
        assert rank["broadcast|value|ints"].tolist() == [1, -7, 2**40]
        err = str(rank["blind scan|value|error"])
        assert err.startswith("RuntimeError") and "rank(s) [1]" in err, err


# -- in this process ---------------------------------------------------------------------

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


def test_world_one_group_and_one_device_keep_their_own_plans(one_rank_group):
    """A plan is keyed by its sources, and a DDF belongs to one context: a
    world-1 group builds its own plan and callable (no false share with one
    device's) and reuses them on a second collect, to one device's bits."""
    from repro_torch.plan import executor

    sys.path.insert(0, ROOT)
    import chip_smoke

    left, right = chip_smoke.paper_tables(P, 300)
    runs = []
    for ctx in (DDFContext(nworkers=P, device="cpu"),
                DDFContext(nworkers=P, device="cpu", group=one_rank_group)):
        L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
        hits = []
        for _ in range(2):
            before = executor.cache_stats()
            out = chip_smoke._lazy_steps(L, R).collect()
            after = executor.cache_stats()
            hits.append(tuple(after[c]["hits"] - before[c]["hits"] for c in ("plan", "op")))
        runs.append((hits, out.to_numpy()))
    for hits, _ in runs:
        assert hits == [(0, 0), (1, 1)], hits
    assert runs[0][1]
    for k, v in runs[0][1].items():
        _same_bits(runs[1][1][k], v, k)


if __name__ == "__main__":
    write_reference(sys.argv[1])
    print("REFERENCE WRITTEN")


def test_grouped_service_in_one_process(one_rank_group):
    """A service over a one-rank group gives one device's bits under both
    policies; a query of another group is refused at submit; a shed
    submission fails its session (every rank alike) instead of raising."""
    import threading

    from repro_torch.expr import col
    from repro_torch.service import AdmissionError, QueryService, QueryState

    sys.path.insert(0, ROOT)
    import chip_smoke

    left, right = chip_smoke.paper_tables(P, 300)

    def mix(ctx):
        L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
        return [chip_smoke._lazy_steps(L, R), L.lazy().select(col("c1") < 2**29),
                lambda: L.sort_values("c0")[0]]

    one = DDFContext(nworkers=P, device="cpu")
    grouped = DDFContext(nworkers=P, device="cpu", group=one_rank_group)
    exp = [q.collect() if hasattr(q, "collect") else q() for q in mix(one)]
    for policy in ("fair", "round_robin"):
        with QueryService(policy=policy, max_running=2, ctx=grouped) as svc:
            hs = [svc.submit(q) for q in mix(grouped)]
            got = [h.result(timeout=60) for h in hs]
        assert [h.state for h in hs] == [QueryState.DONE] * 3
        assert svc.stats()["scheduler"]["world"] == 1
        for g, e in zip(got, exp):
            for k, v in e.to_numpy().items():
                _same_bits(g.to_numpy()[k], v, f"{policy} {k}")
    with QueryService() as svc, pytest.raises(ValueError, match="process group"):
        svc.submit(mix(grouped)[0])
    with QueryService(ctx=grouped) as svc, pytest.raises(ValueError, match="process group"):
        svc.submit(mix(one)[0])
    gate, started = threading.Event(), threading.Event()

    def hold():
        started.set()
        gate.wait(timeout=60)

    with QueryService(policy="round_robin", max_running=2, max_backlog=0, ctx=grouped) as svc:
        held = svc.submit(hold)
        assert started.wait(timeout=60)
        # rank 0 admits both after the thunk's first morsel (its turn), the
        # thunk still holding a slot: one slot left, no backlog
        kept, shed = svc.submit(mix(grouped)[1]), svc.submit(mix(grouped)[1])
        gate.set()
        with pytest.raises(AdmissionError):
            shed.result(timeout=60)
        kept.result(timeout=60)
    assert [h.state for h in (held, kept, shed)] == [QueryState.DONE, QueryState.DONE,
                                                       QueryState.FAILED]
