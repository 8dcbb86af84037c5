"""The DDF over a process group: the cases each rank runs.

``tests/test_torch_distributed.py`` spawns gloo groups whose ranks run
:func:`rank_main`; it also runs :func:`pattern_cases` and :func:`io_cases`
in its own process on one device, and holds the two by bits.
``tests/test_torch_distributed_plans.py`` spawns ranks that run
:func:`plan_rank_main`: lazy plans, streamed queries (killed and resumed
too) and the query service. Nothing here imports jax or the reference
package, so the ranks start with the port alone. This module holds no
tests of its own.

Results are flattened into ``{key: numpy array}`` so that a rank can
write them to an ``.npz``: ``"<case>|<worker>|<column>"`` for the
live rows of each of the P workers, ``"<case>|info|<name>"`` for a per-worker
counter gathered over all P workers, ``"<case>|value|<name>"`` for a
scalar.
"""

from __future__ import annotations

import csv
import faulthandler
import glob
import os
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import DDF, DDFContext
from repro_torch.core import dataframe
from repro_torch.core.comm import channels, group
from repro_torch.core.dataframe import Table
from repro_torch.core.partition import hash_partition_ids
from repro_torch.data import read_csv_dist, uniform_table, write_csv_dist
from repro_torch.expr import col
from repro_torch.kernels import registry

P = 8
SLICE_AGGS = {"c1": ("sum", "min", "max", "count", "mean")}
SLICE_CASES = ("join", "groupby", "unique", "broadcast join", "chunked two-key join",
               "shuffle-compute groupby")
PATTERN_CASES = ("sort ascending", "sort descending", "sort float", "rebalance", "head",
                 "rolling sum", "rolling min", "rolling max", "rolling_sum", "transpose",
                 "length", "agg", "union", "difference", "string join", "native", "bruck",
                 "chunked shuffle", "narrow dtypes", "narrow unique", "communicator")
IO_CASES = ("io read", "io mapped", "io write")
GROUP_TIMEOUT_S = 60.0  # every collective of a rank gives up after this
BARRIER_SLEEP_S = 0.5  # rank 0 enters the timed barrier this late
ROWS_PER_WORKER = 40
WORDS = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen", "ibis"])


# -- results as flat numpy ---------------------------------------------------------

def _global(ctx: DDFContext, x: torch.Tensor) -> np.ndarray:
    """A per-worker tensor (local, ...) as all P workers' values."""
    return ctx.workers.gather_workers(x).cpu().numpy()


def _record(ctx, out: dict, case: str, ddf=None, info=None, **values) -> None:
    if ddf is not None:
        for w, part in enumerate(ddf.partitions()):
            for k, v in part.items():
                out[f"{case}|{w}|{k}"] = np.asarray(v)
    for k, v in (info or {}).items():
        out[f"{case}|info|{k}"] = _global(ctx, v)
    for k, v in values.items():
        out[f"{case}|value|{k}"] = np.asarray(v)


def _table_ddf(ctx, table: Table) -> DDF:
    return DDF(dict(table.columns), table.nvalid, ctx)


def partitions_of(flat: dict, case: str) -> list[dict]:
    """The P workers' live rows of ``case`` in a flattened result."""
    parts = [{} for _ in range(P)]
    for key, v in flat.items():
        c, w, name = (key.split("|") + ["", ""])[:3]
        if c == case and w.isdigit():
            parts[int(w)][name] = v
    return parts


def infos_of(flat: dict, case: str, kind: str = "info") -> dict:
    """The ``kind`` ("info" or "value") entries of ``case``."""
    out = {}
    for key, v in flat.items():
        parts = key.split("|")
        if len(parts) == 3 and parts[:2] == [case, kind]:
            out[parts[2]] = v
    return out


# -- the main slice, from the reference's layout -------------------------------------

def slice_cases(ctx: DDFContext, layout: dict) -> dict:
    """The slice of ``tests/test_torch_ddf.py`` from the reference's input
    layout (``left|<col>``, ``left|counts``, ``right|...``)."""

    def ddf(side):
        cols = {k.split("|")[1]: v for k, v in layout.items()
                if k.startswith(side + "|") and k != f"{side}|counts"}
        return DDF.from_partitions(cols, layout[f"{side}|counts"], ctx)

    out: dict = {}
    L, R = ddf("left"), ddf("right")
    group.reset_census()
    J, ji = L.join(R, on=("c0",), strategy="shuffle")
    for k, v in group.census().items():  # the join's exchanges alone
        out[f"join census|value|{k}"] = np.asarray([v["count"], v["bytes"]], dtype=np.int64)
    out["join census|value|capacity"] = np.asarray(L.capacity)
    _record(ctx, out, "join", J, ji)
    G, gi = J.groupby(("c0",), SLICE_AGGS, pre_combine=True)
    _record(ctx, out, "groupby", G, gi)
    U, ui = G.unique(("c0",))
    _record(ctx, out, "unique", U, ui)
    B, bi = L.join(R, on=("c0",), strategy="broadcast")
    _record(ctx, out, "broadcast join", B, bi)
    C, ci = L.join(R, on=("c0", "c1"), strategy="shuffle", num_chunks=3)
    _record(ctx, out, "chunked two-key join", C, ci)
    S, si = J.groupby(("c0",), SLICE_AGGS, pre_combine=False, num_chunks=2)
    _record(ctx, out, "shuffle-compute groupby", S, si)
    return out


# -- uint32 and vector columns, from the reference's layout --------------------------

COLTYPE_CASES = ("u32 join", "u32 groupby", "u32 sort asc", "u32 sort desc",
                 "u32 key sort desc", "u32 unique", "u32 union", "u32 difference",
                 "vec rebalance", "lazy u32 groupby", "lazy vec join")
COLTYPE_TABLES = ("ct left", "ct right", "ct other")
# eight uint32 keys, on both sides of 2**31, from 0 up to the type's max: a
# descending sort sends 0 to worker 0 (its negation wraps to 0), as the
# reference's range partition does
U32_KEYS = np.array([0, 5, 17, 2**31 - 1, 2**31, 2**31 + 7, 4_000_000_001, 2**32 - 1],
                    np.uint32)


def coltype_tables(rows: int, seed: int = 11) -> dict:
    """{table: numpy columns} of ``rows`` rows each: ``k`` draws from
    :data:`U32_KEYS` (``ct other`` from its first four, so that the
    difference keeps rows), ``u`` is uint32 over the whole range (sums
    wrap, half the values are at or above 2**31), ``vec`` (rows, 3)
    float32 and ``iv`` (rows, 2) int32 are vector columns."""
    rng = np.random.default_rng(seed)

    def keys(n_keys=len(U32_KEYS)):
        return U32_KEYS[rng.integers(0, n_keys, rows)]

    def u32():
        return rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)

    def vec():
        return rng.standard_normal((rows, 3)).astype(np.float32)

    return {"ct left": {"k": keys(), "u": u32(), "vec": vec()},
            "ct right": {"k": keys(), "iv": rng.integers(-9, 9, (rows, 2)).astype(np.int32)},
            "ct other": {"k": keys(4), "u": u32(), "vec": vec()}}


def coltype_results(L, R, O) -> dict:
    """{case: (DDF, counters)} of every column-type case on the DDFs of
    :func:`coltype_tables` (``L``, ``R``, ``O``), for either package's
    DDFs: the calls are the same."""
    return {
        "u32 join": L.join(R, on=("k",), strategy="shuffle"),
        "u32 groupby": L.groupby(("k",), {"u": ("sum", "min", "max")}),
        "u32 sort asc": L.sort_values("u"),
        "u32 sort desc": L.sort_values("u", descending=True),
        "u32 key sort desc": L.sort_values("k", descending=True),
        "u32 unique": L.unique(("k",)),
        "u32 union": L.union(O, on=("k",)),
        "u32 difference": L.difference(O, on=("k",)),
        "vec rebalance": L.rebalance(),
        "lazy u32 groupby": (L.lazy().groupby(("k",), {"u": ("sum", "max")}).collect(), {}),
        "lazy vec join": (L.lazy().join(R.lazy(), on=("k",), strategy="shuffle").collect(),
                          {}),
    }


COLTYPE_ROWS_PER_WORKER = 60


def reference_coltypes(ref_ddf, rctx, nworkers: int) -> tuple[dict, dict]:
    """(input layout, flat results) of the reference's column-type cases:
    ``ref_ddf`` and ``rctx`` are the reference's ``DDF`` class and a
    context over ``nworkers`` devices (passed in, so that this module
    imports no jax). Counters are flattened to (P, -1), as the ranks
    gather theirs."""
    tabs = coltype_tables(nworkers * COLTYPE_ROWS_PER_WORKER)
    layout, refs = {}, []
    for name in COLTYPE_TABLES:
        d = ref_ddf.from_numpy(tabs[name], rctx, capacity=COLTYPE_ROWS_PER_WORKER + 5,
                               mode="eager")
        refs.append(d)
        layout.update({f"{name}|{k}": np.asarray(v) for k, v in d.columns.items()})
        layout[f"{name}|counts"] = np.asarray(d.counts)
    out = {}
    for case, (d, info) in coltype_results(*refs).items():
        counts = np.asarray(d.counts)
        for k, v in d.columns.items():
            v = np.asarray(v).reshape((nworkers, -1) + v.shape[1:])
            for w in range(nworkers):
                out[f"{case}|{w}|{k}"] = v[w, : counts[w]]
        out.update({f"{case}|info|{k}": np.asarray(v).reshape(nworkers, -1)
                    for k, v in info.items()})
    return layout, out


def coltype_mismatches(got: dict, exp: dict, case: str) -> list[str]:
    """The keys of ``case`` whose dtype, shape or bytes differ between two
    flat results (the port's counters reshaped to the reference's)."""
    keys = {k for k in set(got) | set(exp) if k.split("|")[0] == case}
    bad = []
    for k in sorted(keys):
        if k not in got or k not in exp:
            bad.append(f"{k}: only in {'port' if k in got else 'reference'}")
            continue
        g, e = got[k], exp[k]
        if "|info|" in k and g.size == e.size:
            g = g.reshape(e.shape)
        if g.dtype != e.dtype or g.shape != e.shape or g.tobytes() != e.tobytes():
            bad.append(f"{k}: {g.dtype}{g.shape} {g.ravel()[:4]} vs "
                       f"{e.dtype}{e.shape} {e.ravel()[:4]}")
    return bad


def coltype_cases(ctx: DDFContext, layout: dict) -> dict:
    """The column-type cases from the reference's input layout
    (``"<table>|<col>"`` and ``"<table>|counts"`` for each of
    :data:`COLTYPE_TABLES`)."""

    def ddf(name):
        cols = {k.split("|")[1]: v for k, v in layout.items()
                if k.startswith(name + "|") and k != f"{name}|counts"}
        return DDF.from_partitions(cols, layout[f"{name}|counts"], ctx)

    out: dict = {}
    for case, (d, info) in coltype_results(*map(ddf, COLTYPE_TABLES)).items():
        _record(ctx, out, case, d, info)
    return out


# -- the other collectives ---------------------------------------------------------

def _tables(seed: int = 5):
    rng = np.random.default_rng(seed)
    n = P * ROWS_PER_WORKER

    def table(words):
        f = (rng.integers(-200, 200, n) / 4).astype(np.float32)
        f[rng.integers(0, n, 3)] = -0.0
        return {"k": rng.integers(0, n // 3, n).astype(np.int32),
                "v": rng.integers(-1000, 1000, n).astype(np.int32),
                "f": f, "s": words[rng.integers(0, len(words), n)]}

    left, right = table(WORDS[:6]), table(WORDS[3:])
    nan = np.float32(np.nan)
    left["g"] = left["f"].copy()
    left["g"][[7, 190]] = [nan, -nan]  # NaNs of both signs, on two workers
    narrow = {"h": rng.integers(-300, 300, n).astype(np.int16),
              "b": rng.random(n) < 0.5,
              "q": rng.integers(-100, 100, n).astype(np.int8),
              "e": (rng.integers(-50, 50, n) / 8).astype(np.float16)}
    return left, right, narrow


def pattern_cases(ctx: DDFContext) -> dict:
    """The eager DDF's other cross-worker steps and the Communicator's
    collectives on seeded tables, as flat numpy."""
    left, right, narrow = _tables()
    out: dict = {}
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)

    for case, kw in (("sort ascending", {}), ("sort descending", {"descending": True})):
        S, si = L.sort_values("v", **kw)
        _record(ctx, out, case, S, si)
    S, si = L.sort_values("g")  # NaNs of both signs
    _record(ctx, out, "sort float", S, si)
    few = L.select(col("v") > 600)  # a skewed layout to even out
    B, bi = few.rebalance()
    _record(ctx, out, "rebalance", B, bi)
    _record(ctx, out, "head", L.head(ROWS_PER_WORKER * 2 + 3))
    for op in ("sum", "min", "max"):
        W, wi = L.rolling("v", 5, op=op)
        _record(ctx, out, f"rolling {op}", W, wi)
    W, wi = L.rolling_sum("f", 3)
    _record(ctx, out, "rolling_sum", W, wi)
    small = DDF.from_numpy({"a": np.arange(2 * P, dtype=np.int32),
                            "b": np.linspace(-1, 1, 2 * P).astype(np.float32)}, ctx)
    _record(ctx, out, "transpose", small.transpose())
    _record(ctx, out, "length", length=L.length())
    aggs = {f"{c}_{op}": L.agg(c, op) for c in ("v", "f", "g")
            for op in ("sum", "min", "max", "mean", "count")}
    aggs.update({f"s_{op}": np.array(L.agg("s", op)) for op in ("min", "max")})
    _record(ctx, out, "agg", **aggs)
    Un, ui = L.project(["k", "s"]).union(R.project(["k", "s"]), on=("k",))
    _record(ctx, out, "union", Un, ui)
    D, di = L.difference(R, on=("k",))
    _record(ctx, out, "difference", D, di)
    # three shared words of about 53 rows a side: up to 8,400 rows on a worker
    Js, jsi = L.join(R.rename({"v": "v2", "f": "f2", "k": "k2"}), on=("s",),
                     strategy="shuffle", quota=L.capacity, capacity=9000)
    _record(ctx, out, "string join", Js, jsi, vocab=np.array(Js.vocabs["s"].words))

    comm = ctx.comm()
    T = L.project(["k", "v", "g"]).table()
    dest = hash_partition_ids(T, ["k"], P)
    quota = T.capacity
    native, nov = comm.shuffle(T, dest, quota)
    bruck, bov = comm.shuffle(T, dest, quota, algorithm="bruck")
    _record(ctx, out, "bruck", _table_ddf(ctx, bruck), {"overflow": bov})
    _record(ctx, out, "native", _table_ddf(ctx, native), {"overflow": nov})
    chunked, cov = comm.shuffle(T, dest, 7, num_chunks=3)  # a tight quota: overflow counts
    _record(ctx, out, "chunked shuffle", _table_ddf(ctx, chunked), {"overflow": cov})

    N = DDF.from_numpy({**narrow, "k": left["k"]}, ctx)
    Nj, nji = N.join(N.project(["h", "b"]).rename({"b": "b2"}), on=("h",),
                     strategy="shuffle", capacity=4 * N.capacity)
    _record(ctx, out, "narrow dtypes", Nj, nji)
    Nu, nui = N.unique(("h", "b"))
    _record(ctx, out, "narrow unique", Nu, nui)

    x = torch.arange(ctx.workers.lo * 16, ctx.workers.hi * 16, dtype=torch.int32,
                     device=ctx.device).reshape(-1, 16) * 7 - 500
    sc, sov = comm.scatter(T, root=3)
    _record(ctx, out, "communicator",
            info={"broadcast_k": comm.broadcast(T, root=5).columns["k"],
                  "broadcast_g": comm.broadcast(T, root=5).columns["g"],
                  "gather_n": comm.gather(T, root=6).nvalid,
                  "gather_k": comm.gather(T, root=6).columns["k"],
                  "allgather_v": comm.allgather(T).columns["v"],
                  "scatter_k": sc.columns["k"], "scatter_n": sc.nvalid, "scatter_ov": sov,
                  "allreduce_sum": comm.allreduce(x), "allreduce_min": comm.allreduce(x, "min"),
                  "reduce_scatter": comm.reduce_scatter(x),
                  "allgather_array": comm.allgather_array(x),
                  "allgather_tiled": comm.allgather_array(x, tiled=True),
                  "shift": comm.shift(x, 3), "shift_back": comm.shift(x, -1),
                  "halo_left": comm.halo_exchange(x, -x)[0],
                  "halo_right": comm.halo_exchange(x, -x)[1],
                  "send_recv": channels.send_recv(x, [(0, 5), (5, 0), (2, 3), (7, 6)],
                                                  workers=comm.workers),
                  "rank": comm.rank()})
    comm.barrier()
    return out


# -- partitioned I/O and the barrier ---------------------------------------------------

IO_SCHEMA = {"k": np.int32, "f": np.float32, "s": "dict"}


def write_io_inputs(directory: str) -> list[str]:
    """Five CSV files of uneven sizes (one empty) whose words differ from
    file to file, so that no rank's own files give the whole vocabulary."""
    rng = np.random.default_rng(11)
    os.makedirs(directory, exist_ok=True)
    files = []
    for i, n in enumerate((9, 0, 23, 4, 13)):
        path = os.path.join(directory, f"in{i}.csv")
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["k", "f", "s"])
            for _ in range(n):
                wr.writerow([rng.integers(-40, 40), rng.integers(-8, 8) * 0.25,
                             WORDS[(i + rng.integers(0, 3)) % len(WORDS)]])
        files.append(path)
    return files


def io_cases(ctx: DDFContext, in_dir: str, out_dir: str) -> dict:
    """``read_csv_dist`` round-robin and through an uneven mapping (its
    capacity set by a worker of another rank), and every file that
    ``write_csv_dist`` wrote, as bytes."""
    files = sorted(os.path.join(in_dir, f) for f in os.listdir(in_dir))
    out: dict = {}
    d = read_csv_dist(files, IO_SCHEMA, ctx)
    _record(ctx, out, "io read", d, vocab=np.array(d.vocabs["s"].words))
    m = read_csv_dist(files, IO_SCHEMA, ctx, mapping={P - 1: files[:3], 2: files[3:]})
    R, ri = m.rebalance()
    _record(ctx, out, "io mapped", R, ri, capacity=m.capacity,
            vocab=np.array(m.vocabs["s"].words))
    written = write_csv_dist(d, out_dir)
    assert len(written) == ctx.workers.local, written
    ctx.comm().barrier()  # every rank's files are whole before any is read
    for w in range(P):
        with open(os.path.join(out_dir, f"part-{w:05d}.csv"), "rb") as f:
            out[f"io write|value|{w}"] = np.frombuffer(f.read(), np.uint8)
    return out


def barrier_case(ctx: DDFContext) -> dict:
    """Each worker's (enter, exit) wall time of a barrier that rank 0
    enters ``BARRIER_SLEEP_S`` late, gathered over all P workers."""
    comm = ctx.comm()
    comm.barrier()
    if ctx.workers.rank == 0:
        time.sleep(BARRIER_SLEEP_S)
    enter = time.time()
    comm.barrier()
    leave = time.time()
    t = torch.tensor([[enter, leave]] * ctx.workers.local, dtype=torch.float64,
                     device=ctx.device)
    return {"barrier|value|times": _global(ctx, t)}


# -- what a group refuses -------------------------------------------------------------

def refusal_cases(ctx: DDFContext) -> dict:
    """The exception type and message of each refusal, as values."""
    world = ctx.workers.world
    out: dict = {}

    def refused(name, fn):
        try:
            fn()
        except (ValueError, NotImplementedError, RuntimeError) as e:
            out[f"refusal|value|{name}"] = np.array(f"{type(e).__name__}: {e}")
        else:
            out[f"refusal|value|{name}"] = np.array("not refused")

    refused("indivisible", lambda: DDFContext(nworkers=world + 1, device="cpu",
                                              group=ctx.group))
    return out


# -- the layers a group once refused: a lazy plan, mode="lazy", a scan ----------

LAYER_CASES = ("lazy", "mode lazy", "scan")


def write_layer_dataset(directory: str) -> str:
    """The small dataset :func:`layer_cases` scans."""
    from repro_torch.data import write_dataset

    rng = np.random.default_rng(7)
    n = 6 * P + 5
    write_dataset({"k": rng.integers(0, 9, n).astype(np.int32),
                   "v": rng.integers(-50, 50, n).astype(np.int32)}, directory, chunk_rows=13)
    return directory


def _record_info(out: dict, case: str, info: dict) -> None:
    """Counters of a lazy or streamed run, which are every worker's already:
    arrays as ``info``, the batch and chunk counts as values."""
    for k, v in (info or {}).items():
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        if isinstance(v, np.ndarray) and v.ndim:
            out[f"{case}|info|{k}"] = v
        elif k in ("batches", "chunks_decoded", "chunks_skipped"):
            out[f"{case}|value|{k}"] = np.asarray(v)


def layer_cases(ctx: DDFContext, ds_dir: str) -> dict:
    """``DDF.lazy()``, ``from_numpy(mode="lazy")`` and ``scan_dataset`` on
    seeded data, as flat numpy: what a group refused before it ran them."""
    from repro_torch.stream import scan_dataset

    out: dict = {}
    data = {"k": np.arange(4 * P + 3, dtype=np.int32) % 5,
            "v": np.arange(4 * P + 3, dtype=np.int32) * 3 - 40}
    lz = DDF.from_numpy(data, ctx).lazy().groupby(("k",), {"v": ("sum", "max")})
    _record(ctx, out, "lazy", lz.collect())
    _record_info(out, "lazy", lz.last_info)
    ml = DDF.from_numpy(data, ctx, mode="lazy").select(col("v") > 0).unique(("k",))
    _record(ctx, out, "mode lazy", ml.collect())
    _record_info(out, "mode lazy", ml.last_info)
    sc = scan_dataset(ds_dir, ctx, batch_rows=2 * P).groupby(("k",), {"v": ("sum", "count")})
    _record(ctx, out, "scan", sc.collect_stream())
    _record_info(out, "scan", sc.last_info)
    return out


THREAD_JOIN_S = 30.0  # a rank's threads must end within this after its work


def start_rank(out_dir: str, rank: int):
    """Every thread's Python stack to ``out_dir/rank<r>.stacks`` should the
    rank die on a signal (an abort, a segfault): the file the spawn's
    error then quotes. Returns the open file, which outlives the rank's
    work."""
    f = open(os.path.join(out_dir, f"rank{rank}.stacks"), "w")
    faulthandler.enable(file=f, all_threads=True)
    return f


def end_rank() -> None:
    """The end of a rank's work, before it leaves the group: every rank has
    finished its collectives (a barrier), and no other thread of this
    process still runs (each joined; one still running raises, naming it),
    so that no thread is inside torch or gloo code while the interpreter
    shuts down."""
    dist.barrier()
    others = [t for t in threading.enumerate()
              if t is not threading.main_thread() and not isinstance(t, threading._DummyThread)]
    for t in others:
        t.join(THREAD_JOIN_S)
    alive = [t.name for t in others if t.is_alive()]
    if alive:
        raise RuntimeError(f"threads still running at the rank's end: {alive}")


def rank_stacks(out_dir: str) -> str:
    """The stacks that ranks dying on a signal left under ``out_dir``."""
    out = []
    for path in sorted(glob.glob(os.path.join(out_dir, "rank*.stacks"))):
        with open(path) as f:
            text = f.read()
        if text:
            out.append(f"{os.path.basename(path)}:\n{text}")
    return "\n".join(out)


def spawn(fn, args: tuple, nprocs: int, timeout_s: float, out_dir: str | None = None) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; raises when one
    raises, and kills them all past ``timeout_s``. A failure quotes the
    stacks that ranks dying on a signal left in ``out_dir``."""
    pc = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not pc.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks ran past {timeout_s} s")
    except Exception as e:
        stacks = rank_stacks(out_dir) if out_dir is not None else ""
        if not stacks:
            raise
        raise RuntimeError(f"{e}\n{stacks}") from e
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def rank_main(rank: int, world: int, store: str, layout_path: str, out_dir: str) -> None:
    """One rank of a gloo group of ``world``: every case over
    ``DDFContext(nworkers=P, device="cpu", group=WORLD)``, written to
    ``out_dir/rank<r>.npz``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    stacks = start_rank(out_dir, rank)
    group.init_from_env(device="cpu", timeout=GROUP_TIMEOUT_S, init_method=f"file://{store}")
    try:
        ctx = DDFContext(nworkers=P, device="cpu", group=dist.group.WORLD)
        assert ctx.workers.local == P // world and ctx.workers.rank == rank
        with np.load(layout_path) as z:
            layout = {k: z[k] for k in z.files}
        out = {**slice_cases(ctx, layout), **coltype_cases(ctx, layout),
               **pattern_cases(ctx), **refusal_cases(ctx),
               **layer_cases(ctx, os.path.join(out_dir, "layer_ds")),
               **io_cases(ctx, os.path.join(out_dir, "csv_in"),
                          os.path.join(out_dir, "csv_out")),
               **barrier_case(ctx)}
        out["modules|value|jax"] = np.array(
            sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")),
            dtype=str)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        end_rank()
    finally:
        group.close()
        stacks.close()


# -- on the card: one NCCL rank ------------------------------------------------------------

def uniform_layout(rows_per_worker: int) -> dict:
    """The paper's tables (cardinality 0.9, seeds 1 and 2) at P workers, as
    the global layout ``slice_cases`` reads."""
    out = {}
    for side, seed in (("left", 1), ("right", 2)):
        t = dataframe.from_numpy(uniform_table(P * rows_per_worker, 0.9, seed=seed), P,
                                 device="cpu")
        out.update({f"{side}|{k}": v.reshape(-1).numpy() for k, v in t.columns.items()})
        out[f"{side}|counts"] = t.nvalid.numpy()
    return out


def card_rank_main(rank: int, store: str, out_path: str, rows_per_worker: int) -> None:
    """A one-rank NCCL group on cuda:0 running the slice over
    ``DDFContext(nworkers=P, group=WORLD)``; the launch counts are values of
    the case "launches"."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="1", LOCAL_RANK=str(rank))
    group.init_from_env(timeout=GROUP_TIMEOUT_S, init_method=f"file://{store}")
    try:
        ctx = DDFContext(nworkers=P, group=dist.group.WORLD)
        assert ctx.device == torch.device("cuda", 0), ctx.device
        registry.reset_launch_counts()
        out = slice_cases(ctx, uniform_layout(rows_per_worker))
        out.update({f"launches|value|{k}": np.array(v)
                    for k, v in registry.launch_counts().items()})
        np.savez(out_path, **out)
    finally:
        group.close()


# -- lazy plans, streamed queries and the service over a group ------------------------

PLAN_ROWS_PER_WORKER, PLAN_CARDINALITY = 150, 0.5  # uniform_table(8 * 150, 0.5, seed=1/2)
STREAM_CHUNK_ROWS = 170  # chunk edges that do not line up with the batches'
STREAM_BATCH_ROWS = 280  # 5 batches of the 1,200 rows
STREAM_BATCHES = 5
CARD_BATCH_ROWS = 4000  # 4 batches of the card test's 16,000 rows
STREAM_AGGS = {"c1": ("sum", "min", "max", "count", "mean")}
STREAM_KEYS = 40
LAZY_CASES = ("lazy readme", "lazy unique", "lazy sort")
STREAM_CASES = ("stream groupby", "stream unique", "stream sort", "stream spill join")
PORT_STREAM_CASES = ("stream to_batches", "stream scan_csv")
KILL_CASES = ("groupby", "sort")
SERVICE_QUERIES = ("scan1", "lazy1", "scan2", "lazy2", "sort", "select")
SERVICE_SLEEP_S = 0.3  # rank 1 waits this long before each submit
SERVICE_TIMEOUT_S = 120.0
SELECT_BELOW = 2**21


def _chip_smoke():
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def lazy_queries(L, R, X, readme) -> dict:
    """The lazy cases over (L, R) of either package (``X`` its expression
    module, ``readme`` its README pipeline: ``chip_smoke._lazy_steps`` here)."""
    return {"lazy readme": readme(L, R),
            "lazy unique": L.lazy().unique(("c0",)),
            "lazy sort": L.lazy().select(X.col("c1") < 2**30).sort_values("c1")}


def stream_queries(S, X, ctx, left_dir: str, right_dir: str) -> dict:
    """The streamed cases of either package (``S`` its stream module, ``X``
    its expression module) over the left and right tables' chunked
    datasets. The groupby and unique key ``c0 % STREAM_KEYS``: at 280 rows
    a batch, ``c0``'s 600 keys would overflow a batch's partial groups."""
    def scan(d):
        return S.scan_dataset(d, ctx, batch_rows=STREAM_BATCH_ROWS)

    def keyed(d):
        return scan(d).with_column("k", X.col("c0") % STREAM_KEYS)

    return {"stream groupby": keyed(left_dir).groupby(("k",), STREAM_AGGS),
            "stream unique": keyed(left_dir).unique(("k",)),
            "stream sort": scan(left_dir).sort_values("c1"),
            "stream spill join": scan(left_dir).join(scan(right_dir), on=("c0",))}


def record_parts(out: dict, case: str, parts: list, info=None) -> None:
    """Per-worker live rows ``parts`` and a run's ``info`` under ``case``."""
    for w, part in enumerate(parts):
        for k, v in part.items():
            out[f"{case}|{w}|{k}"] = np.asarray(v)
    _record_info(out, case, info)


def _plan_inputs(ctx, layout: dict):
    def ddf(side):
        cols = {k.split("|")[1]: v for k, v in layout.items()
                if k.startswith(side + "|") and k != f"{side}|counts"}
        return DDF.from_partitions(cols, layout[f"{side}|counts"], ctx)

    return ddf("left"), ddf("right")


def plan_lazy_cases(ctx: DDFContext, layout: dict) -> dict:
    """The lazy cases from the reference's input layout, by ``collect()``."""
    from repro_torch import expr

    L, R = _plan_inputs(ctx, layout)
    out: dict = {}
    for case, q in lazy_queries(L, R, expr, _chip_smoke()._lazy_steps).items():
        record_parts(out, case, q.collect().partitions(), q.last_info)
    q = _chip_smoke()._lazy_steps(L, R)
    out["explain|value|lazy readme"] = np.array(q.explain())  # from global row counts
    q.collect(profile=True)  # tracing: the observed rows are every worker's
    out["traced|value|lazy rows"] = np.array(
        [-1 if r.observed_rows is None else r.observed_rows for r in q.last_profile.records])
    return out


def plan_stream_cases(ctx: DDFContext, data_dir: str) -> dict:
    """The streamed cases, ``to_batches`` of a scan's EP part and a
    streamed ``scan_csv`` (rank 0 converts into a temporary directory)."""
    from repro_torch import expr, stream
    from repro_torch.expr import col

    left, right = os.path.join(data_dir, "left"), os.path.join(data_dir, "right")
    out: dict = {}
    for case, q in stream_queries(stream, expr, ctx, left, right).items():
        record_parts(out, case, q.collect_stream().partitions(), q.last_info)
    ep = stream.scan_dataset(left, ctx, batch_rows=STREAM_BATCH_ROWS).select(col("c1") < 2**30)
    for i, b in enumerate(ep.to_batches()):
        for k, v in b.items():
            out[f"stream to_batches|value|{i}{k}"] = v
    sc = stream.scan_csv([os.path.join(data_dir, "left.csv")], {"c0": np.int32, "c1": np.int32},
                         ctx, batch_rows=STREAM_BATCH_ROWS)
    sc = sc.with_column("k", col("c0") % STREAM_KEYS).groupby(("k",), STREAM_AGGS)
    record_parts(out, "stream scan_csv", sc.collect_stream().partitions(), sc.last_info)
    from repro_torch import obs

    with obs.profiled() as prof:
        stream_queries(stream, expr, ctx, left, right)["stream groupby"].collect_stream()
    # sorted: the decode records come from the prefetch thread, in any order
    out["traced|value|stream rows"] = np.sort(np.array(
        [-1 if r.observed_rows is None else r.observed_rows for r in prof.records]))
    return out


def blind_scan_case(ctx: DDFContext, csv_path: str, work: str) -> dict:
    """``scan_csv`` into a relative directory from a working directory of
    each rank's own: rank 0 converts into its own, the other ranks cannot
    see it, and every rank raises."""
    here = os.getcwd()
    mine = os.path.join(work, f"cwd{ctx.workers.rank}")
    os.makedirs(mine, exist_ok=True)
    os.chdir(mine)
    try:
        from repro_torch.stream import scan_csv

        scan_csv([csv_path], {"c0": np.int32, "c1": np.int32}, ctx, directory="converted")
        msg = "not refused"
    except RuntimeError as e:
        msg = f"{type(e).__name__}: {e}"
    finally:
        os.chdir(here)
    return {"blind scan|value|error": np.array(msg),
            "broadcast|value|ints": np.array(ctx.workers.broadcast_ints(
                [10 * ctx.workers.rank + 1, -7, 2**40]))}


class _Writes:
    """The files this process writes under ``root`` through numpy's savez and
    the manifests it saves, and each ``StreamCheckpoint.save``'s step."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.files: list[str] = []
        self.saves: list[int] = []

    def __enter__(self):
        from repro_torch.data.dataset import DatasetManifest
        from repro_torch.stream.checkpoint import StreamCheckpoint

        self._undo = []

        def patch(owner, name, wrap):
            orig = getattr(owner, name)
            setattr(owner, name, wrap(orig))
            self._undo.append((owner, name, orig))

        def note(path):
            path = os.path.abspath(str(path))
            if path.startswith(self.root):
                self.files.append(os.path.relpath(path, self.root))

        for name in ("savez", "savez_compressed"):
            patch(np, name, lambda f: lambda file, *a, **k: (note(file), f(file, *a, **k))[1])
        patch(DatasetManifest, "save", lambda f: lambda m: (note(os.path.join(
            m.directory, "manifest.json")), f(m))[1])
        patch(StreamCheckpoint, "save", lambda f: lambda st, step, *a, **k: (
            self.saves.append(int(step)), f(st, step, *a, **k))[1])
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def kill_cases(ctx: DDFContext, data_dir: str, work: str, resume_dir: str | None = None) -> dict:
    """Each of the streamed groupby and sort (its spill under the checkpoint
    store) killed at device_op 2 of 5 with a snapshot every 2 morsels, then
    resumed, beside its uninterrupted run; the killed run's store is copied
    (``<work>/<case>-kept``) before the resume clears it. With
    ``resume_dir`` each also resumes from ``<resume_dir>/<case>-kept``, a
    snapshot of another world. Every rank records the files it wrote and
    its ``StreamCheckpoint.save`` steps."""
    import shutil

    from repro_torch import expr, stream
    from repro_torch.stream import StreamCheckpoint
    from repro_torch.testing import FaultPlan, InjectedFault, fault_scope

    left = os.path.join(data_dir, "left")
    blk = ctx.workers
    queries = {"groupby": lambda: stream_queries(stream, expr, ctx, left, left)["stream groupby"],
               "sort": lambda: stream.scan_dataset(left, ctx, batch_rows=STREAM_BATCH_ROWS)
               .sort_values("c1")}
    out: dict = {}
    for case, q in queries.items():
        ck = os.path.join(work, f"{case}-ckpt")
        lz = q()
        record_parts(out, f"kill {case} whole", lz.collect_stream().partitions(), lz.last_info)
        with _Writes(work) as killed:
            try:
                with fault_scope(FaultPlan(kill_after={"device_op": STREAM_BATCHES // 2})):
                    q().collect_stream(checkpoint_dir=ck, checkpoint_every=2)
                died = False
            except InjectedFault:
                died = True
        blk.barrier()
        if blk.rank == 0:
            shutil.copytree(ck, os.path.join(work, f"{case}-kept"))
        blk.barrier()
        with _Writes(work) as resumed:
            lz = q()
            got = lz.collect_stream(checkpoint_dir=ck, checkpoint_every=2, resume=True)
        record_parts(out, f"kill {case} resumed", got.partitions(), lz.last_info)
        out[f"kill {case}|value|died"] = np.array(died)
        out[f"kill {case}|value|kept"] = np.array(StreamCheckpoint(
            os.path.join(work, f"{case}-kept")).steps(), dtype=np.int64)
        out[f"kill {case}|value|left"] = np.array(os.listdir(ck), dtype=str)
        for run, w in (("killed", killed), ("resumed", resumed)):
            out[f"kill {case}|value|{run} files"] = np.array(w.files, dtype=str)
            out[f"kill {case}|value|{run} saves"] = np.array(w.saves, dtype=np.int64)
        if resume_dir is not None:
            mine = os.path.join(work, f"{case}-other")
            if blk.rank == 0:
                shutil.copytree(os.path.join(resume_dir, f"{case}-kept"), mine)
            blk.barrier()
            lz = q()
            got = lz.collect_stream(checkpoint_dir=mine, checkpoint_every=2, resume=True)
            record_parts(out, f"kill {case} other world", got.partitions(), lz.last_info)
    return out


def service_cases(ctx: DDFContext, data_dir: str, layout: dict) -> dict:
    """Two streamed groupbys, two README lazy pipelines, an eager sort and a
    scan-free select: each alone over the group, then all through one
    ``QueryService(policy="fair", max_running=2, ctx=ctx)`` to which rank 1
    submits ``SERVICE_SLEEP_S`` late each time; then, under round robin, a
    scan cancelled after its first morsel while two thunks hold the
    scheduler around it."""
    import threading

    from repro_torch import expr, stream
    from repro_torch.expr import col
    from repro_torch.service import QueryCancelled, QueryService

    L, R = _plan_inputs(ctx, layout)
    left = os.path.join(data_dir, "left")
    readme = _chip_smoke()._lazy_steps

    def scan():
        return stream_queries(stream, expr, ctx, left, left)["stream groupby"]

    def sort():
        return L.sort_values("c1")[0]

    def build():
        return {"scan1": scan(), "lazy1": readme(L, R), "scan2": scan(), "lazy2": readme(L, R),
                "sort": sort, "select": L.lazy().select(col("c1") < SELECT_BELOW)}

    out: dict = {}
    for name, q in build().items():
        res = q() if callable(q) else (q.collect_stream() if q._scans else q.collect())
        record_parts(out, f"service {name} serial", res.partitions())
    late = SERVICE_SLEEP_S if ctx.workers.rank == 1 else 0.0
    queries = build()
    with QueryService(policy="fair", max_running=2, ctx=ctx) as svc:
        handles = {}
        for name, q in queries.items():
            time.sleep(late)
            handles[name] = svc.submit(q, label=name)
        results = {name: h.result(timeout=SERVICE_TIMEOUT_S) for name, h in handles.items()}
    stats = svc.stats()["scheduler"]
    for name, res in results.items():
        record_parts(out, f"service {name}", res.partitions())
    out["service|value|states"] = np.array([h.state for h in handles.values()], dtype=str)
    out["service|value|turns_total"] = np.array(stats["turns_total"])
    out["service|value|morsels_total"] = np.array(stats["morsels_total"])
    out["service|value|morsels"] = np.array([h.morsels for h in handles.values()])

    gates = [(threading.Event(), threading.Event()) for _ in range(2)]

    def holder(i):
        def hold():  # holds the scheduler thread until this rank opens its gate
            gates[i][1].set()
            gates[i][0].wait(timeout=SERVICE_TIMEOUT_S)
        return hold

    with QueryService(policy="round_robin", max_running=3, ctx=ctx) as svc:
        h0 = svc.submit(holder(0), label="hold0")
        gates[0][1].wait(timeout=SERVICE_TIMEOUT_S)
        hs = svc.submit(scan(), label="cancelled")  # both arrive while hold0 runs:
        h1 = svc.submit(holder(1), label="hold1")   # scan runs one morsel, then hold1
        gates[0][0].set()
        gates[1][1].wait(timeout=SERVICE_TIMEOUT_S)
        svc.cancel(hs.qid)
        gates[1][0].set()
        try:
            hs.result(timeout=SERVICE_TIMEOUT_S)
            cancelled = False
        except QueryCancelled:
            cancelled = True
        for h in (h0, h1):
            h.result(timeout=SERVICE_TIMEOUT_S)
    out["service cancel|value|raised"] = np.array(cancelled)
    out["service cancel|value|states"] = np.array([hs.state, h0.state, h1.state], dtype=str)
    out["service cancel|value|morsels"] = np.array(hs.morsels)
    out["service cancel|value|turns_total"] = np.array(svc.stats()["scheduler"]["turns_total"])
    return out


def plan_rank_main(rank: int, world: int, store: str, layout_path: str, out_dir: str,
                   full: bool) -> None:
    """One rank of a gloo group of ``world`` over ``DDFContext(nworkers=P,
    device="cpu", group=WORLD)``: the lazy cases, and with ``full`` the
    streamed, kill and service cases, written to ``out_dir/rank<r>.npz``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    stacks = start_rank(out_dir, rank)
    group.init_from_env(device="cpu", timeout=GROUP_TIMEOUT_S, init_method=f"file://{store}")
    try:
        ctx = DDFContext(nworkers=P, device="cpu", group=dist.group.WORLD)
        with np.load(layout_path) as z:
            layout = {k: z[k] for k in z.files}
        data_dir = os.path.dirname(layout_path)
        out = plan_lazy_cases(ctx, layout)
        if full:
            work = os.path.join(out_dir, "work")
            out.update(plan_stream_cases(ctx, data_dir))
            out.update(kill_cases(ctx, data_dir, work, resume_dir=os.path.join(out_dir, "one")))
            out.update(service_cases(ctx, data_dir, layout))
            out.update(blind_scan_case(ctx, os.path.join(data_dir, "left.csv"), work))
        out["modules|value|jax"] = np.array(
            sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")),
            dtype=str)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        end_rank()
    finally:
        group.close()
        stacks.close()


def card_plan_cases(ctx: DDFContext, layout: dict, data_dir: str) -> dict:
    """The README lazy pipeline on ``layout`` and a streamed groupby (4
    batches) of ``data_dir/left``, as flat numpy with their counters and
    the launch counts of each (values of "launches lazy" / "launches
    stream")."""
    from repro_torch import expr, stream

    L, R = _plan_inputs(ctx, layout)
    out: dict = {}
    registry.reset_launch_counts()
    q = _chip_smoke()._lazy_steps(L, R)
    record_parts(out, "card lazy", q.collect().partitions(), q.last_info)
    out.update({f"launches lazy|value|{k}": np.array(v)
                for k, v in registry.launch_counts().items()})
    registry.reset_launch_counts()
    s = stream.scan_dataset(os.path.join(data_dir, "left"), ctx, batch_rows=CARD_BATCH_ROWS)
    s = s.with_column("k", expr.col("c0") % STREAM_KEYS).groupby(("k",), STREAM_AGGS)
    record_parts(out, "card stream", s.collect_stream().partitions(), s.last_info)
    out.update({f"launches stream|value|{k}": np.array(v)
                for k, v in registry.launch_counts().items()})
    return out



def card_plan_rank_main(rank: int, store: str, out_path: str, layout_path: str,
                        data_dir: str) -> None:
    """A one-rank NCCL group on cuda:0 running :func:`card_plan_cases` over
    ``DDFContext(nworkers=P, group=WORLD)``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="1", LOCAL_RANK=str(rank))
    group.init_from_env(timeout=GROUP_TIMEOUT_S, init_method=f"file://{store}")
    try:
        ctx = DDFContext(nworkers=P, group=dist.group.WORLD)
        assert ctx.device == torch.device("cuda", 0), ctx.device
        with np.load(layout_path) as z:
            layout = {k: z[k] for k in z.files}
        np.savez(out_path, **card_plan_cases(ctx, layout, data_dir))
    finally:
        group.close()
