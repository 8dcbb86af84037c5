"""The eager DDF over a process group: the cases each rank runs.

``tests/test_torch_distributed.py`` spawns gloo groups whose ranks run
:func:`rank_main`; it also runs :func:`pattern_cases` and :func:`io_cases`
in its own process on one device, and holds the two by bits. Nothing here
imports jax or the reference package, so the ranks start with the port
alone. This module holds no tests of its own.

Results are flattened into ``{key: numpy array}`` so that a rank can
write them to an ``.npz``: ``"<case>|<worker>|<column>"`` for the
live rows of each of the P workers, ``"<case>|info|<name>"`` for a per-worker
counter gathered over all P workers, ``"<case>|value|<name>"`` for a
scalar.
"""

from __future__ import annotations

import csv
import os
import sys
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
    J, ji = L.join(R, on=("c0",), strategy="shuffle")
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

    from repro_torch.stream import scan_dataset

    d = DDF.from_numpy({"k": np.arange(4 * P, dtype=np.int32)}, ctx)
    refused("indivisible", lambda: DDFContext(nworkers=world + 1, device="cpu",
                                              group=ctx.group))
    refused("lazy", d.lazy)
    refused("mode lazy", lambda: DDF.from_numpy({"k": np.arange(3, dtype=np.int32)}, ctx,
                                                mode="lazy"))
    refused("scan", lambda: scan_dataset("no-such-dataset", ctx))
    return out


def spawn(fn, args: tuple, nprocs: int, timeout_s: float) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes; raises when one
    raises, and kills them all past ``timeout_s``."""
    pc = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not pc.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks ran past {timeout_s} s")
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
    group.init_from_env(device="cpu", timeout=GROUP_TIMEOUT_S, init_method=f"file://{store}")
    try:
        ctx = DDFContext(nworkers=P, device="cpu", group=dist.group.WORLD)
        assert ctx.workers.local == P // world and ctx.workers.rank == rank
        with np.load(layout_path) as z:
            layout = {k: z[k] for k in z.files}
        out = {**slice_cases(ctx, layout), **pattern_cases(ctx), **refusal_cases(ctx),
               **io_cases(ctx, os.path.join(out_dir, "csv_in"),
                          os.path.join(out_dir, "csv_out")),
               **barrier_case(ctx)}
        out["modules|value|jax"] = np.array(
            sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")),
            dtype=str)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        group.close()


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
