"""The paper's flagship workload on one card: the distributed hash-shuffle
JOIN of two uniformly random two-int32-column tables (paper §6: 90%
cardinality, ``configs.paper_cylon``'s 25M rows per worker) over P = 8
workers, run for real, beside the Hockney prediction of its two shuffles.

The reference (``launch/dryrun_ddf.py``) lowers the same join for a 256- or
512-chip TPU mesh and compares the prediction with the compiled
collectives' time over the interconnect. On one card the all-to-all is an
on-card transpose of the (P, P, quota) shuffle buffers, so the record sets
the prediction beside the device time of those transposes (timed with CUDA
events at the join's own buffer shapes) and beside the measured join:
``roofline_fraction = min(pred / t, t / pred)`` with t the transposes'
time. The memory term is ``op_cost``'s bytes over the card's HBM rate,
the hash_partition launches counted by their formula.

:func:`run_rank` is the per-rank dry run the reference's record is: the
same join for one rank's ``P / world`` workers on the ``meta`` device over
a dry mesh of ``world`` ranks (``mesh.make_dry_mesh``: stand-in groups),
whose exchanges allocate what the real ones return and move nothing. Its
record holds the exchanges' census (``collectives.per_op``: count and
bytes of each kind, the bytes each rank receives) and the rank's peak; no
card is needed.

Usage: python -m repro_torch.launch.dryrun_ddf [--rows-per-worker 25000000]
       python -m repro_torch.launch.dryrun_ddf --world 4 --rank 0   (no card)
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..configs.paper_cylon import CONFIG, CylonWorkload
from ..core.comm.communicator import make_communicator
from ..core.cost_model import CostParams, t_shuffle
from ..core.dataframe import Table, from_numpy
from ..core.operators import dist_join_shuffle
from ..core.partition import default_quota
from ..data.synthetic import uniform_table
from ..kernels import registry
from . import op_cost
from .dryrun import OUT_DIR, _save
from .mesh import make_dry_mesh, make_host_mesh
from .roofline import HW

__all__ = ["WORKERS", "paper_tables", "build_join", "predict", "run", "run_rank"]

WORKERS = 8  # the paper's P on one card


def paper_tables(P: int, workload: CylonWorkload = CONFIG) -> tuple[dict, dict]:
    """The two §6 tables, ``P * rows_per_worker`` rows each (seeds 1 and 2)."""
    n = P * workload.rows_per_worker
    return tuple(uniform_table(n, cardinality=workload.cardinality,
                               n_cols=workload.n_columns, seed=seed) for seed in (1, 2))


def build_join(left: dict, right: dict, P: int, device, quota: int | None = None,
               capacity_factor: float = 2.0):
    """(join function of the two tables, (left, right) tables, capacity per
    worker, quota): the tables on ``device`` at ``capacity_factor`` times
    their rows per worker; the function returns (joined table, overflow
    counters)."""
    rows = -(-len(left["c0"]) // P)
    cap = int(rows * capacity_factor)
    quota = quota or default_quota(cap, P)
    comm = make_communicator(P, device=device)
    lt = from_numpy({"k": left["c0"], "v": left["c1"]}, P, capacity=cap, device=device)
    rt = from_numpy({"k": right["c0"], "w": right["c1"]}, P, capacity=cap, device=device)
    return _join(comm, quota, 2 * cap), (lt, rt), cap, quota


def _join(comm, quota: int, cap_out: int):
    def join(lt, rt):
        return dist_join_shuffle(comm, lt, rt, ("k",), quota, cap_out)

    return join


def predict(rows_per_worker: int, P: int = WORKERS, quota: int | None = None,
            capacity_factor: float = 2.0, world: int | None = None, rank: int = 0,
            capacity: int | None = None) -> op_cost.Cost:
    """``op_cost`` of the same join on uninitialised tables on the meta
    device: its flops, bytes, collectives and the peak the card would hold
    (the tables resident). ``capacity`` (rows per worker) defaults to
    ``rows_per_worker * capacity_factor``. With ``world``, the join of
    rank ``rank``'s ``P / world`` workers over a dry mesh's stand-in group."""
    cap = capacity or int(rows_per_worker * capacity_factor)
    quota = quota or default_quota(cap, P)
    group = None if world is None else make_dry_mesh((world, 1), rank=rank).group
    local = P if world is None else P // world

    def table(*names):
        cols = {n: torch.empty((local, cap), dtype=torch.int32, device="meta") for n in names}
        return Table(cols, torch.empty((local,), dtype=torch.int32, device="meta"))

    join = _join(make_communicator(P, device="meta", group=group), quota, 2 * cap)
    return op_cost.analyze(join, table("k", "v"), table("k", "w"))


def run_rank(world: int, rank: int = 0, *, P: int = WORKERS,
             workload: CylonWorkload = CONFIG, quota: int | None = None,
             capacity_factor: float = 2.0, capacity: int | None = None, save: bool = True,
             verbose: bool = True, tag: str = "") -> dict:
    """The join's record for rank ``rank`` of ``world``, on the meta device
    (:func:`predict` over a stand-in group): the exchanges' census, the
    rank's peak and resident bytes, flops and bytes, and the collective
    term ``total_bytes / HW["ici_bw"]``."""
    rows = workload.rows_per_worker
    cap = capacity or int(rows * capacity_factor)
    quota = quota or default_quota(cap, P)
    cost = predict(rows, P, quota, capacity_factor, world=world, rank=rank, capacity=cap)
    coll = {"per_op": cost.collective_counts, "total_bytes": cost.collective_bytes,
            "total_count": sum(v["count"] for v in cost.collective_counts.values())}
    t_coll = cost.collective_bytes / HW["ici_bw"]
    t_mem = cost.bytes / HW["hbm_bw"]
    rec = {"arch": "cylon-join", "shape": f"weak_{rows / 1e6:g}M", "mesh": str(world),
           "rank": rank, "tag": tag, "status": "ok", "n_devices": world, "workers": P,
           "quota": quota, "capacity": cap, "rows_per_worker": rows,
           "memory": {"bytes_per_device": cost.peak_bytes, "peak_bytes": cost.peak_bytes,
                      "resident_bytes": cost.resident_bytes},
           "flops": cost.flops, "bytes_accessed": cost.bytes, "kernels": cost.kernels,
           "collectives": coll,
           "roofline": {"t_compute_s": cost.flops / HW["peak_flops"], "t_memory_s": t_mem,
                        "t_collective_s": t_coll,
                        "dominant": "collective" if t_coll > t_mem else "memory"}}
    if verbose:
        print(f"[dryrun-ddf] join P={P} x {rows} rows per worker, rank {rank} of {world} "
              f"(meta): peak {cost.peak_bytes / 2**30:.3f} GiB, collectives "
              f"{coll['per_op']} ({cost.collective_bytes:.3e} B, t_coll "
              f"{t_coll * 1e3:.3f} ms)")
    if save:
        _save_rank(rec)
    return rec


def _save_rank(rec: dict) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    name = f"cylon_join__{rec['shape']}__world{rec['mesh']}_rank{rec['rank']}{tag}.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(rec, f, indent=1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _event_ms(fn, device, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` runs after one warm-up:
    CUDA events on the card, the host clock elsewhere."""
    fn()
    _sync(device)
    if device.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(left: dict | None = None, right: dict | None = None, *, P: int = WORKERS,
        workload: CylonWorkload = CONFIG, device=None, params: CostParams | None = None,
        quota: int | None = None, capacity_factor: float = 2.0, iters: int = 3,
        save: bool = True, verbose: bool = True, tag: str = "") -> dict:
    """The join at ``workload``'s rows per worker on ``device`` (default: the
    card), once under ``op_cost`` with the launch counts at 0 just before
    it, then timed; ``left``/``right`` (numpy, as :func:`paper_tables`
    makes them) skip the table generation. The record's ``launches`` are
    the counted run's, and ``join_rows`` and ``overflow`` its result.
    ``params`` gives the Hockney profile (default ``CostParams()``, the
    card's ``DEVICE`` fit)."""
    mesh = make_host_mesh(device=device)
    device = mesh.devices[0]
    if left is None:
        left, right = paper_tables(P, workload)
    rows = -(-len(left["c0"]) // P)
    rec = {"arch": "cylon-join", "shape": f"weak_{rows / 1e6:g}M", "mesh": "1", "tag": tag,
           "device": mesh.kinds[0]}
    join, tables, cap, quota = build_join(left, right, P, device, quota, capacity_factor)
    _sync(device)
    base = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

    registry.reset_launch_counts()
    result = {}
    cost = op_cost.analyze(lambda lt, rt: result.update(out=join(lt, rt)), *tables)
    _sync(device)
    launches = registry.launch_counts()
    out, info = result.pop("out")
    join_rows = int(out.nvalid.sum())
    overflow = {k: int(v.sum()) for k, v in info.items()}
    del out, info
    join_ms = _event_ms(lambda: join(*tables), device, iters)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    predicted = predict(rows, P, quota, capacity_factor)

    # the shuffle's all-to-all: a transpose of each (P, P, quota) buffer of
    # both sides' columns and counts, made contiguous as the shuffle does
    bufs = [torch.zeros((P, P, quota), dtype=torch.int32, device=device) for _ in range(2)]
    transpose_ms = 2 * _event_ms(
        lambda: [b.transpose(0, 1).reshape(P, P * quota) for b in bufs], device, iters)
    del bufs

    params = params if params is not None else CostParams()
    n_bytes = rows * 8.0  # 2 x int32 per row
    pred = 2 * sum(t_shuffle(P, n_bytes, params))
    t_coll = transpose_ms * 1e-3
    t_mem = cost.bytes / HW["hbm_bw"]
    rec.update(
        status="ok", n_devices=mesh.size, workers=P, quota=quota, capacity=cap,
        rows_per_worker=rows,
        memory={"bytes_per_device": peak, "tracked_peak_bytes": cost.peak_bytes,
                "predicted_peak_bytes": predicted.peak_bytes,
                "predicted_resident_bytes": predicted.resident_bytes,
                "resident_bytes": cost.resident_bytes, "base_bytes": base},
        flops=cost.flops,
        bytes_accessed=cost.bytes,
        kernels=cost.kernels,
        launches=launches,
        join_rows=join_rows,
        overflow=overflow,
        join_ms=join_ms,
        transpose_ms=transpose_ms,
        collectives={"per_op": cost.collective_counts, "total_bytes": cost.collective_bytes},
        roofline={
            "t_compute_s": cost.flops / HW["peak_flops"],
            "t_memory_s": t_mem,
            "t_collective_s": t_coll,
            "dominant": "collective" if t_coll > t_mem else "memory",
            "hockney_predicted_shuffle_s": pred,
            "hockney_alpha_s": params.alpha,
            "hockney_beta_s_per_byte": params.beta,
            "model_flops_total": 0.0,
            "model_flops_per_chip": 0.0,
            "useful_flops_ratio": 0.0,
            "roofline_fraction": min(pred / t_coll, t_coll / pred) if t_coll > 0 else 0.0,
        },
    )
    if verbose:
        print(f"[dryrun-ddf] join P={P} x {rows} rows per worker on {mesh.kinds[0]}: "
              f"{join_rows} rows, join {join_ms:.1f} ms, transposes {transpose_ms:.2f} ms, "
              f"hockney_shuffle={pred * 1e3:.2f} ms, memory term {t_mem * 1e3:.2f} ms "
              f"({cost.bytes:.3e} B), launches {launches}, overflow {overflow}")
    if save:
        _save(rec)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-worker", type=int, default=CONFIG.rows_per_worker)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--quota", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=2.0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--world", type=int, default=None,
                    help="dry-run one rank's workers of a group of this many ranks on the "
                         "meta device (no card)")
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args()
    workload = CylonWorkload(rows_per_worker=args.rows_per_worker)
    if args.world is not None:
        run_rank(args.world, args.rank, workload=workload, quota=args.quota,
                 capacity_factor=args.capacity_factor, tag=args.tag)
        return
    run(workload=workload, device=args.device, quota=args.quota,
        capacity_factor=args.capacity_factor, tag=args.tag)


if __name__ == "__main__":
    main()
