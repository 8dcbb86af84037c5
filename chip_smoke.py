#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--rows-per-worker N] [--profile PATH]

1. Builds the Hopper kernels of ``src/repro_torch/csrc`` (nvcc, sm_90a).
2. Drives the port's main path at the paper's configuration (§6: uniform
   int32 tables of cardinality 0.9, two columns, seeds 1 and 2, 8 workers):
   ``DDF.from_numpy`` -> ``join(on=("c0",), strategy="shuffle")`` ->
   ``groupby(("c0",), {"c1": (sum, min, max, count, mean)}, pre_combine=True)``
   -> ``unique(("c0",))``, with every launch count at 0 just before it, and
   holds the result against a numpy oracle that never materialises the join.
3. Calls each kernel's wrapper at the shapes the main path gave it, and at a
   ragged row count, and holds it against its plain PyTorch version:
   hashes, destinations, histograms, integer sums and min/max must be
   identical, float sums exact on integer-valued inputs.
4. Fits the on-card all-to-all (a transpose) to Hockney (alpha, beta).
5. With ``--profile``, runs the main path once more under ``torch.profiler``
   and reports device time by kernel and the device's idle share.

Prints the card's name and power limit, a ``kernels`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and the
exit code is not 0. Needs one CUDA device and this script's repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PAPER_ROWS_PER_WORKER = 25_000_000  # benchmarks/bench_scaling.py weak-scaling unit
DEFAULT_ROWS_PER_WORKER = 12_500_000
WORKERS = 8  # the paper's P for the main path


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> float:
    import torch

    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
        a = a.to(torch.int64) & 0xFFFFFFFF
        b = b.to(torch.int64) & 0xFFFFFFFF
    if a.dtype.is_floating_point:
        return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0.0


def require_equal(a, b, what: str) -> float:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    same = torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.dtype == torch.uint32 \
        else torch.equal(a, b)
    err = max_abs_err(a, b)
    if not same:
        raise AssertionError(f"{what}: kernel and plain version differ (max abs err {err})")
    return err


# -- main path ------------------------------------------------------------------

def numpy_oracle(left, right, n_keys):
    """Per key: the join count cntL * cntR and the groupby of the left values
    over the join rows (sum = sumL * cntR wrapped to int32; min / max of the
    left values; mean = float32(sum) / float32(count))."""
    kl, vl = left["c0"].astype(np.int64), left["c1"]
    kr = right["c0"].astype(np.int64)
    cnt_l = np.bincount(kl, minlength=n_keys)
    cnt_r = np.bincount(kr, minlength=n_keys)
    sum_l = np.bincount(kl, weights=vl.astype(np.float64), minlength=n_keys).astype(np.int64)
    min_l = np.full(n_keys, np.iinfo(np.int32).max, np.int32)
    max_l = np.full(n_keys, np.iinfo(np.int32).min, np.int32)
    np.minimum.at(min_l, kl, vl)
    np.maximum.at(max_l, kl, vl)
    keys = np.nonzero((cnt_l > 0) & (cnt_r > 0))[0]
    count = (cnt_l[keys] * cnt_r[keys]).astype(np.int32)
    s = (sum_l[keys] * cnt_r[keys]).astype(np.int32)  # wraps like the engine
    return {
        "c0": keys.astype(np.int32),
        "c1_sum": s,
        "c1_min": min_l[keys],
        "c1_max": max_l[keys],
        "c1_count": count,
        "c1_mean": s.astype(np.float32) / count.astype(np.float32),
        "join_rows": int((cnt_l * cnt_r).sum()),
    }


def check_against_oracle(got: dict, exp: dict, what: str) -> None:
    order = np.argsort(got["c0"], kind="stable")
    for k in got:
        g = got[k][order]
        e = exp[k]
        if g.shape != e.shape or g.dtype != e.dtype or not np.array_equal(g, e):
            bad = np.nonzero(g != e)[0][:5] if g.shape == e.shape else []
            raise AssertionError(f"{what}.{k}: {g.dtype}{g.shape} vs oracle "
                                 f"{e.dtype}{e.shape}; first mismatches at {bad}")


def run_main_path(P: int, rows_per_worker: int, shapes: dict):
    import torch

    from repro_torch.core import DDF, DDFContext
    from repro_torch.data import uniform_table
    from repro_torch.kernels import registry

    n = P * rows_per_worker
    t0 = time.perf_counter()
    left = uniform_table(n, cardinality=0.9, n_cols=2, seed=1)
    right = uniform_table(n, cardinality=0.9, n_cols=2, seed=2)
    log(f"main path: P={P}, {rows_per_worker} rows per worker, {n} rows per side "
        f"(data {time.perf_counter() - t0:.1f} s)")
    ctx = DDFContext(nworkers=P)
    torch.cuda.reset_peak_memory_stats()
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return out

    registry.reset_launch_counts()
    shapes.clear()
    L = timed("from_numpy_left", lambda: DDF.from_numpy(left, ctx))
    R = timed("from_numpy_right", lambda: DDF.from_numpy(right, ctx))
    J, jinfo = timed("join", lambda: L.join(R, on=("c0",), strategy="shuffle"))
    del L, R
    aggs = {"c1": ("sum", "min", "max", "count", "mean")}
    G, ginfo = timed("groupby", lambda: J.groupby(("c0",), aggs, pre_combine=True))
    join_rows = J.num_rows()
    del J
    U, uinfo = timed("unique", lambda: G.unique(("c0",)))
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for name, t in times.items():
        log(f"  {name:18s} {t * 1e3:10.1f} ms")
    log(f"  launches on the main path: {launches}")
    log(f"  peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")
    for k, v in {**jinfo, **ginfo, **{f"unique_{k}": v for k, v in uinfo.items()}}.items():
        tot = int(v.sum().item())
        if tot != 0:
            raise AssertionError(f"overflow counter {k} = {tot}")
    log("  every overflow counter is 0")

    t = time.perf_counter()
    exp = numpy_oracle(left, right, max(int(n * 0.9), 1))
    if join_rows != exp["join_rows"]:
        raise AssertionError(f"join rows {join_rows} vs oracle {exp['join_rows']}")
    g = G.to_numpy()
    check_against_oracle(g, {k: v for k, v in exp.items() if k != "join_rows"}, "groupby")
    u = U.to_numpy()
    if set(u) != {"c0", "c1_sum", "c1_min", "c1_max", "c1_count", "c1_mean"}:
        raise AssertionError(f"unique columns {sorted(u)}")
    if not np.array_equal(np.sort(u["c0"]), exp["c0"]):
        raise AssertionError("unique keys differ from the oracle's")
    log(f"  join rows {join_rows}, groups {len(g['c0'])}, unique {len(u['c0'])}: "
        f"equal to the numpy oracle (checked in {time.perf_counter() - t:.1f} s)")
    for k in ("c1_sum", "c1_min", "c1_max", "c1_count", "c1_mean"):
        if not np.all(np.isfinite(g[k].astype(np.float64))):
            raise AssertionError(f"{k} has non-finite values")
    del G, U
    return {"rows_per_worker": rows_per_worker, "workers": P, "times_s": times,
            "launches": launches, "peak_bytes": peak, "join_rows": join_rows,
            "groups": int(len(g["c0"]))}


# -- kernel phase -----------------------------------------------------------------

def record_shapes(shapes: dict):
    """Wrap the kernel launchers the dispatch wrappers call, to record the
    shapes the main path gives them."""
    from repro_torch.kernels import ops

    hp, sr = ops.hash_partition_cuda, ops.segment_reduce_cuda

    def hash_rec(keys, num_partitions, with_hist=True):
        shapes.setdefault("hash_partition", set()).add(
            (tuple(keys.shape), num_partitions))
        return hp(keys, num_partitions, with_hist=with_hist)

    def seg_rec(values, seg_ids, num_segments, op="sum"):
        shapes.setdefault("segment_reduce", set()).add(
            (tuple(values.shape), num_segments, op, str(values.dtype)))
        return sr(values, seg_ids, num_segments, op)

    ops.hash_partition_cuda, ops.segment_reduce_cuda = hash_rec, seg_rec
    return lambda: (setattr(ops, "hash_partition_cuda", hp),
                    setattr(ops, "segment_reduce_cuda", sr))


def hash_phase(main_shapes, gen):
    """Every (rows, key columns) shape of the main path, plus two key
    columns and a ragged row count; timed at the largest shape."""
    import torch

    from repro_torch.kernels import ops

    (n, n_cols), P = max(main_shapes, key=lambda s: s[0][0])
    cases = sorted({shape for shape, _ in main_shapes} | {(n, 2), (n + 13, 1), (1, 1)})
    rec, max_err = None, 0.0
    for rows, cols in cases:
        keys = torch.randint(-2**31, 2**31 - 1, (rows, cols), dtype=torch.int32,
                             device="cuda", generator=gen)
        edge = torch.tensor([-1, 0, 2**31 - 1, -2**31, 1, -2, 7, 12345], dtype=torch.int32,
                            device="cuda")
        keys[: min(8, rows)] = edge[: min(8, rows), None]
        d_k, h_k = ops.hash_partition(keys, P, force="cuda", with_hist=True)
        d_p, h_p = ops.hash_partition(keys, P, force="torch", with_hist=True)
        err = max(require_equal(d_k, d_p, f"hash dest {rows}x{cols}"),
                  require_equal(h_k, h_p, f"hash hist {rows}x{cols}"))
        d_only, h_none = ops.hash_partition(keys, P, force="cuda", with_hist=False)
        err = max(err, require_equal(d_only, d_p, f"hash dest-only {rows}x{cols}"))
        if h_none is not None:
            raise AssertionError("hash_partition(with_hist=False) returned a histogram")
        line = f"  hash_partition {rows}x{cols} P={P}: identical to the plain version"
        if (rows, cols) == (n, n_cols):
            ms = cuda_time_ms(lambda: ops.hash_partition(keys, P, force="cuda", with_hist=False))
            hist_ms = cuda_time_ms(lambda: ops.hash_partition(keys, P, force="cuda"))
            plain_ms = cuda_time_ms(lambda: ops.hash_partition(keys, P, force="torch",
                                                               with_hist=False), iters=3)
            bound_ms = rows * (4 * cols + 4) / HBM_BYTES_PER_S * 1e3
            rec = {"name": "hash_partition", "route": "cuda",
                   "source": "src/repro_torch/csrc/hash_partition.cu",
                   "replaces": "src/repro/kernels/hash_partition.py:86",
                   "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
                   "shape": [rows, cols], "num_partitions": P,
                   "hist_replaces": "src/repro/kernels/hash_partition.py:96",
                   "hist_ms": hist_ms}
            line += (f"; kernel {ms:.4f} ms (with hist {hist_ms:.4f}), plain {plain_ms:.3f} ms,"
                     f" bound {bound_ms:.4f} ms")
        max_err = max(max_err, err)
        log(line)
    rec["max_abs_err"] = max_err
    return rec


def _segments(rows: int, nseg: int, P: int, gen):
    """Dense sorted segment ids shaped like the groupby's: per worker, runs
    of about 1.1 rows over the first three quarters of its rows and the
    rest in its invalid bucket, offset by worker; a ragged tail goes to the
    last bucket."""
    import torch

    per, nseg_w = rows // P, nseg // P
    new = torch.rand((P, per), device="cuda", generator=gen) < 0.9
    new[:, 0] = True
    gid = torch.cumsum(new.to(torch.int32), dim=1, dtype=torch.int32) - 1
    gid[:, (per * 3) // 4:] = nseg_w - 1
    gid = torch.clamp(gid, max=nseg_w - 1)
    offs = torch.arange(P, dtype=torch.int32, device="cuda")[:, None] * nseg_w
    seg = (gid + offs).reshape(-1)
    tail = torch.full((rows - P * per,), nseg - 1, dtype=torch.int32, device="cuda")
    return torch.cat([seg, tail])


def segment_phase(main_shapes, P, gen):
    """Every (rows, width, segments) shape of the main path and a ragged row
    count, in int32 and integer-valued float32, for sum, min and max; timed
    (and held against ``scatter_reduce_``) at the largest shape."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_reduce import identity

    (n, width), nseg, _, _ = max(main_shapes, key=lambda s: s[0][0])
    cases = sorted({(shape, ns) for shape, ns, _, _ in main_shapes} | {((n + 13, width), nseg)})
    rec, max_err = None, 0.0
    for (rows, w), ns in cases:
        seg = _segments(rows, ns, P, gen)
        for dtype in (torch.int32, torch.float32):
            if dtype == torch.int32:
                vals = torch.randint(-2**31, 2**31 - 1, (rows, w), dtype=torch.int32,
                                     device="cuda", generator=gen)
            else:  # integer-valued: float sums are exact in any order
                vals = torch.randint(-1000, 1000, (rows, w), device="cuda",
                                     generator=gen).to(torch.float32)
            for op in ("sum", "min", "max"):
                k = ops.segment_reduce(vals, seg, ns, op=op, force="cuda")
                p = ops.segment_reduce(vals, seg, ns, op=op, force="torch")
                err = require_equal(k, p, f"segment_reduce {op} {dtype} {rows}x{w}")
                line = (f"  segment_reduce {op:3s} {str(dtype):13s} {rows}x{w} "
                        f"nseg={ns}: identical to the plain version")
                if (rows, w, ns) == (n, width, nseg) and dtype == torch.int32 and op == "sum":
                    ms = cuda_time_ms(lambda: ops.segment_reduce(vals, seg, ns, op=op,
                                                                 force="cuda"))
                    plain_ms = cuda_time_ms(lambda: ops.segment_reduce(
                        vals, seg, ns, op=op, force="torch"), iters=3)
                    ids = seg.to(torch.int64)[:, None].expand(-1, w)

                    def library():
                        out = torch.full((ns, w), identity(op, dtype), dtype=dtype,
                                         device="cuda")
                        return out.scatter_reduce_(0, ids, vals, reduce="sum",
                                                   include_self=True)

                    require_equal(k, library(), "segment_reduce vs scatter_reduce_")
                    library_ms = cuda_time_ms(library)
                    bound_ms = (rows * (4 * w + 4) + ns * w * 4) / HBM_BYTES_PER_S * 1e3
                    rec = {"name": "segment_reduce", "route": "cuda",
                           "source": "src/repro_torch/csrc/segment_reduce.cu",
                           "replaces": "src/repro/kernels/segment_reduce.py:89",
                           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": "bytes",
                           "library_ms": library_ms, "shape": [rows, w],
                           "num_segments": ns, "op": op, "dtype": "int32"}
                    line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                             f"scatter_reduce_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms")
                max_err = max(max_err, err)
                log(line)
    rec["max_abs_err"] = max_err
    return rec


# -- profile ---------------------------------------------------------------------------

def profile_main_path(P: int, rows_per_worker: int, path: str) -> None:
    """The main path once more under ``torch.profiler``: device time by
    kernel and the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DDF, DDFContext
    from repro_torch.data import uniform_table

    n = P * rows_per_worker
    left = uniform_table(n, cardinality=0.9, n_cols=2, seed=1)
    right = uniform_table(n, cardinality=0.9, n_cols=2, seed=2)
    ctx = DDFContext(nworkers=P)
    aggs = {"c1": ("sum", "min", "max", "count", "mean")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()  # inside: the profiler's start-up is not counted
        L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
        J, _ = L.join(R, on=("c0",), strategy="shuffle")
        del L, R
        G, _ = J.groupby(("c0",), aggs, pre_combine=True)
        del J
        G.unique(("c0",))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    log(f"profile of the main path: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / wall_us:.3f} ({path})")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  {e.key[:90]}")


# -- fabric fit -----------------------------------------------------------------------

def fabric_fit(P: int):
    """Time the on-card all-to-all (transpose of (P, P, quota) int32
    buffers) at two sizes; Hockney alpha [s] and beta [s per payload byte]."""
    import torch

    pts = []
    for quota in (1 << 12, 1 << 20):
        x = torch.zeros((P, P, quota), dtype=torch.int32, device="cuda")
        ms = cuda_time_ms(lambda: x.transpose(0, 1).contiguous(), iters=20)
        pts.append((x.numel() * 4, ms * 1e-3))
        log(f"  transpose of ({P}, {P}, {quota}) int32: {ms:.5f} ms")
    (b1, t1), (b2, t2) = pts
    beta = (t2 - t1) / (b2 - b1)
    alpha = t1 - beta * b1
    return alpha, beta


# -------------------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-per-worker", type=int, default=DEFAULT_ROWS_PER_WORKER)
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile the main path and write the table to PATH")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is not in {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import cuda_lib, registry

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t = time.perf_counter()
    cuda_lib.load()
    info = cuda_lib.build_info()
    log(f"kernel build: {time.perf_counter() - t:.1f} s (nvcc {info['seconds']:.1f} s, "
        f"built={info['built']})")
    for src, out in info["log"].items():
        lines = out.splitlines()
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in lines if "Used" in ln and "registers" in ln})
        spills = any("spill stores" in ln and "0 bytes spill stores" not in ln for ln in lines)
        log(f"  {src}: ptxas {', '.join(regs)}; spills: {'yes' if spills else 'none'}")

    shapes: dict = {}
    restore = record_shapes(shapes)
    cut = (f"rows per worker {args.rows_per_worker} of the paper's "
           f"{PAPER_ROWS_PER_WORKER} (the static-quota layout's peak memory at 25M "
           f"does not fit the card)") if args.rows_per_worker < PAPER_ROWS_PER_WORKER else "none"
    log(f"cut: {cut}")
    main_res = run_main_path(WORKERS, args.rows_per_worker, shapes)
    restore()
    for name in registry.KERNEL_OPS:
        if main_res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log("  main-path kernel shapes: " + json.dumps(
        {k: sorted(map(str, v)) for k, v in shapes.items()}))
    torch.cuda.empty_cache()

    log("kernel phase (each kernel against its plain version on the card):")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    recs = [hash_phase(shapes["hash_partition"], gen),
            segment_phase(shapes["segment_reduce"], WORKERS, gen)]
    for r in recs:
        r["launches"] = main_res["launches"][r["name"]]

    log("fabric fit (on-card all-to-all):")
    alpha, beta = fabric_fit(WORKERS)
    log(f"  DEVICE fabric on {smi}: alpha={alpha:.3e} s, beta={beta:.3e} s/byte "
        f"({1 / beta / 1e9 if beta > 0 else float('inf'):.1f} GB/s of payload)")

    if args.profile:
        torch.cuda.empty_cache()
        profile_main_path(WORKERS, args.rows_per_worker, args.profile)

    log(json.dumps({"main_path": main_res, "cut": cut}))
    log(json.dumps({"kernels": recs}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
