#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--rows-per-worker N] [--profile PATH]

1. Builds the Hopper kernels of ``src/repro_torch/csrc`` (nvcc, sm_90a) and
   reports, for the tensor-core kernels (bf16 flash attention, the SSD
   scan's passes), registers, shared memory and spills from the build log
   and their HGMMA (wgmma) and HMMA (mma.sync) instructions from
   ``cuobjdump -sass`` where it exists; a kernel meant for the tensor cores
   without them fails the run.
2. Drives the port's main path at the paper's configuration (§6: uniform
   int32 tables of cardinality 0.9, two columns, seeds 1 and 2, 8 workers):
   ``DDF.from_numpy`` -> ``join(on=("c0",), strategy="shuffle")`` ->
   ``groupby(("c0",), {"c1": (sum, min, max, count, mean)}, pre_combine=True)``
   -> ``unique(("c0",))``, with every launch count at 0 just before it, and
   holds the result against a numpy oracle that never materialises the join.
3. Calls each kernel's wrapper at the shapes the main path gave it, and at a
   ragged row count, and holds it against its plain PyTorch version:
   hashes, destinations, histograms, integer sums and min/max must be
   identical, float sums exact on integer-valued inputs. segment_reduce is
   also held, bit for bit, in every value dtype it takes (bool, int8,
   uint8, int16, float16 besides int32, uint32, float32) with +-0, NaN
   and +-inf in the floats, and is timed per op (int32 sum, min, max;
   float32 min, max), at width 2, and at every main-path launch's shape,
   with the second pass (long empty runs, segments across tiles) split
   out by the profiler.
4. Fits the on-card all-to-all (a transpose) to Hockney (alpha, beta).
5. Frees the dataframe path's memory and drives the LM serving path at the
   full width of zamba2-1.2b (38 layers, d_model 2048, vocab 32000, bf16,
   random weights from a seeded generator): ``make_prefill`` on 4 x 4096
   tokens, which must launch ``ssd_scan`` 38 times and ``flash_attention``
   6 times, then ``ServeEngine.generate`` on 4 prompts.
6. Holds the full-width model in float32 (2 x 256 tokens) to itself: the
   kernel path's logits against the plain versions' and against
   token-by-token decode.
7. Calls the two model kernels at the shapes the prefill gave them, at a
   ragged length and at other configurations' shapes (gemma2-9b and
   olmo-1b attention; ssd_scan at G = 2, ds = 128, chunks 64 and 256), held
   against their plain versions, and times each beside its bound, its plain
   version and, for attention, ``scaled_dot_product_attention`` as a
   yardstick the port never calls, with the achieved TFLOP/s.
8. With ``--profile``, runs the dataframe main path, one bf16 prefill and
   15 decode steps once more under ``torch.profiler`` and reports device
   time by kernel and the device's idle share.

Prints the card's name and power limit, a ``kernels`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and the
exit code is not 0. Needs one CUDA device and this script's repository.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, bf16 dense
PAPER_ROWS_PER_WORKER = 25_000_000  # benchmarks/bench_scaling.py weak-scaling unit
DEFAULT_ROWS_PER_WORKER = 12_500_000
WORKERS = 8  # the paper's P for the main path
DATAFRAME_KERNELS = ("hash_partition", "segment_reduce")
# device-side names of the port's kernels (segment_reduce runs segment_tiles
# then segment_finish; ssd_scan its three passes)
PORT_KERNELS = ("hash_dest", "segment_tiles", "segment_finish", "flash_",
                "ssd_chunk_state", "ssd_state_passing", "ssd_chunk_scan")
MODEL_SEED = 1


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
    """Bit for bit (the sign of zero included; NaNs by position); returns
    the largest difference elsewhere."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    if a.dtype.is_floating_point:
        nan = a.isnan()
        ints = {torch.float32: torch.int32, torch.float16: torch.int16}[a.dtype]
        same = torch.equal(nan, b.isnan()) and torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])
        a, b = a[~nan], b[~nan]
    elif a.dtype == torch.uint32:
        same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    else:
        same = torch.equal(a, b)
    err = max_abs_err(a, b)
    if not same:
        raise AssertionError(f"{what}: kernel and plain version differ (max abs err {err})")
    return err


# -- build report -----------------------------------------------------------------

# the bf16 flash kernel and the SSD scan's three passes
REPORTED_KERNELS = ("flash_bf16_kernel", "ssd_chunk_state", "ssd_state_passing", "ssd_chunk_scan")


def _kernel_id(mangled: str):
    """'flash_bf16_kernel<64>' for a mangled name of one of
    REPORTED_KERNELS, else None."""
    for k in REPORTED_KERNELS:
        i = mangled.find(k)
        if i >= 0:
            m = re.match(r"I((?:Li-?\d+E)+)E", mangled[i + len(k):])
            args = re.findall(r"Li(-?\d+)E", m.group(1)) if m else []
            return f"{k}<{', '.join(args)}>" if args else k
    return None


def ptxas_report(logs: dict) -> dict:
    """Registers, static shared memory and spill bytes of each instance of
    REPORTED_KERNELS, from nvcc's -Xptxas -v output per source."""
    rows, cur = {}, None
    for out in logs.values():
        for ln in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                cur = _kernel_id(m.group(1))
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                rows.setdefault(cur, {})["spills"] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                smem = re.search(r"(\d+) bytes smem", ln)
                rows.setdefault(cur, {}).update(
                    registers=int(m.group(1)), static_smem=int(smem.group(1)) if smem else 0)
                cur = None
    return rows


def _cuobjdump():
    exe = shutil.which("cuobjdump")
    if exe:
        return exe
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    try:
        import triton

        cand.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                                 "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cand if os.path.exists(c)), None)


def sass_report(lib_path: str):
    """Tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) of each
    instance of REPORTED_KERNELS in the built library's SASS, or None
    where cuobjdump is missing."""
    exe = _cuobjdump()
    if exe is None:
        return None
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                         check=True).stdout
    counts, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = _kernel_id(m.group(1))
            if cur is not None:
                counts[cur] = {"HGMMA": 0, "HMMA": 0, "forms": set()}
            continue
        if cur is not None:
            m = re.search(r"\b(HGMMA|HMMA)(\.\S*)?", ln)
            if m:
                counts[cur][m.group(1)] += 1
                counts[cur]["forms"].add(m.group(0))
    return counts


def build_report(lib, info: dict) -> dict:
    """Log registers, shared memory and spills of REPORTED_KERNELS and their
    tensor-core instructions in SASS; fail if a kernel meant for the tensor
    cores has none there."""
    regs = ptxas_report(info["log"])
    dynamic = {"flash_bf16_kernel<64>": lib.flash_attention_smem_bytes(64, 1),
               "flash_bf16_kernel<128>": lib.flash_attention_smem_bytes(128, 1),
               "flash_bf16_kernel<256>": lib.flash_attention_smem_bytes(256, 1),
               "ssd_chunk_state<64, 64>": lib.ssd_scan_smem_bytes(64, 64, 256, 1),
               "ssd_chunk_scan<64, 64>": lib.ssd_scan_smem_bytes(64, 64, 256, 3),
               "ssd_state_passing": 0}
    sass = sass_report(info["path"])
    for name in sorted(regs):
        r = regs[name]
        line = (f"  {name}: {r.get('registers')} registers, shared memory {r.get('static_smem')} "
                f"bytes static")
        if name in dynamic:
            line += f" + {dynamic[name]} dynamic (flash: per head_dim; ssd: ds 64, chunk 256)"
        line += f", spills {r.get('spills', [0, 0])[0]} / {r.get('spills', [0, 0])[1]} bytes"
        if sass is not None and name in sass:
            c = sass[name]
            line += (f"; SASS {c['HGMMA']} HGMMA, {c['HMMA']} HMMA"
                     f" ({', '.join(sorted(c['forms'])) or 'none'})")
        log(line)
    if sass is None:
        log("  cuobjdump not found: SASS not inspected")
    else:
        for name, c in sass.items():
            if c["HGMMA"] + c["HMMA"] == 0 and not name.startswith("ssd_state_passing"):
                raise AssertionError(f"{name} issues no tensor-core instruction")
            if name.startswith(("flash_bf16_kernel", "ssd_chunk_scan")) and c["HGMMA"] == 0:
                raise AssertionError(f"{name} issues no wgmma (HGMMA)")
    return {"ptxas": regs, "dynamic_smem": dynamic,
            "sass": None if sass is None else
            {k: {"HGMMA": v["HGMMA"], "HMMA": v["HMMA"]} for k, v in sass.items()}}


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

    fa, ssd = ops.flash_attention_cuda, ops.ssd_scan_cuda

    def flash_rec(q, k, v, **kw):
        shapes.setdefault("flash_attention", set()).add(
            (tuple(q.shape), k.shape[2], str(q.dtype), kw.get("causal", True),
             kw.get("window"), kw.get("softcap"), kw.get("scale")))
        return fa(q, k, v, **kw)

    def ssd_rec(x, dt, A, B, C, D, *, chunk):
        shapes.setdefault("ssd_scan", set()).add(
            (tuple(x.shape), tuple(B.shape), chunk, str(x.dtype)))
        return ssd(x, dt, A, B, C, D, chunk=chunk)

    ops.hash_partition_cuda, ops.segment_reduce_cuda = hash_rec, seg_rec
    ops.flash_attention_cuda, ops.ssd_scan_cuda = flash_rec, ssd_rec
    return lambda: (setattr(ops, "hash_partition_cuda", hp),
                    setattr(ops, "segment_reduce_cuda", sr),
                    setattr(ops, "flash_attention_cuda", fa),
                    setattr(ops, "ssd_scan_cuda", ssd))


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


SEG_NARROW = ("bool", "int8", "uint8", "int16", "float16")
SEG_SMALL_ROWS = 100_003  # the narrow-dtype and NaN / +-0 cases


def _special_values(dtype, op, shape, gen):
    """Values of every dtype the kernel takes: full-range integers, bools,
    integer-valued floats (float16 sums far inside +-2048) with +-0, NaN and
    +-inf sprinkled in."""
    import torch

    if dtype == torch.bool:
        return torch.rand(shape, device="cuda", generator=gen) < 0.5
    if not dtype.is_floating_point:
        ii = torch.iinfo(dtype)
        return torch.randint(ii.min, ii.max + 1, shape, device="cuda", generator=gen).to(dtype)
    if dtype == torch.float16 and op == "sum":
        v = torch.randint(-2, 3, shape, device="cuda", generator=gen).float()
        v *= torch.rand(shape, device="cuda", generator=gen) < 0.05
    else:
        v = torch.randint(-1000, 1000, shape, device="cuda", generator=gen).float()
    r = torch.rand(shape, device="cuda", generator=gen)
    v[r < 0.05] = 0.0
    v[(r >= 0.05) & (r < 0.1)] = -0.0
    v[(r >= 0.1) & (r < 0.101)] = float("nan")
    v[(r >= 0.101) & (r < 0.102)] = float("inf")
    v[(r >= 0.102) & (r < 0.103)] = float("-inf")
    return v.to(dtype)


def device_ms_by_kernel(fn, iters: int = 5) -> dict:
    """Device time per call of each kernel (and memset) ``fn`` launches, from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.self_device_time_total > 0}


def segment_phase(main_shapes, P, gen):
    """Every (rows, width, segments) shape of the main path and a ragged row
    count, in int32 and integer-valued float32, for sum, min and max, held
    against the plain version; at the largest shape, int32 sum, min and max,
    float32 min and max and int32 sum at width 2 timed beside their bound,
    the second pass (long empty runs) split out by the profiler, and int32
    sum held against ``scatter_reduce_``; every main-path launch timed at
    its shape; the narrow dtypes and NaN / +-0 floats at a small shape."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_reduce import identity

    (n, width), nseg, _, _ = max(main_shapes, key=lambda s: s[0][0])
    cases = sorted({(shape, ns) for shape, ns, _, _ in main_shapes} | {((n + 13, width), nseg)})
    rec, max_err, op_ms = None, 0.0, {}
    launch_ms = []
    for (rows, w), ns in cases:
        seg = _segments(rows, ns, P, gen)
        bound_ms = (rows * (4 * w + 4) + ns * w * 4) / HBM_BYTES_PER_S * 1e3
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
                del k, p
                line = (f"  segment_reduce {op:3s} {str(dtype):13s} {rows}x{w} "
                        f"nseg={ns}: identical to the plain version")
                timed = (rows, w, ns) == (n, width, nseg) and (dtype == torch.int32 or op != "sum")
                on_path = dtype == torch.int32 and any(
                    (shape, n_s, o) == ((rows, w), ns, op) for shape, n_s, o, _ in main_shapes)
                if timed or on_path:
                    ms = cuda_time_ms(lambda: ops.segment_reduce(vals, seg, ns, op=op,
                                                                 force="cuda"))
                    line += f"; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms"
                    if timed:
                        op_ms[f"{str(dtype).removeprefix('torch.')} {op}"] = ms
                    if on_path:
                        launch_ms.append({"shape": [rows, w], "num_segments": ns, "op": op,
                                          "dtype": "int32", "ms": ms, "bound_ms": bound_ms})
                if (rows, w, ns) == (n, width, nseg) and dtype == torch.int32 and op == "sum":
                    ms = op_ms["int32 sum"]
                    plain_ms = cuda_time_ms(lambda: ops.segment_reduce(
                        vals, seg, ns, op=op, force="torch"), iters=3)
                    ids = seg.to(torch.int64)[:, None].expand(-1, w)

                    def library():
                        out = torch.full((ns, w), identity(op, dtype), dtype=dtype,
                                         device="cuda")
                        return out.scatter_reduce_(0, ids, vals, reduce="sum",
                                                   include_self=True)

                    require_equal(ops.segment_reduce(vals, seg, ns, op=op, force="cuda"),
                                  library(), "segment_reduce vs scatter_reduce_")
                    library_ms = cuda_time_ms(library)
                    del ids
                    split = device_ms_by_kernel(lambda: ops.segment_reduce(
                        vals, seg, ns, op=op, force="cuda"))
                    tiles_ms = sum(v for k_, v in split.items() if "segment_tiles" in k_)
                    finish_ms = sum(v for k_, v in split.items() if "segment_finish" in k_)
                    memset_ms = sum(v for k_, v in split.items() if "emset" in k_)
                    rec = {"name": "segment_reduce", "route": "cuda",
                           "source": "src/repro_torch/csrc/segment_reduce.cu",
                           "replaces": "src/repro/kernels/segment_reduce.py:89",
                           "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": "bytes",
                           "library_ms": library_ms, "shape": [rows, w],
                           "num_segments": ns, "op": op, "dtype": "int32",
                           "profile_ms": {"tiles": tiles_ms, "finish": finish_ms,
                                          "memset": memset_ms}}
                    line += (f", plain {plain_ms:.3f} ms, scatter_reduce_ {library_ms:.4f} ms; "
                             f"profiler: tiles {tiles_ms:.4f} ms, finish (long empty runs and "
                             f"segments across tiles) {finish_ms:.4f} ms, memset "
                             f"{memset_ms:.4f} ms")
                max_err = max(max_err, err)
                log(line)
            del vals
        if (rows, w, ns) == (n, width, nseg):  # width 2 at the largest shape
            vals = torch.randint(-2**31, 2**31 - 1, (rows, 2), dtype=torch.int32, device="cuda",
                                 generator=gen)
            require_equal(ops.segment_reduce(vals, seg, ns, force="cuda"),
                          ops.segment_reduce(vals, seg, ns, force="torch"),
                          f"segment_reduce sum int32 {rows}x2")
            w2_ms = cuda_time_ms(lambda: ops.segment_reduce(vals, seg, ns, force="cuda"))
            w2_bound = (rows * 12 + ns * 8) / HBM_BYTES_PER_S * 1e3
            log(f"  segment_reduce sum int32 {rows}x2 nseg={ns}: identical to the plain version;"
                f" kernel {w2_ms:.4f} ms, bound {w2_bound:.4f} ms")
            del vals
        del seg
    rec.update(op_ms=op_ms, main_path_launch_ms=launch_ms,
               width2={"ms": w2_ms, "bound_ms": w2_bound})

    # every value dtype, with +-0, NaN and +-inf in the floats, at a small shape
    seg = _segments(SEG_SMALL_ROWS, 5003 * P, P, gen)
    for name in ("int32", "uint32", "float32") + SEG_NARROW:
        dtype = getattr(torch, name)
        for op in ("sum", "min", "max"):
            if dtype == torch.bool and op == "sum":
                continue
            if dtype == torch.uint32:
                vals = torch.randint(-2**31, 2**31 - 1, (SEG_SMALL_ROWS, 2), dtype=torch.int32,
                                     device="cuda", generator=gen).view(torch.uint32)
            else:
                vals = _special_values(dtype, op, (SEG_SMALL_ROWS, 2), gen)
            require_equal(ops.segment_reduce(vals, seg, 5003 * P, op=op, force="cuda"),
                              ops.segment_reduce(vals, seg, 5003 * P, op=op, force="torch"),
                              f"segment_reduce {op} {name} {SEG_SMALL_ROWS}x2")
    log(f"  segment_reduce sum/min/max of int32, uint32, float32 and {', '.join(SEG_NARROW)}"
        f" (no bool sum), {SEG_SMALL_ROWS}x2 with +-0, NaN and +-inf in the floats: identical"
        f" to the plain version (NaN by position)")
    rec["max_abs_err"] = max_err
    return rec


# -- serve path ---------------------------------------------------------------------

SERVE_ARCH = "zamba2-1.2b"
PREFILL_BATCH, PREFILL_LEN = 4, 4096
PROMPT_LENS, MAX_NEW, ENGINE_MAX_LEN = (16, 32, 48, 64), 16, 128
CHECK_BATCH, CHECK_LEN = 2, 256
# float32 forward, kernels against plain versions: the same math summed in
# another order, through 38 layers; and token-by-token decode against the
# forward, the reference's own prefill/decode tolerance (tests/test_models.py)
CONSISTENCY_TOL = 2e-3


def expect_launches(counts: dict, want: dict, what: str) -> None:
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def serve_path(gen):
    """The zamba2-1.2b serving path at full width in bf16: prefill of
    4 x 4096 tokens (which must launch ssd_scan 38 times and flash_attention
    6 times), then greedy generation of 16 tokens for 4 prompts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import registry
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, make_prefill

    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    t = time.perf_counter()
    params = model.init_params(gen)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"serve path: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}), {n_params} random float32 parameters from a seeded "
        f"generator ({time.perf_counter() - t:.1f} s)")
    want = {"ssd_scan": cfg.n_layers, "flash_attention": cfg.n_layers // cfg.shared_attn_every}
    B, S = PREFILL_BATCH, PREFILL_LEN
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    prefill = make_prefill(model)
    res = {"arch": cfg.name, "batch": B, "seq": S, "params": n_params}
    with torch.inference_mode():
        registry.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        nxt, state = prefill(params, model.init_decode_state(B, ENGINE_MAX_LEN), {"tokens": tokens})
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        launches = registry.launch_counts()
        expect_launches(launches, want, "prefill")
        if state["length"] != S or nxt.shape != (B,) or int(nxt.max()) >= cfg.vocab_size:
            raise AssertionError(f"prefill returned length {state['length']}, tokens {nxt}")
        times = []
        for _ in range(3):
            registry.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(params, model.init_decode_state(B, ENGINE_MAX_LEN), {"tokens": tokens})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            expect_launches(registry.launch_counts(), want, "prefill")
        peak = torch.cuda.max_memory_allocated()
        h, _ = model.forward(params, {"tokens": tokens})
        logits = model.unembed(params, h)
        if logits.shape != (B, S, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} are not all finite")
        del h, logits
    ms = float(np.median(times))
    log(f"  prefill {B}x{S}: first {first_ms:.1f} ms, then {', '.join(f'{x:.1f}' for x in times)}"
        f" ms (median {ms:.1f} ms, {B * S / ms * 1e3:.0f} tokens/s); launches {launches}; "
        f"logits finite; peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    res.update(prefill_first_ms=first_ms, prefill_ms=times, prefill_tokens_per_s=B * S / ms * 1e3,
               prefill_launches={k: launches[k] for k in want}, prefill_peak_bytes=peak)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    engine = ServeEngine(model, params, max_len=ENGINE_MAX_LEN)
    engine.generate([p[:2] for p in prompts], max_new=2)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = engine.generate(prompts, max_new=MAX_NEW)
    wall = time.perf_counter() - t
    steps = max(PROMPT_LENS) + MAX_NEW - 1
    for p, o in zip(prompts, outs):
        if o[: len(p)] != p or len(o) != len(p) + MAX_NEW:
            raise AssertionError("generate returned a wrong length or changed a prompt")
        if not all(0 <= x < cfg.vocab_size for x in o):
            raise AssertionError("generate returned a token outside the vocabulary")
    log(f"  ServeEngine(max_len={ENGINE_MAX_LEN}).generate: prompts {list(PROMPT_LENS)}, "
        f"{MAX_NEW} new tokens each, {steps} decode steps in {wall * 1e3:.1f} ms "
        f"({wall / steps * 1e3:.2f} ms per step); every token < vocab")
    res.update(decode_steps=steps, decode_ms_per_step=wall / steps * 1e3,
               generate_ms=wall * 1e3)
    return model, params, res


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def consistency(model, params, gen):
    """Full width in float32, B = 2, S = 256: the kernel path's logits
    against the same forward through the plain versions, and against
    decode_step fed token by token."""
    import dataclasses

    import torch

    from repro_torch.kernels import registry
    from repro_torch.models import build_model

    cfg = dataclasses.replace(model.cfg, dtype="float32")
    m32 = build_model(cfg)
    B, S = CHECK_BATCH, CHECK_LEN
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    with torch.inference_mode():
        registry.reset_launch_counts()
        logits = m32.unembed(params, m32.forward(params, {"tokens": tokens})[0])
        expect_launches(registry.launch_counts(),
                        {"ssd_scan": cfg.n_layers,
                         "flash_attention": cfg.n_layers // cfg.shared_attn_every},
                        "float32 forward")
        with registry.use_backend("torch"):
            registry.reset_launch_counts()
            plain = m32.unembed(params, m32.forward(params, {"tokens": tokens})[0])
            expect_launches(registry.launch_counts(), {"ssd_scan": 0, "flash_attention": 0},
                            "plain forward")
        state = m32.init_decode_state(B, S, dtype=torch.float32)
        dec = []
        for t in range(S):
            lg, state = m32.decode_step(params, state, {"token": tokens[:, t:t + 1]})
            dec.append(lg)
        dec = torch.stack(dec, dim=1)
    scale = float(logits.abs().max())
    err_plain = float((logits - plain).abs().max())
    err_dec = float((logits - dec).abs().max())
    log(f"consistency at full width, float32, {B}x{S} (logits up to {scale:.4f}): kernel path "
        f"vs plain versions max abs err {err_plain:.3e}; vs token-by-token decode {err_dec:.3e} "
        f"(tolerance atol = rtol = {CONSISTENCY_TOL})")
    torch.testing.assert_close(logits, plain, atol=CONSISTENCY_TOL, rtol=CONSISTENCY_TOL)
    torch.testing.assert_close(logits, dec, atol=CONSISTENCY_TOL, rtol=CONSISTENCY_TOL)
    return {"batch": B, "seq": S, "logit_scale": scale, "kernel_vs_plain_max_abs_err": err_plain,
            "forward_vs_decode_max_abs_err": err_dec, "tol": CONSISTENCY_TOL}


# -- model kernel phase -------------------------------------------------------------------

FLASH_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}  # bf16: one output rounding;
# f32: sums over up to 8192 keys in another order
SSD_TOL = 3e-5  # of the output's largest magnitude, the reference's own kernel-test tolerance


def _normal(shape, dtype, gen):
    import torch

    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def flash_phase(main_shapes, gen):
    """flash_attention at the prefill's shapes (and in float32), a ragged S,
    gemma2-9b's and olmo-1b's attention, held against its plain version;
    timed at the prefill's shape beside the bound, the plain version and
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    (shape, KV, _, causal, window, softcap, scale), = main_shapes
    B, S, H, hd = shape
    cases = [("prefill", B, S, H, KV, hd, causal, window, softcap, scale),
             ("ragged", 1, S - 27, H, KV, hd, True, None, None, None),
             ("gemma2-9b", 1, 8192, 16, 8, 256, True, 4096, 50.0, 256 ** -0.5),
             ("olmo-1b", 4, 2048, 16, 16, 128, True, None, None, None)]
    rec, max_err = None, 0.0
    for name, b, s, h, kv, d, cz, win, cap, sc in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (_normal((b, s, n, d), dt, gen) for n in (h, kv, kv))
            kw = dict(causal=cz, window=win, softcap=cap, scale=sc)
            got = ops.flash_attention(q, k, v, force="cuda", **kw)
            exp = ops.flash_attention(q, k, v, force="torch", **kw)
            torch.cuda.synchronize()
            err = max_abs_err(got, exp)
            tol = FLASH_TOL[str(dt)]
            if not err <= tol:
                raise AssertionError(f"flash_attention {name} {dt}: max abs err {err} > {tol}")
            max_err = max(max_err, err)
            line = (f"  flash_attention {name} B={b} S={s} H={h} KV={kv} hd={d} window={win} "
                    f"softcap={cap} {dt}: max abs err {err:.2e} (tol {tol})")
            if name == "prefill" and dt == torch.bfloat16:
                ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, force="cuda", **kw), iters=5)
                plain_ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, force="torch", **kw),
                                        iters=3, warmup=1)
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=cz, scale=sc)
                lib_err = max_abs_err(lib.transpose(1, 2), exp)
                library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=cz, scale=sc), iters=5)
                flops = 4 * b * h * s * s * d * (0.5 if cz else 1.0)
                nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * q.element_size()
                bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
                rec = {"name": "flash_attention", "route": "cuda",
                       "source": "src/repro_torch/csrc/flash_attention.cu",
                       "replaces": "src/repro/kernels/flash_attention.py:82",
                       "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": "operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
                       else "bytes",
                       "library_ms": library_ms, "library": "scaled_dot_product_attention",
                       "library_max_abs_err": lib_err, "shape": [b, s, h, kv, d],
                       "dtype": "bfloat16", "causal": cz, "flops": flops, "bytes": nbytes,
                       "tflops": flops / ms * 1e-9, "library_tflops": flops / library_ms * 1e-9}
                line += (f"; kernel {ms:.3f} ms ({flops / ms * 1e-9:.1f} TFLOP/s), plain "
                         f"{plain_ms:.3f} ms, SDPA {library_ms:.3f} ms ({flops / library_ms * 1e-9:.1f}"
                         f" TFLOP/s; vs plain {lib_err:.1e}), bound {bound_ms:.4f} ms")
                del qt, kt, vt, lib
            log(line)
            del q, k, v, got, exp
            torch.cuda.empty_cache()
    rec["max_abs_err"] = max_err
    return rec


def _ssd_inputs(b, L, H, dh, G, ds, gen):
    import torch

    x = _normal((b, L, H, dh), torch.float32, gen)
    dt = torch.rand((b, L, H), device="cuda", generator=gen) * 0.1 + 0.001
    A = -(torch.rand(H, device="cuda", generator=gen) * 15 + 1)
    B = _normal((b, L, G, ds), torch.float32, gen)
    C = _normal((b, L, G, ds), torch.float32, gen)
    D = torch.ones(H, device="cuda")
    return x, dt, A, B, C, D


def ssd_phase(main_shapes, gen):
    """ssd_scan at the prefill's shape, a ragged length, and G = 2 with
    ds = 128 at chunks 64 and 256, held against its plain version; timed at
    the prefill's shape beside the bound and the plain version."""
    import torch

    from repro_torch.kernels import ops

    (xshape, bshape, chunk, _), = main_shapes
    b, L, H, dh = xshape
    G, ds = bshape[2], bshape[3]
    cases = [("prefill", b, L, H, dh, G, ds, chunk), ("ragged", 2, L - 45, H, dh, G, ds, chunk),
             ("G2-ds128", 2, 2048, H, dh, 2, 128, 64), ("G2-ds128", 2, 2048, H, dh, 2, 128, 256)]
    rec, max_err = None, 0.0
    for name, b_, L_, H_, dh_, G_, ds_, ch in cases:
        args = _ssd_inputs(b_, L_, H_, dh_, G_, ds_, gen)
        y, st = ops.ssd_scan(*args, chunk=ch, force="cuda")
        y_ref, st_ref = ops.ssd_scan(*args, chunk=ch, force="torch")
        torch.cuda.synchronize()
        err = max(max_abs_err(y, y_ref), max_abs_err(st, st_ref))
        scale = max(float(y_ref.abs().max()), float(st_ref.abs().max()))
        if not err <= SSD_TOL * scale:
            raise AssertionError(f"ssd_scan {name}: max abs err {err} > {SSD_TOL} x {scale}")
        max_err = max(max_err, err)
        line = (f"  ssd_scan {name} b={b_} L={L_} H={H_} dh={dh_} G={G_} ds={ds_} chunk={ch}: "
                f"max abs err {err:.2e} (outputs up to {scale:.2f})")
        if name == "prefill":
            ms = cuda_time_ms(lambda: ops.ssd_scan(*args, chunk=ch, force="cuda"))
            plain_ms = cuda_time_ms(lambda: ops.ssd_scan(*args, chunk=ch, force="torch"),
                                    iters=3, warmup=1)
            nc = -(-L_ // ch)
            flops = b_ * H_ * nc * (ch * (ch + 1) * (ds_ + dh_) + 4 * ch * dh_ * ds_)
            nbytes = 4 * (2 * y.numel() + args[1].numel() + 2 * args[3].numel() + 2 * H_
                          + st.numel())
            bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            rec = {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
                   "replaces": "src/repro/kernels/ssd_scan.py:66", "ms": ms, "kernel_ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
                   else "bytes",
                   "library_ms": None, "shape": [b_, L_, H_, dh_, G_, ds_], "chunk": ch,
                   "dtype": "float32", "flops": flops, "bytes": nbytes,
                   "tflops": flops / ms * 1e-9}
            line += (f"; kernel {ms:.3f} ms ({flops / ms * 1e-9:.1f} TFLOP/s), plain {plain_ms:.3f} ms,"
                     f" bound {bound_ms:.4f} ms")
        log(line)
        del args, y, st, y_ref, st_ref
        torch.cuda.empty_cache()
    rec["max_abs_err"] = max_err
    return rec


# -- profile ---------------------------------------------------------------------------

def _profile(run, path: str, what: str) -> None:
    """Run ``run()`` under ``torch.profiler``; write the table by device time
    to ``path`` and log the device's busy time and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()  # inside: the profiler's start-up is not counted
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    log(f"profile of {what}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / wall_us:.3f} ({path})")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  {e.key[:90]}")
    for name in PORT_KERNELS:  # the port's own kernels, wherever they rank
        own = [e for e in device if name in e.key]
        if own:
            log(f"  port kernel {name}: {sum(e.self_device_time_total for e in own) / 1e3:.3f} ms"
                f" in {sum(e.count for e in own)} launches")


def profile_main_path(P: int, rows_per_worker: int, path: str) -> None:
    """The main path once more under ``torch.profiler``: device time by
    kernel and the device's idle share of the wall time."""
    from repro_torch.core import DDF, DDFContext
    from repro_torch.data import uniform_table

    n = P * rows_per_worker
    left = uniform_table(n, cardinality=0.9, n_cols=2, seed=1)
    right = uniform_table(n, cardinality=0.9, n_cols=2, seed=2)
    ctx = DDFContext(nworkers=P)
    aggs = {"c1": ("sum", "min", "max", "count", "mean")}

    def run():
        L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
        J, _ = L.join(R, on=("c0",), strategy="shuffle")
        del L, R
        G, _ = J.groupby(("c0",), aggs, pre_combine=True)
        del J
        G.unique(("c0",))

    _profile(run, path, "the main path")


def profile_prefill(model, params, gen, path: str) -> None:
    """One bf16 prefill of the serve path under ``torch.profiler``."""
    import torch

    from repro_torch.serve import make_prefill

    tokens = torch.randint(0, model.cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), device="cuda",
                           generator=gen)
    prefill = make_prefill(model)

    def run():
        with torch.inference_mode():
            prefill(params, model.init_decode_state(PREFILL_BATCH, ENGINE_MAX_LEN),
                    {"tokens": tokens})

    _profile(run, path, f"one prefill of {PREFILL_BATCH}x{PREFILL_LEN} tokens")


def profile_decode(model, params, path: str) -> None:
    """Greedy generation of 8 tokens for 4 prompts of 8 tokens (15 decode
    steps) under ``torch.profiler``."""
    from repro_torch.serve import ServeEngine

    prompts = [[1 + i + j for j in range(8)] for i in range(PREFILL_BATCH)]
    engine = ServeEngine(model, params, max_len=ENGINE_MAX_LEN)
    _profile(lambda: engine.generate(prompts, max_new=8), path,
             f"15 decode steps at batch {PREFILL_BATCH}")


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
                    help="also profile the main path, one prefill and 15 decode steps; "
                         "write the tables to PATH and to PATH with _prefill and _decode "
                         "before its extension")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is not in {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import cuda_lib

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
    log("tensor-core kernels (nvcc -Xptxas -v; cuobjdump -sass):")
    build = build_report(cuda_lib.load(), info)

    shapes: dict = {}
    restore = record_shapes(shapes)
    cut = (f"rows per worker {args.rows_per_worker} of the paper's "
           f"{PAPER_ROWS_PER_WORKER} (the static-quota layout's peak memory at 25M "
           f"does not fit the card)") if args.rows_per_worker < PAPER_ROWS_PER_WORKER else "none"
    log(f"cut: {cut}")
    main_res = run_main_path(WORKERS, args.rows_per_worker, shapes)
    restore()
    for name in DATAFRAME_KERNELS:
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
    torch.cuda.empty_cache()  # the dataframe path's memory goes back to the card

    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_gen = torch.Generator(device="cuda")
    model_gen.manual_seed(MODEL_SEED)
    model_shapes: dict = {}
    restore = record_shapes(model_shapes)
    model, params, serve_res = serve_path(model_gen)
    restore()
    log("  prefill kernel shapes: " + json.dumps(
        {k: sorted(map(str, v)) for k, v in model_shapes.items()}))
    serve_res["consistency"] = consistency(model, params, model_gen)

    log("model kernel phase (each kernel against its plain version on the card):")
    model_recs = [flash_phase(model_shapes["flash_attention"], gen),
                  ssd_phase(model_shapes["ssd_scan"], gen)]
    for r in model_recs:
        r["launches"] = serve_res["prefill_launches"][r["name"]]
    recs += model_recs
    for r in recs:
        r.setdefault("kernel_ms", r["ms"])

    if args.profile:
        root, ext = os.path.splitext(args.profile)
        profile_prefill(model, params, model_gen, f"{root}_prefill{ext}")
        profile_decode(model, params, f"{root}_decode{ext}")

    log(json.dumps({"build": build}))
    log(json.dumps({"main_path": main_res, "cut": cut}))
    log(json.dumps({"serve": serve_res}))
    log(json.dumps({"kernels": recs}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
