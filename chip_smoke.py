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
3. The patterns path, once the main path's memory is freed, at the same
   configuration: ``select(col("c1") < 2**30)`` + two ``with_column``,
   ``rebalance``, ``sort_values`` both ways, ``union`` / ``difference``
   with the right table, ``agg`` (sum, min, max, mean, count) and
   ``length``, ``rolling`` (sum, mean, min, max) and ``rolling_sum`` over
   8 rows, ``head(1000)``, a groupby with aggregation expressions, a
   ``transpose`` of an 8 x 64-row table, and a string-keyed join and union
   at 125,000 rows per worker. Each step runs with the launch counts at 0,
   asserts the kernels it must launch (hash_partition once for a union,
   twice for a difference or join; segment_reduce for the groupby; none
   elsewhere) and every overflow counter at 0, and is held against a numpy
   oracle. Then the column-types step (``run_coltype_steps``) at 1,000,000
   rows per worker: uint32 keys at cardinality 0.9 over the whole range
   (half at or above 2**31), a uint32 value and a (n, 4) float32 payload,
   joined with a second such table (hash_partition twice), grouped with a
   wrapping uint32 sum, min and max (hash_partition once, segment_reduce 6
   on uint32), sorted both ways and made unique, each held to numpy by
   bits (rows by 64-bit fingerprints of their words).
4. The lazy path on the same tables: the README's lazy example
   (``select(col("c1") < 2**30)``, ``with_column("c2", when(col("c1") <
   2**29).then(1).otherwise(0))``, ``project``, a shuffle ``join`` with the
   right table and a ``groupby`` on the join key with sum, min, max, count,
   mean and a second sum) through ``DDF.lazy()``. Prints ``explain()`` and
   requires the predicate below the join, the groupby's shuffle elided and
   one shuffle; one collect with the launch counts at 0 must launch what
   the optimized plan implies (hash_partition twice, segment_reduce once
   per partial of the groupby) with every overflow counter at 0; a second
   collect must hit the plan and op caches; the same steps run eagerly
   must give the same ``to_numpy()`` bit for bit. Both wall times and the
   peak device memory are printed.
5. The streaming path (``run_stream_path``): the paper's left table at its
   full 25,000,000 rows per worker (8 x 25M int32 rows, 1.6 GB) written as
   an uncompressed chunked dataset in a temporary directory; the README's
   lazy example without its join streamed through ``scan_dataset`` ->
   ``collect_stream()`` at the cost model's batch size (at least 4
   batches) against a numpy oracle with every overflow counter at 0; the
   same query killed at half its batches with checkpoints (traced, for the
   cost-model check) and resumed, equal by bits; ``to_batches`` of its EP
   part; a streamed sort and a scan x scan spill join + groupby at
   1,000,000 rows per worker a side; ``scan_csv`` of 1,000,000 rows. Each
   step runs with the launch counts at 0: those with a shuffle must launch
   hash_partition and segment_reduce, none may launch the histogram
   variant (the runner's histogram is built on the host), and the EP and
   sort steps launch nothing.
6. The service path (``run_service_path``): one
   ``QueryService(policy="fair", max_running=4)`` drives the reference's
   ``benchmarks/bench_service.py`` mix on the card: 4 streamed groupbys of
   the same 25M-rows-per-worker table (``k = c0 % 10,000``, sum and count
   of ``c1``, 25 batches, ``carry_capacity=16,384``) beside 4 lazy joins
   (the README's lazy example at 1,000,000 rows per worker a side), an
   eager sort and a select. Every query first runs alone (launches, peak
   memory, admission estimate, the runner's working-set gauge); the
   concurrent results must equal those by bits (the scans also a numpy
   oracle), every session must end DONE and the launch counts must be the
   serial runs' sum. Prints walls, queries/s, latency p50/p95, the
   scans' fairness spread, morsels and turns, cache hits and the peaks.
   A fifth scan cancelled after 5 morsels must end CANCELLED with its card
   memory returned, a raising thunk FAILED, and a full backlog must shed.
7. The grouped paths, with the card's memory freed: a child process joins
   a one-rank NCCL group on cuda:0 (``core.comm.group.init_from_env``) and
   runs over ``DDFContext(nworkers=8, group=WORLD)``, with the launch
   counts at 0 before each: the main path, the lazy path on its tables, the
   streaming path's groupby on the 25M-rows-per-worker dataset the parent
   kept (killed at batch 12 with checkpoints, then resumed) and the service
   mix through ``QueryService(policy="fair", max_running=4, ctx=...)``. Each
   must launch what the one-card run launched (``hash_partition_hist`` 0),
   keep every overflow counter at 0 (``overflow_carry`` too) and give every
   worker's rows equal by bits to the one-card run's (per-worker digests:
   the main path's three steps, the column-types step's five, the lazy
   collect, the resumed groupby, each service query). Its times are printed beside the one-card runs'. A
   one-rank group moves nothing across cards: the cross-rank logic is
   held to the reference on the CPU (gloo, worlds 2 and 8).
8. Calls each kernel's wrapper at the shapes the main path, the patterns
   path, the lazy path, the streaming path and the service path gave it,
   and at a ragged row count, and holds it against its plain PyTorch
   version: hashes, destinations, histograms, integer sums and min/max must be
   identical, float sums exact on integer-valued inputs, floats compared
   by their bits. segment_reduce is also held, bit for bit, in every value
   dtype it takes (bool, int8, uint8, int16, float16 besides int32,
   uint32, float32) with +-0, +-inf and NaNs of both signs and with
   payloads in the floats, and is timed per op (int32 sum, min, max;
   float32 min, max), at width 2, and at every main-path launch's shape,
   with the second pass (long empty runs, segments across tiles) split
   out by the profiler.
9. Fits the on-card all-to-all (a transpose) to Hockney (alpha, beta), and
   the cost model's ``gamma_s_per_row`` to the main path's local groupby.
10. Frees the dataframe path's memory and drives the LM serving path of five
   architectures at full width in bf16 (random float32 weights from a seeded
   generator, each model freed before the next is built), through
   ``run_family_path``: ``make_prefill`` (first run and three more, each
   required to launch ``flash_attention`` in every self-attention layer and
   ``ssd_scan`` in every Mamba layer; peak memory; the logits of every
   position finite, unembedded 512 positions at a time), then
   ``ServeEngine.generate`` on 4 prompts, then the model in float32: the
   kernel path's logits against the plain versions' (and, for zamba2 and
   gemma2, against token-by-token decode). The paths: zamba2-1.2b on
   4 x 4096 tokens (38 ``ssd_scan`` + 6 ``flash_attention``); gemma2-9b
   (42 layers, d_model 3584, vocab 256,000; window 4096 on even layers) on
   2 x 8192 (42 launches); granite-moe-3b-a800m (40 experts, top 8) on
   4 x 4096 (32); llava-next-mistral-7b on 2 x (576 random patch embeddings
   + 7616 tokens), so that its 4096 window acts (32); whisper-tiny on
   4 x 448 decoder tokens over 4 x 1500 random frames (4 bidirectional
   encoder + 4 causal decoder launches; cross-attention launches none).
11. The train path (``run_train_path``), the serve paths' memory freed:
   ``TokenPipeline`` over 8,000,000 synthetic documents on 8 workers (1M
   a worker, one shard of a pretraining data-prep job: a compressed
   on-disk corpus streamed through dedup, a quality filter, a length sort
   and a rebalance), which must launch hash_partition and never its
   histogram, with distinct hashes, quality above the threshold, sorted
   lengths, worker counts within one, and at 200,000 documents the card's
   documents equal to the CPU's by bits; olmo-1b at full width (random
   float32 weights, bf16 compute) on train_4k's sequence of 4096 with the
   global batch cut to 8 in 2 microbatches, fed by the pipeline: a first
   step, 5 steps through ``StepGuard``, then 5 on one repeated batch whose
   loss must fall, each with the launch counts at 0 and required to launch
   flash_attention twice per layer and microbatch (each layer is
   recomputed in the backward); ms per step, positions/s, loss tokens/s,
   model TFLOP/s and peak memory; ``checkpoint.save`` of the whole train
   state and ``restore`` onto the card, equal by bits, and two steps from
   each with equal losses; ``train.elastic.rescale_state`` of that
   checkpoint onto the meshes (2, 1), (8, 1), (4, 2) and the 16 x 16
   production layout, one at a time (``rescale_check``: the step, every
   leaf equal by bits, every coordinate's shard a view of its leaf with
   ``sharding.local_shape``, the bytes per device those views' bytes); float32 gradients through the kernels' autograd
   Functions against plain autograd (olmo-1b at 2 layers and zamba2-1.2b
   at 7, 2 x 1024, each leaf within 1e-4 of its largest magnitude); and
   zamba2-1.2b at full width on 2 x 4096 (ssd_scan 76 and flash_attention
   12 launches per step).
12. The planned train phase (``run_planned_phase``), in a child process
   over a one-rank NCCL group on cuda:0: the train step under
   ``make_plan(make_group_mesh())`` (ZeRO-3 over the data ranks: every
   weight gathered at use, cast to bf16 first, its gradient
   reduce-scattered, a replicated leaf's all-reduced; at world 1 each is a
   copy). olmo-1b at 8 x 4096 in 2 microbatches fed by the
   ``TokenPipeline`` over the group's ``DDFContext`` with the plan (1M
   documents), zamba2-1.2b at 2 x 4096, 2 steps each from the train path's
   starting state, held to the same steps on one device run twice: by bits
   wherever those two runs agree by bits, elsewhere within 1e-4 of a
   moment's largest magnitude and 2 lr for a parameter; launches equal to
   the one-device step's; step times, peaks and collective counts beside
   the one-device step's; each step's census of collectives (count and
   bytes per kind, ``fsdp.census()``) equal to the dry run at world 1 of
   the same cut cell (``launch.dryrun`` on the meta device over a stand-in
   group) and its peak above the state within ``PEAK_BAND`` of that dry
   run's; and a planned checkpoint of olmo-1b at 2 layers
   equal to one card's file for file by bits, restored to the rank's
   shards. Then the planned serve legs (``planned_serve``) under
   ``make_plan(make_group_mesh(), mode="serve")``: zamba2-1.2b and
   granite-moe-3b-a800m at published widths, 4 x 4096 prompts, bf16, a
   prefill and 8 greedy decode steps each on one device and then from the
   rank's ``shard_params`` and planned decode state, the tokens equal by
   bits and the prefill's launches equal (zamba2: 38 ``ssd_scan`` + 6
   ``flash_attention``); prefill and decode times and peaks beside one
   device's; the prefill's and the decode steps' census equal to the dry
   run's of the same legs.
13. Calls the two model kernels at every distinct configuration the five
   prefills gave them (flash attention: shape, KV heads, causal, window,
   softcap and scale; gemma2-9b's local and global layers, granite's GQA,
   whisper-tiny's encoder and decoder, llava's window), at a ragged length
   and at other configurations' shapes (gemma2-9b's window at B = 1,
   olmo-1b, stablelm-3b at head_dim 80; ssd_scan at G = 2, ds = 128,
   chunks 64 and 256), each in bf16 and float32, held against their
   plain versions, and times each (attention at the zamba2 prefill's shape
   and at stablelm-3b's) beside its bound, its plain version and, for
   attention, ``scaled_dot_product_attention`` as a yardstick the port
   never calls, with the achieved TFLOP/s.
14. The launch phase (``run_launch_phase``): ``launch.dryrun.run_cell`` on
   the meta device for every architecture x shape of the launch grid (10 x
   4 at published widths, long_500k skipped for the full-attention
   architectures), in worker processes, one line per cell (parameter and
   state bytes, the tracked peak, whether it fits one card, FLOPs, model
   FLOPs and their ratio, the three roofline terms, and the state bytes
   one device holds on the 16 x 16 and 2 x 16 x 16 production meshes); rank 0
   of every architecture's train_4k cell on 16 x 16 (its shards, its
   stand-in collectives: peak, state bytes equal to its state per device,
   collectives per kind with bytes, the three roofline terms); the same dry run of
   the train paths' cells and of the five prefills, its predicted peaks
   against this run's measured ones; the train paths' steps beside their
   roofline (model FLOP/s and their share of 989 TFLOP/s); one warm step on
   the card of every grid cell that fits with 10% to spare, with its launch
   counts and peak; and ``launch.dryrun_ddf``, the paper's join at P = 8 on
   the card (hash_partition 2 launches, no histogram, no segment_reduce,
   no overflow, the joined rows equal to a numpy oracle), beside the
   Hockney prediction of its shuffles from this run's fabric fit.
15. With ``--profile``, runs the dataframe main path, the patterns path's
   steps on the main path's tables, its string steps (their tables built
   outside the window), one lazy collect, one streamed groupby collect, one
   concurrent run of the service path, and one bf16 prefill and 15 decode
   steps of zamba2-1.2b and of gemma2-9b, one train step of olmo-1b and one
   planned train step of olmo-1b once more under ``torch.profiler``, each
   as a window of its own, and reports device time by kernel and the
   device's idle share.

Prints the card's name and power limit, a ``kernels`` JSON line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed check raises and the
exit code is not 0. Needs one CUDA device and this script's repository.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
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
COLTYPE_ROWS_PER_WORKER = 1_000_000  # the patterns path's uint32 and vector-column step
COLTYPE_WIDTH = 4  # the vector payload's floats a row
COLTYPE_STEPS = ("join", "groupby", "sort", "sort_desc", "unique")
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


def require_equal(a, b, what: str, nan_bits: bool = True) -> float:
    """Bit for bit, floats by their bits (the sign of zero and each NaN's
    sign and payload included: the reference hashes floats by their bits);
    returns the largest difference between the non-NaN values. With
    ``nan_bits`` off, NaNs count by position only: for float sums, whose
    NaNs are the ones CUDA arithmetic makes, which the port does not
    promise to be the reference's."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    if a.dtype.is_floating_point:
        ints = {torch.float32: torch.int32, torch.float16: torch.int16}[a.dtype]
        nan = a.isnan() | b.isnan()
        if nan_bits:
            same = torch.equal(a.view(ints), b.view(ints))
        else:
            same = torch.equal(a.isnan(), b.isnan()) and torch.equal(
                a.view(ints)[~nan], b.view(ints)[~nan])
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


def argsort32(k: np.ndarray) -> np.ndarray:
    """Stable argsort of int32 or uint32 keys (fewer than 2**32 of them) as
    one sort of ``key << 32 | index``: numpy's argsort of 32-bit keys is
    several times slower, and the oracles sort tens of millions of keys.
    int32 keys order as their bits with the sign bit flipped."""
    u = k.view(np.uint32) ^ np.uint32(0x80000000) if k.dtype == np.int32 else k
    packed = np.sort((u.astype(np.uint64) << np.uint64(32))
                     | np.arange(len(k), dtype=np.uint64))
    return (packed & np.uint64(0xFFFFFFFF)).astype(np.int64)


def check_against_oracle(got: dict, exp: dict, what: str) -> None:
    order = argsort32(got["c0"])
    for k in got:
        g = got[k][order]
        e = exp[k]
        if g.shape != e.shape or g.dtype != e.dtype or not np.array_equal(g, e):
            bad = np.nonzero(g != e)[0][:5] if g.shape == e.shape else []
            raise AssertionError(f"{what}.{k}: {g.dtype}{g.shape} vs oracle "
                                 f"{e.dtype}{e.shape}; first mismatches at {bad}")


def paper_tables(P: int, rows_per_worker: int):
    from repro_torch.data import uniform_table

    n = P * rows_per_worker
    return (uniform_table(n, cardinality=0.9, n_cols=2, seed=1),
            uniform_table(n, cardinality=0.9, n_cols=2, seed=2))


def worker_digests(ddf) -> list[list[int]]:
    """Per worker: its live-row count and, per column in name order, a
    position-weighted sum of its live values' 32-bit patterns (wrapping in
    int64; a vector column's words weighted by their index too), so that
    equal digests mean equal rows in equal order up to a collision. Needs
    every worker on this process and 4-byte columns."""
    import torch

    out = []
    for w in range(ddf.counts.shape[0]):
        n = int(ddf.counts[w].item())
        wt = torch.arange(n, dtype=torch.int64, device=ddf.counts.device) * 2654435761 + 97531
        row = [n]
        for k in sorted(ddf.columns):
            v = ddf.columns[k][w, :n]
            if v.element_size() != 4:
                raise TypeError(f"worker_digests: column {k!r} is {v.dtype}, not 4 bytes")
            words = v.reshape(n, math.prod(v.shape[1:])).view(torch.int32).to(torch.int64) \
                & 0xFFFFFFFF
            col_wt = torch.arange(words.shape[1], dtype=torch.int64, device=wt.device) * 40503
            row.append(int((words * (wt[:, None] + col_wt[None, :])).sum()))
        out.append(row)
    return out


def run_main_path(P: int, rows_per_worker: int, shapes: dict, left, right, group=None,
                  oracle: bool = True, device=None):
    """The main path on one card, or with ``group`` (a process group) on
    this rank's block of the workers (``device``: the context's default
    unless given); ``oracle=False`` skips the numpy oracle, for a run held
    to another run's digests."""
    import torch

    from repro_torch.core import DDF, DDFContext
    from repro_torch.kernels import registry

    n = P * rows_per_worker
    log(f"main path: P={P}, {rows_per_worker} rows per worker, {n} rows per side")
    ctx = DDFContext(nworkers=P, device=device, group=group)
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times = {}

    def timed(name, fn):
        _sync(ctx.device)
        t = time.perf_counter()
        out = fn()
        _sync(ctx.device)
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
    digests = {"join": worker_digests(J)}  # outside the timed steps
    del J
    U, uinfo = timed("unique", lambda: G.unique(("c0",)))
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    digests["groupby"], digests["unique"] = worker_digests(G), worker_digests(U)

    for name, t in times.items():
        log(f"  {name:18s} {t * 1e3:10.1f} ms")
    log(f"  launches on the main path: {launches}")
    log(f"  peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")
    for k, v in {**jinfo, **ginfo, **{f"unique_{k}": v for k, v in uinfo.items()}}.items():
        tot = int(v.sum().item())
        if tot != 0:
            raise AssertionError(f"overflow counter {k} = {tot}")
    log("  every overflow counter is 0")
    res = {"rows_per_worker": rows_per_worker, "workers": P, "times_s": times,
           "launches": launches, "peak_bytes": peak, "join_rows": join_rows,
           "digests": digests}
    if not oracle:
        return res

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
    return {**res, "groups": int(len(g["c0"]))}


# -- the paths over a process group ----------------------------------------------------

GROUPED_TIMEOUT_S = 300  # the whole phase: the child's start, tables and digests included
GROUP_TIMEOUT_S = 120.0  # each NCCL collective of the child gives up after this
GROUPED_STEPS = ("join", "groupby", "unique")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_grouped_stream(ctx, dataset_dir: str, memory_budget_bytes: float | None = None) -> dict:
    """The streaming path's groupby over ``ctx`` (a grouped context) on the
    dataset it left in ``dataset_dir``: killed at half its batches with a
    snapshot there (traced, as the one-device killed run), then resumed;
    each with the launch counts at 0 (``_StreamSteps``). The result holds
    the resumed groupby's per-worker digests."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.data import open_dataset
    from repro_torch.plan import logical
    from repro_torch.testing import FaultPlan, InjectedFault, fault_scope

    scan_kw = {} if memory_budget_bytes is None else {"memory_budget_bytes": memory_budget_bytes}
    ds = open_dataset(dataset_dir)
    scan = next(n for n in logical.walk(_stream_query(ds, ctx, scan_kw).plan)
                if isinstance(n, logical.Scan))
    nb = -(-ds.num_rows // (scan.capacity * ctx.nworkers))
    steps = _StreamSteps(ctx)
    ck = tempfile.mkdtemp(prefix="chip-smoke-grouped-ckpt-")
    try:
        def killed():
            with fault_scope(FaultPlan(kill_after={"device_op": nb // 2})), obs.profiled():
                try:
                    _stream_query(ds, ctx, scan_kw).collect_stream(
                        checkpoint_dir=ck, checkpoint_every=max(nb // 2, 1))
                    died = False
                except InjectedFault:
                    died = True
            _require(died, "the grouped killed run did not die")
            return None, {}

        def resumed():
            lz = _stream_query(ds, ctx, scan_kw)
            out = lz.collect_stream(checkpoint_dir=ck, resume=True, checkpoint_every=nb + 1)
            return out, lz.last_info

        steps("killed", killed, shuffles=True)
        gc.collect()
        out = steps("resumed", resumed, shuffles=True)
        digests = worker_digests(out)
        del out
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    return {"batches": nb, "steps": steps.res, "digests": digests}


def run_grouped_service(ctx, dataset_dir: str, lazy_rows_per_worker: int,
                        memory_budget_bytes: float | None = None) -> dict:
    """The service path's mix (``service_queries``: 4 streamed groupbys of
    ``dataset_dir``, 4 README lazy pipelines, the eager sort, the select)
    through one ``QueryService(policy="fair", max_running=4, ctx=ctx)``
    over ``ctx``'s group, with the launch counts at 0: every session DONE,
    every overflow counter 0 (``overflow_carry`` too); the result holds each
    query's per-worker digests."""
    import torch

    from repro_torch.core import DDF
    from repro_torch.data import open_dataset
    from repro_torch.kernels import registry
    from repro_torch.service import QueryService, QueryState

    scan_kw = {} if memory_budget_bytes is None else {"memory_budget_bytes": memory_budget_bytes}
    left, right = paper_tables(ctx.nworkers, lazy_rows_per_worker)
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
    del left, right
    queries = service_queries(open_dataset(dataset_dir), ctx, L, R, scan_kw)
    budget = service_budget(queries)
    registry.reset_launch_counts()
    _sync(ctx.device)
    t = time.perf_counter()
    with QueryService(policy="fair", max_running=SERVICE_MAX_RUNNING,
                      memory_budget_bytes=budget, ctx=ctx) as svc:
        handles = [svc.submit(q, label=name, **opts) for name, _, q, opts in queries]
        outs = [h.result(timeout=SERVICE_TIMEOUT_S) for h in handles]
    _sync(ctx.device)
    wall = time.perf_counter() - t
    launches = registry.launch_counts()
    sched = svc.stats()["scheduler"]
    digests = {}
    for (name, _, _, _), h, out in zip(queries, handles, outs):
        _require(h.state == QueryState.DONE, f"grouped service {name}: {h.state}")
        over = {k: int(np.sum(v.cpu().numpy() if isinstance(v, torch.Tensor) else v))
                for k, v in (h.info or {}).items() if "overflow" in k}
        _require(not any(over.values()), f"grouped service {name}: overflow {over}")
        digests[name] = worker_digests(out)
    return {"wall_s": wall, "launches": launches, "digests": digests,
            "turns_total": sched["turns_total"], "morsels_total": sched["morsels_total"]}


def run_grouped_paths(group, rows_per_worker: int, dataset_dir: str, device=None,
                      lazy_rows_per_worker: int | None = None,
                      memory_budget_bytes: float | None = None,
                      coltype_rows_per_worker: int = COLTYPE_ROWS_PER_WORKER) -> dict:
    """Over ``group`` (a process group), in turn: the main path, the
    patterns path's column-types step, the lazy path on its tables, the streaming path's groupby on ``dataset_dir``
    killed and resumed, and the service mix (its lazy tables at
    ``lazy_rows_per_worker``, the service path's by default), each with the
    launch counts at 0 and no numpy oracle (each is held to the one-device
    run's digests)."""
    import torch

    from repro_torch.core import DDFContext

    left, right = paper_tables(WORKERS, rows_per_worker)
    res = {"main": run_main_path(WORKERS, rows_per_worker, {}, left, right, group=group,
                                 oracle=False, device=device)}
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log("grouped column types:")
    res["coltypes"] = run_coltype_steps(WORKERS, coltype_rows_per_worker, device, group=group)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log("grouped lazy path:")
    res["lazy"] = run_lazy_path(WORKERS, left, right, device=device, group=group)
    del left, right
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ctx = DDFContext(nworkers=WORKERS, device=device, group=group)
    log("grouped streamed groupby, killed and resumed:")
    res["stream"] = run_grouped_stream(ctx, dataset_dir, memory_budget_bytes)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log("grouped service mix:")
    res["service"] = run_grouped_service(ctx, dataset_dir,
                                         lazy_rows_per_worker or SERVICE_LAZY_ROWS_PER_WORKER,
                                         memory_budget_bytes)
    return res


def run_grouped_rank(rows_per_worker: int, dataset_dir: str) -> int:
    """The child of :func:`run_grouped_phase`: joins the process group that
    torchrun's variables describe (NCCL on its card) and runs
    :func:`run_grouped_paths` over it at P = ``WORKERS``; its record is the
    last line it prints."""
    import torch.distributed as dist

    from repro_torch.core.comm import group
    from repro_torch.kernels import cuda_lib

    cuda_lib.load()  # the parent built the library: this loads it
    dev = group.init_from_env(timeout=GROUP_TIMEOUT_S)
    try:
        log(f"rank {dist.get_rank()} of {dist.get_world_size()} ({dist.get_backend()}) "
            f"on {dev}")
        res = run_grouped_paths(dist.group.WORLD, rows_per_worker, dataset_dir)
    finally:
        group.close()
    log(json.dumps({"grouped_paths": res}))
    return 0


def _same_digests(got: list, exp: list, what: str) -> None:
    bad = [w for w, (a, b) in enumerate(zip(got, exp)) if a != b]
    _require(not bad and len(got) == len(exp),
             f"grouped {what}: workers {bad} differ from the one-device run's")


SERVICE_TURN_RUNS = ("one", "grouped", "grouped", "one")


def service_turns(rows_per_worker: int = PAPER_ROWS_PER_WORKER,
                  lazy_rows_per_worker: int | None = None, device=None) -> list:
    """The service mix (``service_queries``, the scans over the paper's left
    table at ``rows_per_worker``) through ``QueryService(policy="fair",
    max_running=4)`` on one card and over a one-rank NCCL group joined in
    this process, in the turns of ``SERVICE_TURN_RUNS`` (the lazy tables at
    ``lazy_rows_per_worker``, the service path's by default): each run's wall,
    its sessions' summed morsel seconds (``device_s``), turns and morsels,
    and the count and host seconds of the group's ``broadcast_ints`` (the
    scheduler's decision log) and ``gather_workers`` calls. Every run's
    per-query digests must be equal. ``device="cpu"`` rehearses it over
    gloo."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core import DDF, DDFContext
    from repro_torch.core.comm import group
    from repro_torch.data import uniform_table, write_dataset
    from repro_torch.service import QueryService

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    group.init_from_env(device=device, timeout=GROUP_TIMEOUT_S)
    spent = {"broadcast_ints": [0, 0.0], "gather_workers": [0, 0.0]}
    originals = {name: getattr(group.WorkerBlock, name) for name in spent}

    def timed(name):
        def call(self, *a, **k):
            t = time.perf_counter()
            try:
                return originals[name](self, *a, **k)
            finally:
                if self.group is not None:
                    spent[name][0] += 1
                    spent[name][1] += time.perf_counter() - t
        return call

    for name in spent:
        setattr(group.WorkerBlock, name, timed(name))
    work = tempfile.mkdtemp(prefix="chip-smoke-service-turns-")
    runs, digests = [], []
    try:
        data = uniform_table(WORKERS * rows_per_worker, cardinality=0.9, n_cols=2, seed=1)
        ds = write_dataset(data, os.path.join(work, "left"), chunk_rows=STREAM_CHUNK_ROWS,
                           compress=False)
        del data
        left, right = paper_tables(WORKERS,
                                   lazy_rows_per_worker or SERVICE_LAZY_ROWS_PER_WORKER)
        for kind in SERVICE_TURN_RUNS:
            grouped = kind == "grouped"
            ctx = DDFContext(nworkers=WORKERS, device=device,
                             group=dist.group.WORLD if grouped else None)
            L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
            queries = service_queries(ds, ctx, L, R, {})
            for v in spent.values():
                v[0], v[1] = 0, 0.0
            _sync(ctx.device)
            t = time.perf_counter()
            with QueryService(policy="fair", max_running=SERVICE_MAX_RUNNING,
                              memory_budget_bytes=service_budget(queries),
                              ctx=ctx if grouped else None) as svc:
                handles = [svc.submit(q, label=n, **o) for n, _, q, o in queries]
                outs = [h.result(timeout=SERVICE_TIMEOUT_S) for h in handles]
            _sync(ctx.device)
            wall = time.perf_counter() - t
            sched = svc.stats()["scheduler"]
            rec = {"kind": kind, "wall_s": wall,
                   "device_s_sum": sum(h.device_s for h in handles),
                   "turns": sched["turns_total"], "morsels": sched["morsels_total"],
                   "records": spent["broadcast_ints"][0],
                   "records_s": spent["broadcast_ints"][1],
                   "gathers": spent["gather_workers"][0],
                   "gathers_s": spent["gather_workers"][1]}
            log(f"  {kind:8s} wall {wall:.3f} s, morsel seconds {rec['device_s_sum']:.3f}, "
                f"turns {rec['turns']}, morsels {rec['morsels']}, records {rec['records']} "
                f"({rec['records_s']:.3f} s), gathers {rec['gathers']} "
                f"({rec['gathers_s']:.3f} s)")
            runs.append(rec)
            digests.append([worker_digests(o) for o in outs])
            del outs, handles, queries, L, R, svc
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        _require(all(d == digests[0] for d in digests), "service turns: the runs' digests differ")
        log("  every run's per-query digests equal")
    finally:
        for name, fn in originals.items():
            setattr(group.WorkerBlock, name, fn)
        group.close()
        shutil.rmtree(work, ignore_errors=True)
    return runs


def check_grouped(rec: dict, one: dict) -> dict:
    """Hold the grouped record ``rec`` to the one-device runs ``one``
    (``main``, ``lazy``, ``stream``, ``service``): the same launches
    (``hash_partition_hist`` 0), the same join rows and every worker's
    digests equal; returns the launches summed over the grouped steps."""
    main, lazy, stream, service = rec["main"], rec["lazy"], rec["stream"], rec["service"]
    coltypes, one_coltypes = rec["coltypes"], one["coltypes"]
    pairs = [(f"column types {k}", coltypes["launches"].get(k, {}),
              one_coltypes["launches"].get(k, {})) for k in one_coltypes["launches"]]
    pairs += [("main path", main["launches"], one["main"]["launches"]),
             ("lazy collect", lazy["launches"], one["lazy"]["launches"]),
             ("service", service["launches"], one["service"]["concurrent"]["launches"])]
    pairs += [(f"stream {k}", stream["steps"][k]["launches"],
               one["stream"]["steps"][k]["launches"]) for k in ("killed", "resumed")]
    total: dict = {}
    for what, got, exp in pairs:
        _require(got == exp and got.get("hash_partition_hist", 0) == 0,
                 f"grouped {what}: launches {got} vs one device {exp}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    _require(main["join_rows"] == one["main"]["join_rows"],
             f"grouped join rows {main['join_rows']} vs one device {one['main']['join_rows']}")
    for step in GROUPED_STEPS:
        _same_digests(main["digests"][step], one["main"]["digests"][step], step)
    _require(coltypes["join_rows"] == one_coltypes["join_rows"],
             f"grouped column types join rows {coltypes['join_rows']} vs one device "
             f"{one_coltypes['join_rows']}")
    for step in COLTYPE_STEPS:
        _same_digests(coltypes["digests"][step], one_coltypes["digests"][step],
                      f"column types {step}")
    _same_digests(lazy["digests"], one["lazy"]["digests"], "lazy collect")
    _same_digests(stream["digests"], one["stream"]["digests"], "resumed streamed groupby")
    _require(set(service["digests"]) == set(one["service"]["digests"]),
             f"grouped service queries {sorted(service['digests'])}")
    for name, d in service["digests"].items():
        _same_digests(d, one["service"]["digests"][name], f"service {name}")
    return total


def run_grouped_phase(rows_per_worker: int, one: dict, dataset_dir: str) -> dict:
    """The main, lazy, streamed (killed and resumed) and service paths over a
    one-rank NCCL group on cuda:0, in a child process, held to the
    one-device runs ``one`` by :func:`check_grouped`; every overflow counter
    0 (each path checks its own). Prints each grouped time beside the one
    device's."""
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: its bootstrap stays on this host
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--grouped-rank",
                           "--rows-per-worker", str(rows_per_worker),
                           "--stream-dataset", dataset_dir],
                          capture_output=True, text=True, timeout=GROUPED_TIMEOUT_S,
                          env=env, cwd=HERE)
    wall = time.perf_counter() - t
    lines = proc.stdout.splitlines()
    for ln in lines[:-1]:
        log(f"  | {ln}")
    if proc.returncode != 0 or not lines or not lines[-1].startswith('{"grouped_paths"'):
        raise RuntimeError(f"the grouped rank failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    rec = json.loads(lines[-1])["grouped_paths"]
    total = check_grouped(rec, one)
    log(f"  launches as the one-card runs' (summed over the grouped steps: "
        f"{({k: v for k, v in total.items() if v})}, hash_partition_hist 0), every overflow "
        f"counter 0 (overflow_carry too), every worker's rows of the main path's steps, the "
        f"lazy collect, the resumed streamed groupby and each service query equal to the "
        f"one-card runs' (per-worker digests); child process {wall:.1f} s")
    main, one_main = rec["main"], one["main"]
    for step in GROUPED_STEPS:
        a, b = one_main["times_s"][step], main["times_s"][step]
        log(f"  {step:16s} one card {a * 1e3:10.1f} ms, over the one-rank NCCL group "
            f"{b * 1e3:10.1f} ms ({b / a:.2f}x)")
    for step, b in rec["coltypes"]["times_ms"].items():
        a = one["coltypes"]["times_ms"][step]
        log(f"  {step:22s} one card {a:10.1f} ms, over the one-rank NCCL group "
            f"{b:10.1f} ms ({b / a:.2f}x)")
    pairs = [("lazy collect", one["lazy"]["lazy_ms"], rec["lazy"]["lazy_ms"])]
    pairs += [(f"stream {k}", one["stream"]["steps"][k]["wall_ms"],
               rec["stream"]["steps"][k]["wall_ms"]) for k in ("killed", "resumed")]
    pairs.append(("service (10 q.)", one["service"]["concurrent"]["wall_s"] * 1e3,
                  rec["service"]["wall_s"] * 1e3))
    for what, a, b in pairs:
        log(f"  {what:16s} one card {a:10.1f} ms, over the one-rank NCCL group "
            f"{b:10.1f} ms ({b / a:.2f}x)")
    log(f"  service over the group: turns {rec['service']['turns_total']}, morsels "
        f"{rec['service']['morsels_total']} (one card: "
        f"{one['service']['concurrent']['turns_total']}, "
        f"{one['service']['concurrent']['morsels_total']}); peak device memory of the main "
        f"path {main['peak_bytes']} bytes ({main['peak_bytes'] / 2**30:.2f} GiB; one card "
        f"{one_main['peak_bytes'] / 2**30:.2f} GiB)")
    return {"wall_s": wall, "launches": total,
            "main": {"times_s": main["times_s"], "one_card_times_s": one_main["times_s"],
                     "peak_bytes": main["peak_bytes"], "join_rows": main["join_rows"]},
            "lazy_ms": rec["lazy"]["lazy_ms"], "coltypes_ms": rec["coltypes"]["times_ms"],
            "stream_ms": {k: rec["stream"]["steps"][k]["wall_ms"]
                          for k in ("killed", "resumed")},
            "service": {k: rec["service"][k] for k in ("wall_s", "turns_total",
                                                      "morsels_total")}}


# -- patterns path ------------------------------------------------------------------

STRING_ROWS_PER_WORKER = 125_000  # host-side vocabulary building sets the pace there
WINDOW = 8
SUM_RTOL = 1e-5  # float32 sums of up to 50M values below 2**30, against float64


def _live(ddf, name: str):
    """The live rows of one column in global order, as one device tensor."""
    import torch

    counts = ddf.counts.tolist()
    v = ddf.columns[name]
    return torch.cat([v[w, :c] for w, c in enumerate(counts)])


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _overflow_free(info: dict, what: str) -> None:
    for k, v in info.items():
        if k != "pivots":
            tot = int(v.sum().item())
            _require(tot == 0, f"{what}: {k} = {tot}")


def _windows_np(x, w: int, op: str):
    """numpy windowed reduction over the last ``w`` values ending at each
    row, for rows w-1.. (the rows with ``window_valid``)."""
    if op in ("sum", "mean"):
        cs = np.concatenate([[0], np.cumsum(x, dtype=np.int64)])
        s = cs[w:] - cs[:-w]
        return s.astype(np.float32) if op == "sum" else (s.astype(np.float32) / np.float32(w))
    view = np.lib.stride_tricks.sliding_window_view(x, w)
    return (view.min(axis=1) if op == "min" else view.max(axis=1)).astype(np.float32)


class _Steps:
    """The steps of one window of the patterns path: each runs with the
    launch counts at 0 and ``synchronize`` on both sides of its wall time,
    and must launch the kernels it names (on the CPU, none, unless
    ``expect_on_cpu``: a test that counts the dispatch points there) and
    leave every overflow counter at 0."""

    expect_on_cpu = False

    def __init__(self, ctx):
        import torch

        self.on_card = ctx.device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.on_card else (lambda: None)
        self.times, self.launches = {}, {}

    def __call__(self, name, fn, hash_partition=0, segment_reduce=0):
        from repro_torch.kernels import registry

        want = {k: 0 for k in registry.KERNEL_OPS}
        if self.on_card or self.expect_on_cpu:
            want.update(hash_partition=hash_partition, segment_reduce=segment_reduce)
        registry.reset_launch_counts()
        self.sync()
        t = time.perf_counter()
        out = fn()
        self.sync()
        self.times[name] = (time.perf_counter() - t) * 1e3
        self.launches[name] = registry.launch_counts()
        expect_launches(self.launches[name], want, name)
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
            _overflow_free(out[1], name)
        return out

    def result(self) -> dict:
        return {"times_ms": self.times,
                "launches": {k: {n: c for n, c in v.items() if c}
                             for k, v in self.launches.items()}}


def run_table_steps(P: int, rows_per_worker: int, left, right, device="cuda",
                    check: bool = True) -> dict:
    """The patterns path's steps on the main path's tables: every step
    timed, its launch counts asserted, its overflow counters at 0 and
    (``check``) its result held against a numpy oracle, whose host work
    stays out of the run when ``check`` is off."""
    import torch

    from repro_torch.core import DDF, DDFContext
    from repro_torch.expr import col

    ctx = DDFContext(nworkers=P, device=device)
    step = _Steps(ctx)
    if step.on_card:
        torch.cuda.reset_peak_memory_stats()
    L = step("from_numpy_left", lambda: DDF.from_numpy(left, ctx))
    R = step("from_numpy_right", lambda: DDF.from_numpy(right, ctx))
    S = step("select", lambda: L.select(col("c1") < 2**30))
    S = step("with_column_b", lambda: S.with_column("b", col("c1") & 1))
    S = step("with_column_s", lambda: S.with_column("s", col("c1") % 2**20))
    n_sel = S.num_rows()
    if check:
        n_keys = max(int(len(left["c0"]) * 0.9), 1)
        sel = left["c1"] < 2**30
        c1_sel = left["c1"][sel]
        _require(n_sel == int(sel.sum()), f"select kept {n_sel} rows, oracle {int(sel.sum())}")
        _require(np.array_equal(_live(S, "c0").cpu().numpy(), left["c0"][sel]),
                 "select: rows or their order differ from the oracle's")
        _require(np.array_equal(_live(S, "b").cpu().numpy(), c1_sel & 1), "with_column b")
        _require(np.array_equal(_live(S, "s").cpu().numpy(), c1_sel % 2**20),
                 "with_column s")
    per_worker = S.counts.tolist()

    # quota: ceil(rows / P), the most any destination receives (the default,
    # the whole capacity, would make each worker's output P times larger)
    B, _ = step("rebalance", lambda: S.rebalance(quota=-(-n_sel // P)))
    if check:
        _require(B.counts.tolist() == [n_sel // P + (w < n_sel % P) for w in range(P)],
                 f"rebalance counts {B.counts.tolist()}")
        _require(torch.equal(_live(B, "c0"), _live(S, "c0")) and
                 torch.equal(_live(B, "c1"), _live(S, "c1")), "rebalance changed the order")
    del B

    if check:
        row_key = (_live(S, "c0").to(torch.int64) << 31) | _live(S, "c1").to(torch.int64)
        rows_sorted = torch.sort(row_key).values
        del row_key
    for desc in (False, True):
        name = "sort_desc" if desc else "sort"
        O, oinfo = step(name, lambda: S.sort_values("c0", descending=desc))
        if check:
            k = _live(O, "c0")
            _require(bool(((k[1:] <= k[:-1]) if desc else (k[1:] >= k[:-1])).all()),
                     f"{name}: not globally sorted")
            got = torch.sort((k.to(torch.int64) << 31) | _live(O, "c1").to(torch.int64)).values
            _require(torch.equal(got, rows_sorted), f"{name}: rows differ from the input's")
            _require(tuple(oinfo["pivots"].shape) == (P, P - 1), f"{name}: pivots shape")
        del O, oinfo
    if check:
        del rows_sorted

    U, _ = step("union", lambda: S.project(["c0", "c1"]).union(R, on=("c0",)),
                hash_partition=1)
    if check:
        present_s = np.zeros(n_keys, bool)
        present_s[left["c0"][sel]] = True
        present_r = np.zeros(n_keys, bool)
        present_r[right["c0"]] = True
        u = _live(U, "c0").cpu().numpy()
        exp = np.nonzero(present_s | present_r)[0]  # np.union1d of the key sets
        got = np.zeros(n_keys, bool)
        got[u] = True
        _require(len(u) == len(exp) and np.array_equal(np.nonzero(got)[0], exp),
                 f"union: {len(u)} keys, oracle {len(exp)}")
    del U
    D, _ = step("difference", lambda: S.difference(R, on=("c0",)), hash_partition=2)
    if check:
        d = _live(D, "c0").cpu().numpy()
        exp = np.nonzero(present_s & ~present_r)[0]  # np.setdiff1d of the key sets
        got = np.zeros(n_keys, bool)
        got[d] = True
        _require(len(d) == len(exp) and np.array_equal(np.nonzero(got)[0], exp),
                 f"difference: {len(d)} keys, oracle {len(exp)}")
        del present_s, present_r
    del D

    aggs = {op: step(f"agg_{op}", lambda: S.agg("c1", op))
            for op in ("sum", "min", "max", "mean", "count")}
    length = step("length", S.length)
    if check:
        exact = {"min": c1_sel.min(), "max": c1_sel.max(), "count": n_sel}
        for op, v in exact.items():
            _require(int(aggs[op]) == int(v), f"agg {op} {aggs[op]} vs oracle {v}")
        _require(length == n_sel, f"length {length} vs {n_sel}")
        s64 = float(c1_sel.astype(np.float64).sum())
        for op, ref in (("sum", s64), ("mean", s64 / n_sel)):
            err = abs(float(aggs[op]) - ref) / abs(ref)
            _require(err <= SUM_RTOL, f"agg {op} relative error {err} > {SUM_RTOL}")
            log(f"  agg {op}: float32 {float(aggs[op])!r} vs float64 {ref!r}, relative error "
                f"{err:.3e} (tolerance {SUM_RTOL})")
        s_np = (c1_sel % 2**20).astype(np.int64)
        gidx = np.arange(n_sel) >= WINDOW - 1

    for op in ("sum", "mean", "min", "max"):
        W, winfo = step(f"rolling_s_{op}", lambda: S.rolling("s", WINDOW, op))
        if check:
            _require(not bool(winfo["halo_short"].any()), f"rolling {op}: a short halo")
            _require(np.array_equal(_live(W, "window_valid").cpu().numpy(), gidx),
                     f"rolling {op}: window_valid")
            got = _live(W, f"s_roll{op}").cpu().numpy()[WINDOW - 1:]
            _require(np.array_equal(got, _windows_np(s_np, WINDOW, op)),
                     f"rolling {op} differs from the oracle")
        del W
    W, winfo = step("rolling_sum_b", lambda: S.rolling_sum("b", WINDOW))
    if check:
        got = _live(W, "b_rollsum").cpu().numpy()[WINDOW - 1:]
        _require(np.array_equal(got, _windows_np(s_np & 1, WINDOW, "sum")),
                 "rolling_sum differs from the oracle")
        del s_np, gidx
    del W

    H = step("head", lambda: S.head(1000))
    if check:
        _require(np.array_equal(_live(H, "c0").cpu().numpy(), left["c0"][sel][:1000]),
                 "head(1000) differs from the first 1000 rows")
    del H

    G, _ = step("groupby_exprs", lambda: S.groupby(
        ("c0",), [col("c1").max(), col("c1").mean().alias("avg")]),
        hash_partition=1, segment_reduce=6)
    if check:
        k = left["c0"][sel].astype(np.int64)
        cnt = np.bincount(k, minlength=n_keys)
        tot = np.bincount(k, weights=c1_sel.astype(np.float64), minlength=n_keys)
        mx = np.full(n_keys, np.iinfo(np.int32).min, np.int32)
        np.maximum.at(mx, k, c1_sel)
        keys = np.nonzero(cnt)[0]
        s32 = tot[keys].astype(np.int64).astype(np.int32)  # the engine's int32 sum wraps
        g = G.to_numpy()
        order = np.argsort(g["c0"], kind="stable")
        _require(set(g) == {"c0", "c1_max", "avg"}, f"groupby columns {sorted(g)}")
        _require(np.array_equal(g["c0"][order], keys), "groupby keys")
        _require(np.array_equal(g["c1_max"][order], mx[keys]), "groupby max")
        _require(np.array_equal(g["avg"][order],
                                s32.astype(np.float32) / cnt[keys].astype(np.float32)),
                 "groupby mean")
    del G

    small = {"a": np.arange(P * 64, dtype=np.int32), "b": np.arange(P * 64) / 4,
             "c": (np.arange(P * 64) % 7).astype(np.int16), "d": np.arange(P * 64) % 2 == 0}
    M = DDF.from_numpy(small, ctx)
    T = step("transpose", M.transpose)
    if check:
        mat = np.stack([small[k].astype(np.float32) for k in sorted(small)])
        _require(T.counts.tolist() == [4] * P, f"transpose counts {T.counts.tolist()}")
        for i in range(P * 64):
            _require(np.array_equal(T.columns[f"r{i}"].cpu().numpy(), np.tile(mat[:, i], (P, 1))),
                     f"transpose column r{i}")
    del M, T, S, L, R
    peak = torch.cuda.max_memory_allocated() if step.on_card else 0
    return {"rows_per_worker": rows_per_worker, "workers": P, "selected_rows": n_sel,
            "selected_per_worker": per_worker, **step.result(), "peak_bytes": peak,
            "aggs": {k: float(v) for k, v in aggs.items()}}


def string_tables(P: int, left, right, device="cuda"):
    """Dict-encoded string-keyed tables of ``STRING_ROWS_PER_WORKER`` rows
    per worker from the first rows of the main path's tables: host-side
    formatting and vocabulary building, then the copy to the device."""
    from repro_torch.core import DDF, DDFContext

    ctx = DDFContext(nworkers=P, device=device)
    n2 = P * STRING_ROWS_PER_WORKER
    kl, kr = left["c0"][:n2] % (n2 * 9 // 10), right["c0"][:n2] % (n2 * 9 // 10)
    sl, sr = np.char.mod("key%08d", kl), np.char.mod("key%08d", kr)
    return {"L": DDF.from_numpy({"s": sl, "x": left["c1"][:n2]}, ctx),
            "R": DDF.from_numpy({"s": sr, "y": right["c1"][:n2]}, ctx),
            "kl": kl, "kr": kr, "sl": sl, "sr": sr}


def run_string_steps(tables: dict, check: bool = True) -> dict:
    """A string-keyed join and union on ``string_tables``: vocabularies
    unified at each binary operator, launches asserted, overflow counters
    at 0 and (``check``) held against numpy."""
    L2, R2 = tables["L"], tables["R"]
    step = _Steps(L2.ctx)
    J, _ = step("join_string", lambda: L2.join(R2, on=("s",), strategy="shuffle"),
                hash_partition=2)
    U2, _ = step("union_string", lambda: L2.project(["s"]).union(R2.project(["s"]), on=("s",)),
                 hash_partition=1)
    if check:
        kl, kr, n2 = tables["kl"], tables["kr"], len(tables["kl"])
        cl = np.bincount(kl, minlength=n2)
        cr = np.bincount(kr, minlength=n2)
        want_rows = int((cl.astype(np.int64) * cr).sum())
        _require(J.num_rows() == want_rows, f"string join rows {J.num_rows()} vs {want_rows}")
        words, counts = np.unique(J.to_numpy()["s"], return_counts=True)
        both = np.nonzero(cl * cr)[0]
        _require(np.array_equal(words, np.char.mod("key%08d", both)) and
                 np.array_equal(counts, (cl * cr)[both]), "string join keys")
        _require(np.array_equal(np.sort(U2.to_numpy()["s"]),
                                np.union1d(tables["sl"], tables["sr"])), "string union keys")
    return step.result()


def coltype_tables(P: int, rows_per_worker: int, seed: int = 7) -> tuple[dict, dict]:
    """Two tables of uint32 keys at cardinality 0.9 over the whole uint32
    range (distinct ids times an odd constant modulo 2**32: half the keys
    lie at or above 2**31, where unsigned and signed order differ), a
    uint32 value ``u`` over the whole range (sums wrap), a (n, 4) float32
    payload ``vec`` on the left and a uint32 ``w`` on the right."""
    n = P * rows_per_worker
    rng = np.random.default_rng(seed)
    n_keys = max(int(n * 0.9), 1)

    def keys():
        ids = rng.integers(0, n_keys, n, dtype=np.uint64)
        return ((ids * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def u32():
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)

    left = {"k": keys(), "u": u32(),
            "vec": rng.standard_normal((n, COLTYPE_WIDTH)).astype(np.float32)}
    return left, {"k": keys(), "w": u32()}


def row_fingerprints(cols: dict) -> np.ndarray:
    """A 64-bit fingerprint of each row over every 32-bit word of every
    column (in name order), so that two row multisets are equal by bits when
    their sorted fingerprints are (up to a 64-bit collision)."""
    h = None
    for k in sorted(cols):
        v = np.ascontiguousarray(cols[k])
        words = v.reshape(len(v), -1).view(np.uint32).astype(np.uint64)
        for j in range(words.shape[1]):
            x = words[:, j] if h is None else h ^ words[:, j]
            x = (x ^ (x >> np.uint64(29))) * np.uint64(0xBF58476D1CE4E5B9)
            h = x ^ (x >> np.uint64(32))
    return h


def coltype_oracle(left: dict, right: dict) -> dict:
    """numpy's answers for :func:`run_coltype_steps`: the join's sorted row
    fingerprints, the groupby's per-key wrapping sum, min and max in key
    order, the sorted keys, the left rows' fingerprints and distinct keys."""
    korder = argsort32(left["k"])
    ks, us = left["k"][korder], left["u"][korder]
    order = argsort32(right["k"])
    rk = right["k"][order]
    # each left row's run of equal right keys, searched in key order
    lo = np.searchsorted(rk, ks, side="left")
    cnt = np.searchsorted(rk, ks, side="right") - lo
    li = korder[np.repeat(np.arange(len(cnt)), cnt)]
    ri = order[np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(int(cnt.sum()))]
    joined = {"k": left["k"][li], "u": left["u"][li], "vec": left["vec"][li],
              "w": right["w"][ri]}
    starts = np.nonzero(np.r_[True, ks[1:] != ks[:-1]])[0]
    return {"join": np.sort(row_fingerprints(joined)), "join_rows": int(cnt.sum()),
            "keys": ks[starts],
            "u_sum": (np.add.reduceat(us.astype(np.uint64), starts)
                      & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            "u_min": np.minimum.reduceat(us, starts), "u_max": np.maximum.reduceat(us, starts),
            "sorted": ks, "left": np.sort(row_fingerprints(left))}


def desc_sorted(keys: np.ndarray, pivots: np.ndarray) -> np.ndarray:
    """uint32 ``keys`` in the order a descending sample sort with these
    ``pivots`` gives them, the reference's rule: each key goes to the
    worker ``searchsorted(-pivots, -key)`` picks, its negation wrapping
    modulo 2**32 (so a key of 0 goes to worker 0, after its larger keys),
    and each worker's keys in descending order."""
    neg = lambda x: (-x.astype(np.int64)) & 0xFFFFFFFF  # noqa: E731
    dest = np.searchsorted(neg(pivots), neg(keys), side="left")
    return keys[np.lexsort((-keys.astype(np.int64), dest))]


def run_coltype_steps(P: int, rows_per_worker: int, device="cuda", group=None,
                      check: bool = True) -> dict:
    """uint32 keys and a vector payload through the engine: a shuffle join
    of two :func:`coltype_tables` (the (n, 4) float32 ``vec`` carried), a
    groupby of the uint32 ``u`` by the key (sum wrapping modulo 2**32, min,
    max), ``sort_values`` of the key both ways and ``unique``, each with
    the launch counts of the int32 steps (hash_partition 2 for the join, 1
    for the groupby and unique, segment_reduce 6 for the groupby, never the
    histogram) and every overflow counter at 0; ``check`` holds each result
    to :func:`coltype_oracle` by bits. Over ``group`` (one rank's block)
    the per-worker digests are what a caller holds to one card's."""
    import torch

    from repro_torch.core import DDF, DDFContext

    ctx = DDFContext(nworkers=P, device=device, group=group)
    step = _Steps(ctx)
    left, right = coltype_tables(P, rows_per_worker)
    L, R = step("coltype_from_numpy", lambda: (DDF.from_numpy(left, ctx),
                                               DDF.from_numpy(right, ctx)))
    J, _ = step("coltype_join", lambda: L.join(R, on=("k",), strategy="shuffle"),
                hash_partition=2)
    G, _ = step("coltype_groupby", lambda: L.groupby(
        ("k",), {"u": ("sum", "min", "max")}, pre_combine=True), hash_partition=1,
        segment_reduce=6)
    S, _ = step("coltype_sort", lambda: L.sort_values("k"))
    D, dinfo = step("coltype_sort_desc", lambda: L.sort_values("k", descending=True))
    U, _ = step("coltype_unique", lambda: L.unique(("k",)), hash_partition=1)
    outs = dict(zip(COLTYPE_STEPS, (J, G, S, D, U)))
    res = {"rows_per_worker": rows_per_worker, "workers": P, **step.result(),
           "join_rows": J.num_rows(),
           "digests": {k: worker_digests(v) for k, v in outs.items()}}
    if group is not None or not check:
        return res
    t = time.perf_counter()
    exp = coltype_oracle(left, right)
    j = J.to_numpy()
    _require(j["vec"].shape == (exp["join_rows"], COLTYPE_WIDTH) and j["k"].dtype == np.uint32,
             f"coltype join: {j['vec'].shape} {j['k'].dtype}")
    _require(np.array_equal(np.sort(row_fingerprints(j)), exp["join"]),
             "coltype join: rows differ from the oracle's")
    g = G.to_numpy()
    _require_bits(g, {"k": exp["keys"], "u_sum": exp["u_sum"], "u_min": exp["u_min"],
                      "u_max": exp["u_max"]}, "coltype groupby", sort_by="k")
    desc = desc_sorted(exp["sorted"], dinfo["pivots"][0].cpu().numpy())
    for name, ddf, keys in (("sort", S, exp["sorted"]), ("sort_desc", D, desc)):
        got = ddf.to_numpy()
        _require(got["k"].dtype == np.uint32 and np.array_equal(got["k"], keys),
                 f"coltype {name}: keys not in unsigned order")
        _require(np.array_equal(np.sort(row_fingerprints(got)), exp["left"]),
                 f"coltype {name}: rows differ from the input's")
    u = U.to_numpy()
    _require(np.array_equal(np.sort(u["k"]), exp["keys"]), "coltype unique: keys")
    _require(bool(np.isin(row_fingerprints(u), exp["left"]).all()),
             "coltype unique: a row that is not an input row")
    log(f"  column types: {exp['join_rows']} joined rows, {len(exp['keys'])} groups and keys, "
        f"every result equal to numpy by bits (checked in {time.perf_counter() - t:.1f} s)")
    del J, G, S, D, U, L, R
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return res


def run_patterns_path(P: int, rows_per_worker: int, left, right, device="cuda",
                      check: bool = True, coltype_rows_per_worker: int = COLTYPE_ROWS_PER_WORKER
                      ) -> dict:
    """The rest of the eager DDF at the main path's configuration: the
    steps on the main path's tables, then the string-keyed join and union
    at ``STRING_ROWS_PER_WORKER``. On the CPU no kernel launches, so every
    count must be 0 there."""
    res = run_table_steps(P, rows_per_worker, left, right, device, check)
    t = time.perf_counter()
    tables = string_tables(P, left, right, device)
    string_ms = (time.perf_counter() - t) * 1e3
    strings = run_string_steps(tables, check)
    del tables
    coltypes = run_coltype_steps(P, coltype_rows_per_worker, device, check=check)
    res["times_ms"].update(string_tables=string_ms, **strings["times_ms"],
                           **coltypes["times_ms"])
    res["launches"].update(strings["launches"], **coltypes["launches"])
    res["string_rows_per_worker"] = STRING_ROWS_PER_WORKER
    res["coltypes"] = coltypes
    for name, ms in res["times_ms"].items():
        log(f"  {name:18s} {ms:10.1f} ms")
    log(f"  peak device memory (12.5M-row steps): {res['peak_bytes']} bytes "
        f"({res['peak_bytes'] / 2**30:.2f} GiB)")
    log("  every overflow counter is 0; launches as expected: hash_partition 1 per union, "
        "2 per difference and join, segment_reduce 6 in the groupby, none elsewhere; the "
        f"column-types step (uint32 keys, a (n, {COLTYPE_WIDTH}) float32 payload) at "
        f"{coltype_rows_per_worker} rows per worker launches as the int32 steps")
    return res


# -- lazy path ----------------------------------------------------------------------

LAZY_SELECT, LAZY_FLAG = 2**30, 2**29  # README's lazy example, with int32 thresholds


def _lazy_steps(L, R, X=None):
    """The README's lazy example on (L, R) as a LazyDDF: select, with_column,
    project, a shuffle join and a groupby on the join key. ``X`` is the
    expression module of the DDFs' package (the port's by default)."""
    if X is None:
        from repro_torch import expr as X
    col, when = X.col, X.when
    return (L.lazy().select(col("c1") < LAZY_SELECT)
            .with_column("c2", when(col("c1") < LAZY_FLAG).then(1).otherwise(0))
            .project(["c0", "c1", "c2"])
            .join(R.lazy(), on=("c0",), strategy="shuffle")
            .groupby(("c0",), _lazy_aggs(X)))


def _lazy_aggs(X=None):
    if X is None:
        from repro_torch import expr as X
    col = X.col
    return [col("c1").sum(), col("c1").min(), col("c1").max(), col("c1").count(),
            col("c1").mean().alias("avg"), col("c2").sum()]


def _launches_of_plan(plan) -> dict:
    """The kernel launches an optimized plan implies: hash_partition once per
    side of a kept join shuffle and once per other kept keyed shuffle;
    segment_reduce once per distinct partial of a groupby (a mean is a sum
    and a count), twice that when it pre-combines before its shuffle."""
    from repro_torch.plan import logical

    want = {"hash_partition": 0, "segment_reduce": 0}
    for node in logical.walk(plan):
        if isinstance(node, (logical.Join, logical.Difference)):
            if getattr(node, "strategy", "shuffle") == "shuffle" and not getattr(
                    node, "elide_shuffle", False):
                want["hash_partition"] += 2
        elif isinstance(node, (logical.GroupBy, logical.Unique, logical.Union)):
            if not node.elide_shuffle:
                want["hash_partition"] += 1
        if isinstance(node, logical.GroupBy):
            parts = set()
            for c, ops_ in node.aggs:
                for o in ops_:
                    parts |= {(c, "sum"), (c, "count")} if o == "mean" else {(c, o)}
            legs = 2 if node.pre_combine and not node.elide_shuffle else 1
            want["segment_reduce"] += legs * len(parts)
    return want


def run_lazy_path(P: int, left, right, device="cuda", group=None) -> dict:
    """The lazy path on the main path's tables: the optimized plan shown and
    checked (the predicate below the join, the groupby's shuffle elided, one
    shuffle), one collect with the launch counts at 0 that must launch what
    the plan implies and leave every overflow counter at 0, a second collect
    that must hit the plan and op caches, then the same steps eagerly, whose
    ``to_numpy()`` must be the lazy result's bit for bit. On the CPU no
    kernel launches. With ``group`` it runs over that process group (the
    context's default device unless ``device`` is given); the result holds
    the first collect's per-worker digests (``worker_digests``)."""
    import torch

    from repro_torch.core import DDF, DDFContext
    from repro_torch.expr import col, when
    from repro_torch.kernels import registry
    from repro_torch.plan import executor

    ctx = DDFContext(nworkers=P, device=device, group=group)
    on_card = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
    lazy = _lazy_steps(L, R)
    text = lazy.explain()
    for line in text.splitlines():
        log(f"  | {line}")
    lines = text.splitlines()
    join = next(i for i, ln in enumerate(lines) if ln.lstrip().startswith("JOIN"))
    depth = len(lines[join]) - len(lines[join].lstrip())
    sel = next((i for i, ln in enumerate(lines) if f"select[(c1 < {LAZY_SELECT})]" in ln), -1)
    _require(sel > join and len(lines[sel]) - len(lines[sel].lstrip()) > depth,
             "lazy plan: the predicate is not below the join")
    _require(any(ln.lstrip().startswith("GROUPBY") and "elide_shuffle" in ln for ln in lines),
             "lazy plan: the groupby's shuffle is not elided")
    _require(lines[-1] == "shuffles: 1", f"lazy plan: {lines[-1]}")
    plan = executor.optimized_plan(lazy.plan, ctx, lazy._rows())
    want = {k: 0 for k in registry.KERNEL_OPS}
    plan_want = {**want, **_launches_of_plan(plan)}
    if on_card:
        want = plan_want

    registry.reset_launch_counts()
    sync()
    t = time.perf_counter()
    out = lazy.collect()
    sync()
    lazy_s = time.perf_counter() - t
    launches = registry.launch_counts()
    if any(launches.values()):  # counted on the CPU too (a rehearsal wraps the dispatch points)
        want = plan_want
    expect_launches(launches, want, "lazy collect")
    _overflow_free(lazy.last_info, "lazy collect")
    digests = worker_digests(out)
    before = executor.cache_stats()
    registry.reset_launch_counts()
    sync()
    t = time.perf_counter()
    again = _lazy_steps(L, R).collect()
    sync()
    lazy_again_s = time.perf_counter() - t
    after = executor.cache_stats()
    expect_launches(registry.launch_counts(), want, "second lazy collect")
    for cache in ("plan", "op"):
        _require(after[cache]["hits"] == before[cache]["hits"] + 1
                 and after[cache]["misses"] == before[cache]["misses"],
                 f"second lazy collect: {cache} cache {before[cache]} -> {after[cache]}")
    got = out.to_numpy()
    _require(all(np.array_equal(got[k], v) for k, v in again.to_numpy().items()),
             "second lazy collect differs from the first")
    del out, again
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    sync()
    t = time.perf_counter()
    E = (L.select(col("c1") < LAZY_SELECT)
         .with_column("c2", when(col("c1") < LAZY_FLAG).then(1).otherwise(0))
         .project(["c0", "c1", "c2"]))
    EJ, jinfo = E.join(R, on=("c0",), strategy="shuffle")
    del E
    EG, ginfo = EJ.groupby(("c0",), _lazy_aggs())
    del EJ
    sync()
    eager_s = time.perf_counter() - t
    _overflow_free({**jinfo, **{f"groupby_{k}": v for k, v in ginfo.items()}}, "eager steps")
    exp = EG.to_numpy()
    del EG, L, R
    _require(sorted(got) == sorted(exp), f"lazy columns {sorted(got)} vs eager {sorted(exp)}")
    for k, v in exp.items():
        g = got[k]
        same = g.dtype == v.dtype and g.shape == v.shape and np.array_equal(
            g.view(np.int32) if g.dtype.kind == "f" else g,
            v.view(np.int32) if v.dtype.kind == "f" else v)
        _require(same, f"lazy {k} differs from eager by bits")
    _require(bool(np.isfinite(got["avg"]).all()), "lazy avg has non-finite values")
    groups = int(len(got["c0"]))
    log(f"  lazy collect {lazy_s * 1e3:.1f} ms (again, plan and op caches hit: "
        f"{lazy_again_s * 1e3:.1f} ms), the same steps eagerly {eager_s * 1e3:.1f} ms; "
        f"{groups} groups, identical by bits; peak device memory of the lazy collects "
        f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    log(f"  launches of the lazy collect: {({k: v for k, v in launches.items() if v})} "
        f"(the plan implies {({k: v for k, v in want.items() if v})}); every overflow "
        f"counter is 0")
    return {"workers": P, "plan": lines, "lazy_ms": lazy_s * 1e3,
            "lazy_again_ms": lazy_again_s * 1e3, "eager_ms": eager_s * 1e3,
            "launches": launches, "groups": groups, "peak_bytes": peak,
            "caches": after, "digests": digests}


# -- streaming path -----------------------------------------------------------------

STREAM_CHUNK_ROWS = 1_048_576
STREAM_SMALL_ROWS_PER_WORKER = 1_000_000  # the sort and the spill join: host numpy sets their pace
STREAM_CSV_ROWS = 1_000_000  # Python's CSV parser sets the pace there
STREAM_AGG_NAMES = ("c0", "c1_sum", "c1_min", "c1_max", "c1_count", "avg", "c2_sum")


def _readme_ep(lazy):
    """The EP part of the README's lazy example: over a scan, the predicate
    is absorbed into the scan (evaluated on the host before the rows are
    copied to the card)."""
    from repro_torch.expr import col, when

    return (lazy.select(col("c1") < LAZY_SELECT)
            .with_column("c2", when(col("c1") < LAZY_FLAG).then(1).otherwise(0)))


def _groupby_oracle(c0, c1) -> dict:
    """The streamed groupby's result in numpy, sorted by key: per key of the
    rows with c1 < 2**30, the int32 sum (wrapped), min, max and count of
    c1, mean = float32(sum) / float32(count), and the sum of c2."""
    keep = c1 < LAZY_SELECT
    k, v = c0[keep], c1[keep]
    order = argsort32(k)
    k, v = k[order], v[order]
    start = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    cnt = np.diff(np.r_[start, len(k)]).astype(np.int32)
    s = np.add.reduceat(v.astype(np.int64), start).astype(np.int32)  # wraps like the engine
    return {"c0": k[start], "c1_sum": s, "c1_min": np.minimum.reduceat(v, start),
            "c1_max": np.maximum.reduceat(v, start), "c1_count": cnt,
            "avg": s.astype(np.float32) / cnt.astype(np.float32),
            "c2_sum": np.add.reduceat((v < LAZY_FLAG).astype(np.int32), start).astype(np.int32)}


def _require_bits(got: dict, exp: dict, what: str, sort_by: str | None = None) -> None:
    """``got`` equals ``exp`` column by column, dtype and bits (after sorting
    ``got`` by ``sort_by`` when given)."""
    _require(sorted(got) == sorted(exp), f"{what}: columns {sorted(got)} vs {sorted(exp)}")
    order = argsort32(got[sort_by]) if sort_by else slice(None)  # unique keys
    for k, e in exp.items():
        g = got[k][order]
        same = g.dtype == e.dtype and g.shape == e.shape and np.array_equal(
            g.view(np.uint8), e.view(np.uint8))
        _require(same, f"{what}.{k}: {g.dtype}{g.shape} vs {e.dtype}{e.shape} differ")


class _StreamSteps:
    """The streaming path's steps: each runs with the launch counts at 0 and
    the peak memory reset, ``synchronize`` on both sides of its wall time,
    and records what it launched and the run's chunk counters."""

    def __init__(self, ctx):
        import torch

        self.on_card = ctx.device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.on_card else (lambda: None)
        self.res: dict = {}

    def __call__(self, name, fn, shuffles: bool):
        """Run ``fn() -> (result, info)``. On the card a step with shuffles
        must launch hash_partition and segment_reduce; every step must
        launch no ``hash_partition_hist`` (the histogram the runner needs is
        built on the host), and a step without shuffles launches nothing."""
        import torch

        from repro_torch.kernels import registry

        registry.reset_launch_counts()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        self.sync()
        t = time.perf_counter()
        out, info = fn()
        self.sync()
        wall = time.perf_counter() - t
        launches = registry.launch_counts()
        _require(launches["hash_partition_hist"] == 0,
                 f"{name}: hash_partition_hist launched {launches['hash_partition_hist']} times")
        if self.on_card and shuffles:
            _require(launches["hash_partition"] > 0 and launches["segment_reduce"] > 0,
                     f"{name}: launches {launches}")
        elif not shuffles:
            _require(not any(launches.values()), f"{name}: launches {launches}")
        info = info or {}
        over = {k: int(np.sum(v)) for k, v in info.items() if "overflow" in k}
        _require(not any(over.values()), f"{name}: overflow {over}")
        peak = torch.cuda.max_memory_allocated() if self.on_card else 0
        row = {"wall_ms": wall * 1e3, "peak_bytes": peak,
               "launches": {k: launches[k] for k in DATAFRAME_KERNELS + ("hash_partition_hist",)},
               "overflow_counters": len(over)}
        for k in ("batches", "chunks_decoded", "chunks_skipped", "checkpoints"):
            if k in info:
                row[k] = int(info[k])
        self.res[name] = row
        log(f"  {name:16s} {wall * 1e3:10.1f} ms  peak {peak / 2**30:6.2f} GiB  launches "
            f"{row['launches']}  " + ", ".join(f"{k} {row[k]}" for k in
                                               ("batches", "chunks_decoded", "chunks_skipped",
                                                "checkpoints") if k in row))
        return out


def _stream_query(ds, ctx, scan_kw):
    """The streamed groupby of the streaming path: the README's lazy example
    without its join over ``scan_dataset``."""
    from repro_torch.stream import scan_dataset

    return _readme_ep(scan_dataset(ds, ctx, **scan_kw)).groupby(("c0",), _lazy_aggs())


def run_stream_path(P: int, rows_per_worker: int, device="cuda",
                    small_rows_per_worker: int = STREAM_SMALL_ROWS_PER_WORKER,
                    csv_rows: int = STREAM_CSV_ROWS, chunk_rows: int = STREAM_CHUNK_ROWS,
                    memory_budget_bytes: float | None = None,
                    profile_path: str | None = None, dataset_dir: str | None = None) -> dict:
    """The streaming path: the paper's left table (``uniform_table``,
    cardinality 0.9, seed 1, int32 c0 and c1, ``rows_per_worker`` rows per
    worker) written uncompressed as a chunked dataset in a temporary
    directory, then

    - the README's lazy example without its join, streamed: ``scan_dataset``
      -> ``select(col("c1") < 2**30)`` (absorbed into the scan) ->
      ``with_column("c2", ...)`` -> ``groupby("c0")`` -> ``collect_stream()``
      at the cost model's batch size (at least 4 batches), against a numpy
      oracle, every overflow counter (``overflow_carry`` too) at 0;
    - the same query killed at half its batches (``FaultPlan(kill_after=
      {"device_op": nb // 2})``, traced for the cost-model check) with
      checkpoints, then resumed: equal by bits, the store cleared;
    - ``to_batches`` of its EP part against the numpy filter;
    - a streamed sort and a scan x scan spill join + groupby at
      ``small_rows_per_worker`` (the right table: seed 2), against numpy;
    - ``scan_csv`` of ``csv_rows`` rows of the left table, then the
      streamed groupby;
    - with ``profile_path``, one more streamed groupby collect under
      ``torch.profiler`` (``_profile``), on the same dataset.

    With ``dataset_dir`` the left table's dataset is written there and kept
    (the grouped phase scans it again); the result holds the streamed
    groupby's per-worker digests (``worker_digests``).

    Each step runs with the launch counts at 0 (see ``_StreamSteps``). On
    the CPU (``device="cpu"``) it rehearses the same steps at any size."""
    import shutil
    import tempfile

    import torch

    from repro_torch import obs
    from repro_torch.core import DDFContext
    from repro_torch.data import uniform_table, write_dataset
    from repro_torch.data.dataset import read_chunk
    from repro_torch.plan import logical
    from repro_torch.stream import StreamCheckpoint, scan_csv, scan_dataset
    from repro_torch.testing import FaultPlan, InjectedFault, fault_scope

    ctx = DDFContext(nworkers=P, device=device)
    steps = _StreamSteps(ctx)
    n = P * rows_per_worker
    work = tempfile.mkdtemp(prefix="chip-smoke-stream-")
    scan_kw = {} if memory_budget_bytes is None else {"memory_budget_bytes": memory_budget_bytes}
    try:
        free = shutil.disk_usage(work).free
        log(f"  work directory {work}: {free / 2**30:.1f} GiB free")
        t = time.perf_counter()
        data = uniform_table(n, cardinality=0.9, n_cols=2, seed=1)
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        ds = write_dataset(data, dataset_dir or os.path.join(work, "left"),
                           chunk_rows=chunk_rows, compress=False)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(len(ds.chunks)):
            read_chunk(ds, i)
        decode_s = time.perf_counter() - t
        log(f"  dataset: {n} rows ({ds.num_rows * ds.row_bytes() / 1e9:.2f} GB) in "
            f"{len(ds.chunks)} uncompressed chunks of {chunk_rows} rows; generated in "
            f"{gen_s:.1f} s, written in {write_s:.1f} s, decoded in {decode_s:.1f} s")

        def query():
            return _stream_query(ds, ctx, scan_kw)

        lz = query()
        scan = next(s for s in logical.walk(lz.plan) if isinstance(s, logical.Scan))
        batch_rows = scan.capacity * P
        nb = -(-n // batch_rows)
        log(f"  cost model: batch_rows {batch_rows} ({scan.capacity} per worker), "
            f"{nb} batches; carry {-(-n // P)} slots per worker")
        _require(nb >= 4, f"the cost model's batch size gives {nb} batches, fewer than 4")

        def run(lazy, **kw):
            out = lazy.collect_stream(**kw)
            return out, lazy.last_info

        got = steps("groupby", lambda: run(lz), shuffles=True)
        _require(steps.res["groupby"]["batches"] == nb, f"{steps.res['groupby']} batches")
        if steps.on_card:
            la = steps.res["groupby"]["launches"]
            _require(la["hash_partition"] == nb, f"groupby: one shuffle per batch, got {la}")
            _require(la["segment_reduce"] % nb == 0, f"groupby: launches {la} over {nb} batches")
        digests = worker_digests(got)
        got = got.to_numpy()
        t = time.perf_counter()
        exp = _groupby_oracle(data["c0"], data["c1"])
        _require_bits(got, exp, "streamed groupby", sort_by="c0")
        log(f"  streamed groupby: {len(got['c0'])} groups, equal to the numpy oracle by bits "
            f"(checked in {time.perf_counter() - t:.1f} s); every overflow counter is 0")
        del exp

        ck = os.path.join(work, "ckpt")
        every = max(nb // 2, 1)
        plan = FaultPlan(kill_after={"device_op": nb // 2})

        def killed():
            with fault_scope(plan), obs.profiled() as prof:
                try:
                    query().collect_stream(checkpoint_dir=ck, checkpoint_every=every)
                    died = False
                except InjectedFault:
                    died = True
            _require(died, "the killed run did not die")
            return prof, {}

        prof = steps("killed", killed, shuffles=True)
        gc.collect()  # the killed run's carry goes with its frames
        if steps.on_card:
            torch.cuda.empty_cache()
        kept = StreamCheckpoint(ck).steps()
        _require(bool(kept), "the killed run published no snapshot")
        # the resumed run publishes no snapshot of its own before it ends
        resumed = steps("resumed", lambda: run(query(), checkpoint_dir=ck, resume=True,
                                               checkpoint_every=nb + 1),
                        shuffles=True)
        _require_bits(resumed.to_numpy(), got, "resumed groupby")
        _require(StreamCheckpoint(ck).steps() == [], "the checkpoint store was not cleared")
        del resumed
        report = obs.model_report(prof.records)
        with_ck = steps.res["killed"]["wall_ms"] + steps.res["resumed"]["wall_ms"]
        log(f"  kill at device_op {nb // 2} of {nb}, the killed run checkpointing every "
            f"{every} batches (snapshots {kept}), the resumed run publishing none: killed run {steps.res['killed']['wall_ms']:.1f} ms (traced) "
            f"+ resumed run {steps.res['resumed']['wall_ms']:.1f} ms = {with_ck:.1f} ms with "
            f"checkpoints, against {steps.res['groupby']['wall_ms']:.1f} ms without; "
            f"resumed == uninterrupted by bits, the store cleared")
        log("  cost-model check (the killed run, traced): " + ", ".join(
            f"{p} n={d['count']} mean |rel err| {d['mean_abs_rel_err']:.2f} bias "
            f"x{d['bias']:.2f}" for p, d in sorted(report.items())))

        def batches():
            parts = list(_readme_ep(scan_dataset(ds, ctx, **scan_kw)).to_batches())
            return parts, {"batches": len(parts)}

        parts = steps("to_batches", batches, shuffles=False)
        _require(len(parts) == nb, f"to_batches gave {len(parts)} batches, not {nb}")
        cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        del parts
        keep = data["c1"] < LAZY_SELECT
        ep = {"c0": data["c0"][keep], "c1": data["c1"][keep]}
        ep["c2"] = (ep["c1"] < LAZY_FLAG).astype(np.int32)
        _require_bits(cat, ep, "to_batches")
        log(f"  to_batches: {len(cat['c0'])} rows, equal to the numpy filter by bits")
        del cat, ep, keep

        m = P * small_rows_per_worker
        small_l = uniform_table(m, cardinality=0.9, n_cols=2, seed=1)
        small_r = uniform_table(m, cardinality=0.9, n_cols=2, seed=2)
        ds_l = write_dataset(small_l, os.path.join(work, "small_left"), chunk_rows=chunk_rows,
                             compress=False)
        ds_r = write_dataset(small_r, os.path.join(work, "small_right"), chunk_rows=chunk_rows,
                             compress=False)
        srt = steps("sort", lambda: run(scan_dataset(ds_l, ctx, **scan_kw).sort_values("c0")),
                    shuffles=False)
        order = np.argsort(small_l["c0"], kind="stable")
        _require_bits(srt.to_numpy(), {k: v[order] for k, v in small_l.items()}, "streamed sort")
        del srt, order
        jq = (scan_dataset(ds_l, ctx, **scan_kw)
              .join(scan_dataset(ds_r, ctx, **scan_kw), on=("c0",))
              .groupby(("c0",), {"c1": ("sum", "count"), "c1_r": ("sum",)}))
        joined = steps("spill_join", lambda: run(jq), shuffles=True).to_numpy()
        n_keys = max(int(m * 0.9), 1)
        kl, kr = small_l["c0"].astype(np.int64), small_r["c0"].astype(np.int64)
        cnt_l, cnt_r = np.bincount(kl, minlength=n_keys), np.bincount(kr, minlength=n_keys)
        sum_l = np.bincount(kl, weights=small_l["c1"].astype(np.float64),
                            minlength=n_keys).astype(np.int64)
        sum_r = np.bincount(kr, weights=small_r["c1"].astype(np.float64),
                            minlength=n_keys).astype(np.int64)
        hit = np.nonzero((cnt_l > 0) & (cnt_r > 0))[0]
        _require_bits(joined, {"c0": hit.astype(np.int32),
                               "c1_sum": (sum_l[hit] * cnt_r[hit]).astype(np.int32),
                               "c1_count": (cnt_l[hit] * cnt_r[hit]).astype(np.int32),
                               "c1_r_sum": (sum_r[hit] * cnt_l[hit]).astype(np.int32)},
                      "spill join + groupby", sort_by="c0")
        log(f"  sort and spill join at {small_rows_per_worker} rows per worker a side: equal to "
            f"numpy by bits ({int((cnt_l * cnt_r).sum())} join rows, {len(hit)} groups)")
        del joined, small_l, small_r

        path = os.path.join(work, "left.csv")
        t = time.perf_counter()
        np.savetxt(path, np.stack([data["c0"][:csv_rows], data["c1"][:csv_rows]], axis=1),
                   fmt="%d", delimiter=",", header="c0,c1", comments="")
        csv_write_s = time.perf_counter() - t
        csv_dir = os.path.join(work, "csv")

        def from_csv():
            lazy = scan_csv([path], {"c0": np.int32, "c1": np.int32}, ctx, directory=csv_dir,
                            **scan_kw)
            return run(_readme_ep(lazy).groupby(("c0",), _lazy_aggs()))

        csv_out = steps("scan_csv", from_csv, shuffles=True).to_numpy()
        _require_bits(csv_out, _groupby_oracle(data["c0"][:csv_rows], data["c1"][:csv_rows]),
                      "scan_csv groupby", sort_by="c0")
        log(f"  scan_csv: {csv_rows} rows (CSV written in {csv_write_s:.1f} s; its ingestion is "
            f"in the step's time), equal to the numpy oracle by bits")
        groups = int(len(got["c0"]))
        del got, csv_out, data
        if profile_path:
            gc.collect()
            _profile(lambda: query().collect_stream(), profile_path,
                     f"one streamed groupby collect at {rows_per_worker} rows per worker")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"workers": P, "rows_per_worker": rows_per_worker, "rows": n,
            "chunk_rows": chunk_rows, "batch_rows": batch_rows, "batches": nb,
            "dataset_write_s": write_s, "dataset_decode_s": decode_s, "groups": groups,
            "checkpoint_every": every, "kill_at_device_op": nb // 2,
            "small_rows_per_worker": small_rows_per_worker, "csv_rows": csv_rows,
            "steps": steps.res, "model_report": report, "digests": digests}


# -- service path -------------------------------------------------------------------

SERVICE_KEYS = 10_000  # benchmarks/bench_service.py's KEYS: a low-cardinality dimension
SERVICE_CARRY = 16_384  # carry slots per worker: 10,000 keys hash to about 1,250 per worker
SERVICE_LAZY_ROWS_PER_WORKER = 1_000_000  # four lazy joins share the card with four scans
SERVICE_SCANS = SERVICE_LAZY = 4  # benchmarks/bench_service.py's mix, equal weights
SERVICE_MAX_RUNNING = 4
SERVICE_SELECT = 2**21  # the scan-free select keeps about 29% of the rows
SERVICE_TIMEOUT_S = 600
CANCEL_AFTER = 5  # morsels the cancelled scan runs before it is cancelled
FREED_SLACK_BYTES = 64 * 2**20  # what a drained service may still hold of a cancelled query


def _service_scan(ds, ctx, scan_kw):
    """The streamed query of the service phase: ``scan_dataset`` ->
    ``select(col("c1") < 2**30)`` (absorbed into the scan) -> ``k = c0 %
    10,000`` -> groupby ``k`` (sum and count of ``c1``)."""
    from repro_torch.expr import col
    from repro_torch.stream import scan_dataset

    return (scan_dataset(ds, ctx, **scan_kw).select(col("c1") < LAZY_SELECT)
            .with_column("k", col("c0") % SERVICE_KEYS)
            .groupby(("k",), {"c1": ("sum", "count")}))


def _service_oracle(c0, c1, chunk: int = 8_000_000) -> dict:
    """The service scan's result in numpy, sorted by key: per ``k = c0 %
    10,000`` over the rows with c1 < 2**30, the int32 sum (wrapped) and
    count of c1. float64 sums are exact below 2**53; the work goes in
    chunks through reused buffers (the card machine's host is slow at
    fresh pages)."""
    cnt = np.zeros(SERVICE_KEYS, np.int64)
    tot = np.zeros(SERVICE_KEYS, np.float64)
    kbuf, wbuf = np.empty(chunk, np.int64), np.empty(chunk, np.float64)
    mbuf = np.empty(chunk, np.bool_)
    for lo in range(0, len(c0), chunk):
        m = min(chunk, len(c0) - lo)
        k, w, keep = kbuf[:m], wbuf[:m], mbuf[:m]
        np.remainder(c0[lo:lo + m], SERVICE_KEYS, out=k)
        w[:] = c1[lo:lo + m]
        np.less(c1[lo:lo + m], LAZY_SELECT, out=keep)
        if not keep.all():
            k, w = k[keep], w[keep]
        cnt += np.bincount(k, minlength=SERVICE_KEYS)
        tot += np.bincount(k, weights=w, minlength=SERVICE_KEYS)
    hit = np.flatnonzero(cnt)
    return {"k": hit.astype(np.int32), "c1_sum": tot[hit].astype(np.int64).astype(np.int32),
            "c1_count": cnt[hit].astype(np.int32)}


def service_queries(ds, ctx, L, R, scan_kw) -> list:
    """The service mix in submission order, ``(label, kind, query, stream
    options)``: scan, lazy, scan, lazy, ..., the eager sort, the select."""
    from repro_torch.expr import col

    stream_opts = {"carry_capacity": SERVICE_CARRY}
    queries = []
    for i in range(SERVICE_SCANS):
        queries.append((f"scan{i + 1}", "stream", _service_scan(ds, ctx, scan_kw), stream_opts))
        queries.append((f"lazy{i + 1}", "lazy", _lazy_steps(L, R), {}))
    queries.append(("sort", "eager", lambda: L.sort_values("c1")[0], {}))
    queries.append(("select", "lazy", L.lazy().select(col("c1") < SERVICE_SELECT), {}))
    return queries


def service_budget(queries) -> float:
    """The service's memory budget: any four of the mix by their admission
    estimates."""
    from repro_torch.service import estimate_query_bytes

    return SERVICE_MAX_RUNNING * max(estimate_query_bytes(q) for _, _, q, _ in queries)


def run_service_path(P: int, rows_per_worker: int,
                     lazy_rows_per_worker: int = SERVICE_LAZY_ROWS_PER_WORKER,
                     device="cuda", chunk_rows: int = STREAM_CHUNK_ROWS,
                     memory_budget_bytes: float | None = None,
                     cancel_batch_rows: int | None = None,
                     profile_path: str | None = None) -> dict:
    """The concurrent query service (``repro_torch.service``) driving a
    mixed load on one device, the reference's ``benchmarks/bench_service.py``
    mix (4 streaming + 4 lazy queries, equal weights) plus its tests' eager
    thunk and scan-free select:

    - 4 streamed groupbys (``_service_scan``) over the paper's left table
      (``uniform_table``, cardinality 0.9, seed 1, ``rows_per_worker`` rows
      per worker) written uncompressed as a chunked dataset in a temporary
      directory, at the cost model's batch size (``memory_budget_bytes`` is
      the scans' batch budget), each with ``carry_capacity=16,384``
      through ``submit(**stream_opts)``;
    - 4 lazy queries, the README's lazy example (``_lazy_steps``) on the
      paper's two tables at ``lazy_rows_per_worker`` rows per worker;
    - an eager thunk (``L.sort_values("c1")[0]``) and a scan-free select.

    Every query first runs alone (launch counts at 0, peak memory reset),
    the scans against a numpy oracle; then all ten go to one
    ``QueryService(policy="fair", max_running=4)`` whose memory budget B
    admits any four by their admission estimates, submitted scan, lazy,
    scan, lazy, ... The concurrent results must equal the serial ones by
    bits, every session must end DONE, and the launch counts must be the
    serial runs' sum (``hash_partition_hist`` 0). Then a fifth scan (the
    default carry, ``ceil(rows / P)`` slots per worker) is cancelled after
    its 5th morsel: CANCELLED, ``QueryCancelled``, and on the card the
    drained service's allocated memory back within 64 MiB of before its
    submit; a thunk that raises ends FAILED with its own exception; a
    ``max_running=1, max_backlog=1`` service sheds a third submission with
    ``AdmissionError``. With ``profile_path``, one more concurrent run of
    the ten under ``torch.profiler``. On the CPU (``device="cpu"``) it
    rehearses the same steps at any size."""
    import shutil
    import tempfile
    import threading

    import torch

    from repro_torch.core import DDF, DDFContext
    from repro_torch.data import uniform_table, write_dataset
    from repro_torch.expr import col
    from repro_torch.kernels import registry
    from repro_torch.plan import logical
    from repro_torch.service import (AdmissionError, QueryCancelled, QueryService, QueryState,
                                     estimate_query_bytes)

    ctx = DDFContext(nworkers=P, device=device)
    on_card = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n = P * rows_per_worker
    work = tempfile.mkdtemp(prefix="chip-smoke-service-")
    scan_kw = {} if memory_budget_bytes is None else {"memory_budget_bytes": memory_budget_bytes}
    try:
        t = time.perf_counter()
        data = uniform_table(n, cardinality=0.9, n_cols=2, seed=1)
        ds = write_dataset(data, os.path.join(work, "left"), chunk_rows=chunk_rows,
                           compress=False)
        log(f"  dataset: {n} rows ({ds.num_rows * ds.row_bytes() / 1e9:.2f} GB) in "
            f"{len(ds.chunks)} uncompressed chunks, generated and written in "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        exp = _service_oracle(data["c0"], data["c1"])
        oracle_s = time.perf_counter() - t
        del data
        left, right = paper_tables(P, lazy_rows_per_worker)
        L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
        del left, right
        queries = service_queries(ds, ctx, L, R, scan_kw)
        scan = next(s for s in logical.walk(queries[0][2].plan) if isinstance(s, logical.Scan))
        nb = -(-n // (scan.capacity * P))
        estimates = {name: estimate_query_bytes(q) for name, _, q, _ in queries}
        budget = service_budget(queries)
        log(f"  cost model: batch_rows {scan.capacity * P} ({scan.capacity} per worker), {nb} "
            f"batches per scan; carry {SERVICE_CARRY} slots per worker; lazy tables "
            f"{lazy_rows_per_worker} rows per worker a side; oracle in {oracle_s:.1f} s")
        log(f"  admission estimates (bytes): " + ", ".join(
            f"{k} {v:.0f}" for k, v in estimates.items()) + f"; budget B = {SERVICE_MAX_RUNNING}"
            f" x the largest = {budget:.0f} bytes ({budget / 2**30:.2f} GiB)")
        _require(SERVICE_SCANS * estimates["scan1"] <= budget,
                 "the budget does not let the four scans run together")

        serial, serial_out = {}, {}
        serial_launches = {k: 0 for k in registry.KERNEL_OPS}
        for name, kind, q, opts in queries:
            registry.reset_launch_counts()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            sync()
            t = time.perf_counter()
            if kind == "stream":
                out = q.collect_stream(**opts)
            elif kind == "lazy":
                out = q.collect()
            else:
                out = q()
            sync()
            wall = time.perf_counter() - t
            launches = registry.launch_counts()
            info = q.last_info if kind != "eager" else {}
            over = {k: int(np.sum(v.cpu().numpy() if isinstance(v, torch.Tensor) else v))
                    for k, v in info.items() if "overflow" in k}
            _require(not any(over.values()), f"{name}: overflow {over}")
            _require(launches["hash_partition_hist"] == 0, f"{name}: launches {launches}")
            if kind == "stream":
                _require(info["batches"] == nb, f"{name}: {info['batches']} batches, not {nb}")
            for k, v in launches.items():
                serial_launches[k] += v
            serial_out[name] = out.to_numpy()
            del out
            serial[name] = {"wall_ms": wall * 1e3, "estimate_bytes": estimates[name],
                            "gauge_bytes": info.get("peak_working_set_bytes"),
                            "peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
                            "launches": {k: v for k, v in launches.items() if v}}
            if kind == "stream":
                _require_bits(serial_out[name], exp, f"{name} (serial)", sort_by="k")
        del exp
        if on_card:
            _require(serial_launches["hash_partition"] > 0
                     and serial_launches["segment_reduce"] > 0,
                     f"serial runs: launches {serial_launches}")
        serial_s = sum(r["wall_ms"] for r in serial.values()) / 1e3
        for name, r in serial.items():
            gauge = "-" if r["gauge_bytes"] is None else f"{r['gauge_bytes']:.0f}"
            log(f"  {name:7s} alone {r['wall_ms']:10.1f} ms  estimate {r['estimate_bytes']:12.0f}"
                f"  gauge {gauge:>12s}  peak {r['peak_bytes'] / 2**30:6.2f} GiB  launches "
                f"{r['launches']}")
        top = sorted((r["peak_bytes"] for r in serial.values()), reverse=True)
        worst = sum(top[:SERVICE_MAX_RUNNING])
        if on_card:
            card = torch.cuda.get_device_properties(0).total_memory
            _require(worst < card, f"four solo peaks {worst} bytes exceed the card's {card}")

        def concurrent():
            """All ten through one service; returns its handles, results,
            wall seconds and launch counts."""
            registry.reset_launch_counts()
            sync()
            t = time.perf_counter()
            with QueryService(policy="fair", max_running=SERVICE_MAX_RUNNING,
                              memory_budget_bytes=budget) as svc:
                handles = [svc.submit(q, label=name, **opts) for name, _, q, opts in queries]
                outs = [h.result(timeout=SERVICE_TIMEOUT_S) for h in handles]
            sync()
            return svc, handles, outs, time.perf_counter() - t, registry.launch_counts()

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        svc, handles, outs, conc_s, conc_launches = concurrent()
        conc_peak = torch.cuda.max_memory_allocated() if on_card else 0
        stats = svc.stats()
        digests = {}
        for (name, _, _, _), h, out in zip(queries, handles, outs):
            _require(h.state == QueryState.DONE, f"{name}: {h.state}")
            _require_bits(out.to_numpy(), serial_out[name], f"{name} (concurrent vs serial)")
            digests[name] = worker_digests(out)
        del outs, serial_out
        _require(stats["sessions"]["DONE"] == len(queries) and not any(
            v for k, v in stats["sessions"].items() if k != "DONE"),
            f"sessions {stats['sessions']}")
        _require(conc_launches == serial_launches,
                 f"concurrent launches {conc_launches} vs serial {serial_launches}")
        caches = {k: v["window"] for k, v in stats["caches"].items()}
        _require(caches["plan"]["hits"] >= SERVICE_LAZY and caches["op"]["hits"] >= SERVICE_LAZY,
                 f"cache window {caches}")
        lat = np.array([h.finished_at - h.submitted_at for h in handles])
        dev_s = {h.label: h.device_s for h in handles}
        scans = [dev_s[f"scan{i + 1}"] for i in range(SERVICE_SCANS)]
        spread = max(scans) / min(scans)
        sched = stats["scheduler"]
        log(f"  serial {serial_s:.3f} s ({len(queries) / serial_s:.3f} queries/s), "
            f"concurrent {conc_s:.3f} s ({len(queries) / conc_s:.3f} queries/s), "
            f"x{serial_s / conc_s:.2f}; every result equal to its serial run by bits, "
            f"the scans to the numpy oracle; sessions {stats['sessions']}")
        log(f"  latency submit -> DONE: p50 {np.percentile(lat, 50):.3f} s, p95 "
            f"{np.percentile(lat, 95):.3f} s; per query " + ", ".join(
                f"{h.label} {v:.3f}" for h, v in zip(handles, lat)))
        log(f"  device_s " + ", ".join(f"{k} {v:.3f}" for k, v in dev_s.items())
            + f"; fairness spread of the scans (max/min device_s) {spread:.3f}")
        log(f"  morsels_total {sched['morsels_total']}, turns_total {sched['turns_total']}; "
            f"cache window plan {caches['plan']}, op {caches['op']}")
        log(f"  launches: concurrent {({k: v for k, v in conc_launches.items() if v})} = the "
            f"serial runs' sum; peak concurrent {conc_peak / 2**30:.2f} GiB against solo peaks "
            f"summing to {sum(r['peak_bytes'] for r in serial.values()) / 2**30:.2f} GiB "
            f"(the four largest {worst / 2**30:.2f} GiB)")

        cancel_kw = dict(scan_kw)
        if cancel_batch_rows is not None:
            cancel_kw["batch_rows"] = cancel_batch_rows
        err = RuntimeError("the service phase's failing thunk")

        def boom():
            raise err

        del svc, handles
        gc.collect()
        sync()
        base = torch.cuda.memory_allocated() if on_card else 0
        with QueryService(policy="fair", max_running=SERVICE_MAX_RUNNING,
                          memory_budget_bytes=budget) as svc:
            hc = svc.submit(_service_scan(ds, ctx, cancel_kw), label="cancelled")
            deadline = time.monotonic() + SERVICE_TIMEOUT_S
            while hc.morsels < CANCEL_AFTER and not hc.done() and time.monotonic() < deadline:
                time.sleep(0.0005)
            held = torch.cuda.memory_allocated() if on_card else 0
            _require(svc.cancel(hc.qid), f"the scan to cancel ended {hc.state}")
            hf = svc.submit(boom, label="failing")
        sync()
        freed = torch.cuda.memory_allocated() if on_card else 0
        try:
            hc.result(timeout=1)
            cancelled = False
        except QueryCancelled:
            cancelled = True
        _require(cancelled and hc.state == QueryState.CANCELLED,
                 f"the cancelled scan ended {hc.state}")
        cancel_nb = -(-n // (cancel_batch_rows or scan.capacity * P))
        _require(CANCEL_AFTER <= hc.morsels < cancel_nb,
                 f"the cancelled scan ran {hc.morsels} of {cancel_nb} morsels")
        try:
            hf.result(timeout=1)
            raised = None
        except RuntimeError as e:
            raised = e
        _require(raised is err and hf.state == QueryState.FAILED,
                 f"the failing thunk ended {hf.state} with {raised!r}")
        if on_card:
            _require(held - base > FREED_SLACK_BYTES,
                     f"the cancelled scan held only {held - base} bytes: the check cannot bite")
            _require(freed - base <= FREED_SLACK_BYTES,
                     f"after the cancel the card holds {freed - base} bytes more than before")
        log(f"  cancel: scan cancelled after {hc.morsels} of {cancel_nb} morsels -> "
            f"{hc.state}, QueryCancelled; allocated before the submit {base}, at the cancel "
            f"{held} (+{(held - base) / 2**30:.2f} GiB), after the drain {freed} "
            f"(+{(freed - base) / 2**20:.1f} MiB); the failing thunk -> {hf.state} with its "
            f"own exception")

        gate, started = threading.Event(), threading.Event()

        def hold():
            started.set()
            gate.wait(timeout=SERVICE_TIMEOUT_S)

        shed_svc = QueryService(max_running=1, max_backlog=1)
        try:
            first = shed_svc.submit(hold, label="hold")
            _require(started.wait(timeout=SERVICE_TIMEOUT_S), "the holding thunk never ran")
            queued = shed_svc.submit(queries[-1][2], label="queued")
            try:
                shed_svc.submit(queries[-1][2], label="shed")
                shed = None
            except AdmissionError as e:
                shed = type(e).__name__
            gate.set()
            first.result(timeout=SERVICE_TIMEOUT_S)
            queued.result(timeout=SERVICE_TIMEOUT_S)
        finally:
            gate.set()
            shed_svc.shutdown(cancel=True, timeout=SERVICE_TIMEOUT_S)
        _require(shed == "AdmissionError" and queued.state == QueryState.DONE,
                 f"shed: {shed}, the queued query {queued.state}")
        log(f"  shed: max_running=1, max_backlog=1 refused the third submission with {shed}; "
            f"the queued one ended {queued.state}")
        if profile_path:
            gc.collect()
            _profile(lambda: concurrent(), profile_path,
                     f"one concurrent run of the service's {len(queries)} queries")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"workers": P, "rows_per_worker": rows_per_worker,
            "lazy_rows_per_worker": lazy_rows_per_worker, "batches": nb,
            "carry_capacity": SERVICE_CARRY, "budget_bytes": budget, "serial": serial,
            "serial_launches": serial_launches, "serial_s": serial_s,
            "concurrent": {"wall_s": conc_s, "launches": conc_launches, "peak_bytes": conc_peak,
                           "latency_p50_s": float(np.percentile(lat, 50)),
                           "latency_p95_s": float(np.percentile(lat, 95)),
                           "device_s": dev_s, "fairness_spread": spread,
                           "morsels_total": sched["morsels_total"],
                           "turns_total": sched["turns_total"], "caches": caches},
            "queries_per_s": {"serial": len(queries) / serial_s,
                              "concurrent": len(queries) / conc_s},
            "sessions": stats["sessions"], "digests": digests,
            "cancel": {"state": hc.state, "morsels": hc.morsels, "base_bytes": base,
                       "held_bytes": held, "freed_bytes": freed},
            "failed": hf.state, "shed": shed}


# -- kernel phase -----------------------------------------------------------------

def record_shapes(shapes: dict):
    """Wrap the kernel launchers the dispatch wrappers call, and the model
    kernels' autograd Functions where they launch the kernel, to record the
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

    fa_fn, ssd_fn = ops.FlashAttentionFn, ops.SsdScanFn

    class FlashFnRec:
        @staticmethod
        def apply(q, k, v, use_kernel, causal, window, softcap, scale):
            if use_kernel:
                shapes.setdefault("flash_attention", set()).add(
                    (tuple(q.shape), k.shape[2], str(q.dtype), causal, window, softcap, scale))
            return fa_fn.apply(q, k, v, use_kernel, causal, window, softcap, scale)

    class SsdFnRec:
        @staticmethod
        def apply(x, dt, A, B, C, D, use_kernel, chunk):
            if use_kernel:
                shapes.setdefault("ssd_scan", set()).add(
                    (tuple(x.shape), tuple(B.shape), chunk, str(x.dtype)))
            return ssd_fn.apply(x, dt, A, B, C, D, use_kernel, chunk)

    ops.hash_partition_cuda, ops.segment_reduce_cuda = hash_rec, seg_rec
    ops.flash_attention_cuda, ops.ssd_scan_cuda = flash_rec, ssd_rec
    ops.FlashAttentionFn, ops.SsdScanFn = FlashFnRec, SsdFnRec
    return lambda: (setattr(ops, "hash_partition_cuda", hp),
                    setattr(ops, "segment_reduce_cuda", sr),
                    setattr(ops, "flash_attention_cuda", fa),
                    setattr(ops, "ssd_scan_cuda", ssd),
                    setattr(ops, "FlashAttentionFn", fa_fn),
                    setattr(ops, "SsdScanFn", ssd_fn))


def hash_phase(main_shapes, patterns_shapes, gen):
    """Every (rows, key columns, partitions) shape of the main path and of
    the patterns path, plus two key columns and a ragged row count; timed
    at the main path's largest shape."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.hash_partition import hash_work

    (n, n_cols), P = max(main_shapes, key=lambda s: s[0][0])
    cases = sorted(set(main_shapes) | set(patterns_shapes)
                   | {((n, 2), P), ((n + 13, 1), P), ((1, 1), P)})
    rec, max_err = None, 0.0
    for (rows, cols), p in cases:
        keys = torch.randint(-2**31, 2**31 - 1, (rows, cols), dtype=torch.int32,
                             device="cuda", generator=gen)
        edge = torch.tensor([-1, 0, 2**31 - 1, -2**31, 1, -2, 7, 12345], dtype=torch.int32,
                            device="cuda")
        keys[: min(8, rows)] = edge[: min(8, rows), None]
        d_k, h_k = ops.hash_partition(keys, p, force="cuda", with_hist=True)
        d_p, h_p = ops.hash_partition(keys, p, force="torch", with_hist=True)
        err = max(require_equal(d_k, d_p, f"hash dest {rows}x{cols}"),
                  require_equal(h_k, h_p, f"hash hist {rows}x{cols}"))
        d_only, h_none = ops.hash_partition(keys, p, force="cuda", with_hist=False)
        err = max(err, require_equal(d_only, d_p, f"hash dest-only {rows}x{cols}"))
        if h_none is not None:
            raise AssertionError("hash_partition(with_hist=False) returned a histogram")
        line = f"  hash_partition {rows}x{cols} P={p}: identical to the plain version"
        if ((rows, cols), p) in patterns_shapes:
            line += " (a patterns-, lazy- or streaming-path shape)"
        if ((rows, cols), p) == ((n, n_cols), P):
            ms = cuda_time_ms(lambda: ops.hash_partition(keys, P, force="cuda", with_hist=False))
            hist_ms = cuda_time_ms(lambda: ops.hash_partition(keys, P, force="cuda"))
            plain_ms = cuda_time_ms(lambda: ops.hash_partition(keys, P, force="torch",
                                                               with_hist=False), iters=3)
            hist_plain_ms = cuda_time_ms(lambda: ops.hash_partition(keys, P, force="torch"),
                                         iters=3)
            bound_ms = hash_work(rows, cols, P, False)[1] / HBM_BYTES_PER_S * 1e3
            rec = {"name": "hash_partition", "route": "cuda",
                   "source": "src/repro_torch/csrc/hash_partition.cu",
                   "replaces": "src/repro/kernels/hash_partition.py:86",
                   "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
                   "shape": [rows, cols], "num_partitions": P,
                   "hist_replaces": "src/repro/kernels/hash_partition.py:96",
                   "hist_ms": hist_ms, "hist_plain_ms": hist_plain_ms}
            line += (f"; kernel {ms:.4f} ms (with hist {hist_ms:.4f}), plain {plain_ms:.3f} ms,"
                     f" bound {bound_ms:.4f} ms")
        max_err = max(max_err, err)
        log(line)
    rec["max_abs_err"] = max_err
    return rec


def hist_record(rec: dict) -> dict:
    """The kernels line's entry for the histogram variant of hash_partition
    (its own ``pallas_call`` in the reference): the same kernel with its
    (P,) histogram output, timed by ``hash_phase``. Its launches are filled
    in from the paths' counts like every other entry's."""
    from repro_torch.kernels.hash_partition import hash_work

    rows, cols = rec["shape"]
    return {"name": "hash_partition_hist", "route": "cuda", "source": rec["source"],
            "replaces": rec["hist_replaces"], "max_abs_err": rec["max_abs_err"],
            "ms": rec["hist_ms"],
            "plain_ms": rec["hist_plain_ms"],
            "bound_ms": hash_work(rows, cols, rec["num_partitions"], True)[1]
            / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": rec["shape"],
            "num_partitions": rec["num_partitions"]}


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
    v[(r >= 0.101) & (r < 0.102)] = float("inf")
    v[(r >= 0.102) & (r < 0.103)] = float("-inf")
    v = v.to(dtype)
    # NaNs of both signs, some with payloads: which one a segment keeps is
    # the reference's rule, and its bits must survive
    ints = {torch.float32: torch.int32, torch.float16: torch.int16}[dtype]
    nans = torch.tensor([0x7FC00000, -0x00400000, 0x7FC00001, -0x003FFFF9]
                        if dtype == torch.float32 else [0x7E00, -0x0200, 0x7E01, -0x01F9],
                        dtype=ints, device="cuda")
    pick = torch.randint(0, 4, shape, device="cuda", generator=gen)
    bits = v.view(ints)
    bits[(r >= 0.1) & (r < 0.101)] = nans[pick][(r >= 0.1) & (r < 0.101)]
    return v


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


def segment_phase(main_shapes, patterns_shapes, P, gen):
    """Every (rows, width, segments) shape of the main path and of the
    patterns path and a ragged row count, in int32 and integer-valued
    float32 (and any other dtype those paths gave it), for sum, min and
    max, held against the plain version; at the main path's largest shape, int32 sum, min and max,
    float32 min and max and int32 sum at width 2 timed beside their bound,
    the second pass (long empty runs) split out by the profiler, and int32
    sum held against ``scatter_reduce_``; every main-path launch timed at
    its shape; float32 min and max with NaNs at the largest shape; the
    narrow dtypes and NaN / +-0 floats at a small shape."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_reduce import identity, segment_work

    (n, width), nseg, _, _ = max(main_shapes, key=lambda s: s[0][0])
    recorded = set(main_shapes) | set(patterns_shapes)
    cases = sorted({(shape, ns) for shape, ns, _, _ in recorded} | {((n + 13, width), nseg)})
    rec, max_err, op_ms = None, 0.0, {}
    launch_ms = []
    for (rows, w), ns in cases:
        seg = _segments(rows, ns, P, gen)
        bound_ms = segment_work(rows, w, ns, 4)[1] / HBM_BYTES_PER_S * 1e3
        given = {getattr(torch, d.removeprefix("torch.")) for shape, n_s, _, d in recorded
                 if (shape, n_s) == ((rows, w), ns)}
        where = " (a patterns-, lazy- or streaming-path shape)" if any(
            (shape, n_s) == ((rows, w), ns) for shape, n_s, _, _ in patterns_shapes) else ""
        for dtype in sorted({torch.int32, torch.float32} | given, key=str):
            if dtype == torch.int32:
                vals = torch.randint(-2**31, 2**31 - 1, (rows, w), dtype=torch.int32,
                                     device="cuda", generator=gen)
            elif dtype == torch.float32:  # integer-valued: float sums are exact in any order
                vals = torch.randint(-1000, 1000, (rows, w), device="cuda",
                                     generator=gen).to(torch.float32)
            for op in ("sum", "min", "max"):
                if dtype == torch.bool and op == "sum":
                    continue
                if dtype not in (torch.int32, torch.float32):
                    vals = _special_values(dtype, op, (rows, w), gen)
                k = ops.segment_reduce(vals, seg, ns, op=op, force="cuda")
                p = ops.segment_reduce(vals, seg, ns, op=op, force="torch")
                err = require_equal(k, p, f"segment_reduce {op} {dtype} {rows}x{w}")
                del k, p
                line = (f"  segment_reduce {op:3s} {str(dtype):13s} {rows}x{w} "
                        f"nseg={ns}: identical to the plain version{where}")
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
            w2_bound = segment_work(rows, 2, ns, 4)[1] / HBM_BYTES_PER_S * 1e3
            log(f"  segment_reduce sum int32 {rows}x2 nseg={ns}: identical to the plain version;"
                f" kernel {w2_ms:.4f} ms, bound {w2_bound:.4f} ms")
            # float min/max where about one row in 1000 is a NaN of either
            # sign, with payloads: the kernel's own walk to the reference's NaN
            vals = torch.randint(-1000, 1000, (rows, w), device="cuda",
                                 generator=gen).to(torch.float32)
            nan = torch.rand((rows, w), device="cuda", generator=gen) < 1e-3
            bits = torch.tensor([0x7FC00000, -0x00400000, 0x7FC00001, -0x003FFFF9],
                                dtype=torch.int32, device="cuda")
            pick = bits[torch.randint(0, 4, (rows, w), device="cuda", generator=gen)]
            vals.view(torch.int32)[nan] = pick[nan]
            del nan, pick
            nan_ms = {}
            for op in ("min", "max"):
                require_equal(ops.segment_reduce(vals, seg, ns, op=op, force="cuda"),
                              ops.segment_reduce(vals, seg, ns, op=op, force="torch"),
                              f"segment_reduce {op} float32 with NaNs {rows}x{w}")
                nan_ms[op] = cuda_time_ms(lambda: ops.segment_reduce(vals, seg, ns, op=op,
                                                                     force="cuda"))
            log(f"  segment_reduce min/max float32 {rows}x{w} nseg={ns}, 1 row in 1000 a NaN: "
                f"identical to the plain version by bits; kernel min {nan_ms['min']:.4f} ms, "
                f"max {nan_ms['max']:.4f} ms")
            del vals
        del seg
    rec.update(op_ms=op_ms, main_path_launch_ms=launch_ms,
               width2={"ms": w2_ms, "bound_ms": w2_bound}, float_nan_ms=nan_ms)

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
                          f"segment_reduce {op} {name} {SEG_SMALL_ROWS}x2",
                          nan_bits=op != "sum")
    log(f"  segment_reduce sum/min/max of int32, uint32, float32 and {', '.join(SEG_NARROW)}"
        f" (no bool sum), {SEG_SMALL_ROWS}x2 with +-0, +-inf and NaNs of both signs and with"
        f" payloads in the floats: identical to the plain version, bit for bit (the NaNs of"
        f" float sums by position)")
    rec["max_abs_err"] = max_err
    return rec


# -- serve paths --------------------------------------------------------------------

# (architecture, prefill batch, prefill tokens, float32 check batch and
# tokens, whether the check also decodes token by token). llava's 7616
# tokens follow its 576 patch embeddings: S = 8192, so its 4096 window acts
# (ops.flash_attention drops a window of at least S), as gemma2's does.
SERVE_ARCH = "zamba2-1.2b"  # its prefill's shapes are the model kernel phase's timed cases
SERVE_PATHS = (
    (SERVE_ARCH, 4, 4096, 2, 256, True),
    ("gemma2-9b", 2, 8192, 2, 256, True),
    ("granite-moe-3b-a800m", 4, 4096, 1, 512, False),
    ("llava-next-mistral-7b", 2, 8192 - 576, 1, 512, False),
    ("whisper-tiny", 4, 448, 2, 448, False),
)
PROMPT_LENS, MAX_NEW, ENGINE_MAX_LEN = (16, 32, 48, 64), 16, 128
# --profile: the paths with a prefill and a decode window, and the suffix of
# their files
PROFILED_PATHS = {SERVE_ARCH: "", "gemma2-9b": "_gemma2"}
LOGIT_CHUNK = 512  # positions unembedded at once by the finite-logits sweep
# float32 forward, kernels against plain versions: the same math summed in
# another order, through up to 42 layers; and token-by-token decode against
# the forward, the reference's own prefill/decode tolerance
# (tests/test_models.py)
CONSISTENCY_TOL = 2e-3


def expect_launches(counts: dict, want: dict, what: str) -> None:
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def expected_launches(cfg) -> dict:
    """Kernel launches of one full-sequence forward: flash attention in every
    self-attention layer (the encoder's too; cross-attention launches none),
    the SSD scan in every Mamba layer."""
    if cfg.family in ("ssm", "hybrid"):
        shared = cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid" else 0
        return {"flash_attention": shared, "ssd_scan": cfg.n_layers}
    enc = cfg.n_enc_layers if cfg.family == "encdec" else 0
    return {"flash_attention": cfg.n_layers + enc, "ssd_scan": 0}


def model_batch(cfg, B: int, S: int, gen, device) -> dict:
    """Random tokens (B, S), plus random float32 patch embeddings (vlm) or
    encoder frames (encdec), from ``gen``."""
    import torch

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=device, generator=gen)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((B, cfg.n_patches, cfg.d_model), device=device,
                                            generator=gen)
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.randn((B, cfg.enc_positions, cfg.d_model), device=device,
                                          generator=gen)
    return batch


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_family_path(cfg, batch: int, seq: int, check_batch: int, check_seq: int, *,
                    device="cuda", gen, decode_check: bool = False, shapes: dict | None = None,
                    profile: tuple[str, str] | None = None) -> dict:
    """The serving path of ``cfg`` in its dtype, random float32 weights from
    ``gen``: ``make_prefill`` on ``batch`` x ``seq`` tokens (plus the image
    prefix or the encoder frames), first and three more runs, each with the
    launch counts at 0 just before it and required to launch
    :func:`expected_launches` on the card; the logits of every position
    finite, unembedded ``LOGIT_CHUNK`` positions at a time; greedy
    ``ServeEngine.generate`` of ``MAX_NEW`` tokens for prompts of
    ``PROMPT_LENS``; then :func:`consistency` in float32. ``shapes`` records
    the kernels' shapes of the timed prefills; ``profile`` names the files
    of a prefill window and a decode window. The parameters are freed on
    return."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, make_prefill
    from repro_torch.tree import leaves

    on_card = torch.device(device).type == "cuda"
    model = build_model(cfg, device=device)
    t = time.perf_counter()
    params = model.init_params(gen)
    _sync(device)
    n_params = sum(x.numel() for x in leaves(params))
    log(f"serve path: {cfg.name} ({cfg.family}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}), {n_params} random float32 parameters from a "
        f"seeded generator ({time.perf_counter() - t:.1f} s)")
    want = expected_launches(cfg)
    B, S = batch, seq
    inputs = model_batch(cfg, B, S, gen, device)
    positions = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    prefill = make_prefill(model)
    res = {"arch": cfg.name, "family": cfg.family, "batch": B, "seq": S, "positions": positions,
           "params": n_params, "expected_launches": want}

    def run_prefill():
        with torch.inference_mode():
            return prefill(params, model.init_decode_state(B, ENGINE_MAX_LEN), inputs)

    restore = record_shapes(shapes) if shapes is not None and on_card else None
    times, launches, base = [], None, None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    for i in range(4):
        registry.reset_launch_counts()
        _sync(device)
        t = time.perf_counter()
        nxt, state = run_prefill()
        _sync(device)
        times.append((time.perf_counter() - t) * 1e3)
        launches = registry.launch_counts()
        if on_card:
            expect_launches(launches, want, f"{cfg.name} prefill")
        if state["length"] != S or nxt.shape != (B,) or int(nxt.max()) >= cfg.vocab_size:
            raise AssertionError(f"prefill returned length {state['length']}, tokens {nxt}")
    if restore is not None:
        restore()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    with torch.inference_mode():
        h, _ = model.forward(params, inputs)
        for s0 in range(0, h.shape[1], LOGIT_CHUNK):
            lg = model.unembed(params, h[:, s0:s0 + LOGIT_CHUNK])
            if lg.shape[-1] != cfg.vocab_size or not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"prefill logits at positions {s0}+ are not all finite")
        if h.shape[:2] != (B, positions):
            raise AssertionError(f"forward returned {tuple(h.shape)}")
        del h, lg
    first_ms, times = times[0], times[1:]
    ms = float(np.median(times))
    log(f"  prefill {B}x{S}" + (f" (+{cfg.n_patches} patches)" if cfg.family == "vlm" else "")
        + (f" (over {cfg.enc_positions} frames)" if cfg.family == "encdec" else "")
        + f": first {first_ms:.1f} ms, then {', '.join(f'{x:.1f}' for x in times)} ms (median "
        f"{ms:.1f} ms, {B * positions / ms * 1e3:.0f} positions/s); launches "
        f"{ {k: launches[k] for k in want} } (expected {want}); logits finite at every position; "
        f"peak device memory {peak} bytes" + (f" ({peak / 2**30:.2f} GiB)" if peak else ""))
    res.update(prefill_first_ms=first_ms, prefill_ms=times,
               prefill_tokens_per_s=B * positions / ms * 1e3,
               prefill_launches={k: launches[k] for k in want}, prefill_peak_bytes=peak,
               prefill_base_bytes=base)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]
    engine = ServeEngine(model, params, max_len=ENGINE_MAX_LEN)
    engine.generate([p[:2] for p in prompts], max_new=2)  # warm-up
    _sync(device)
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

    if profile is not None:
        _profile(run_prefill, profile[0], f"one prefill of {cfg.name} at {B}x{S}")
        short = [[1 + i + j for j in range(8)] for i in range(4)]
        _profile(lambda: engine.generate(short, max_new=8), profile[1],
                 f"15 decode steps of {cfg.name} at batch 4")
    del engine
    res["consistency"] = consistency(model, params, check_batch, check_seq, gen, device,
                                     decode_check)
    return res


def consistency(model, params, B: int, S: int, gen, device, decode_check: bool) -> dict:
    """The model in float32 on B x S tokens: the kernel path's logits
    against the same forward through the plain versions, and with
    ``decode_check`` against decode_step fed token by token."""
    import dataclasses

    import torch

    from repro_torch.kernels import registry
    from repro_torch.models import build_model

    cfg = dataclasses.replace(model.cfg, dtype="float32")
    m32 = build_model(cfg, device=device)
    batch = model_batch(cfg, B, S, gen, device)
    on_card = torch.device(device).type == "cuda"
    with torch.inference_mode():
        routing = MoeRouting()
        registry.reset_launch_counts()
        with routing.record():
            logits = m32.unembed(params, m32.forward(params, batch)[0])
        if on_card:
            expect_launches(registry.launch_counts(), expected_launches(cfg), "float32 forward")
        with registry.use_backend("torch"), routing.replay():
            registry.reset_launch_counts()
            plain = m32.unembed(params, m32.forward(params, batch)[0])
            expect_launches(registry.launch_counts(), {"ssd_scan": 0, "flash_attention": 0},
                            "plain forward")
        err_dec = None
        if decode_check:
            state = m32.init_decode_state(B, S, dtype=torch.float32)
            dec = []
            for t in range(S):
                lg, state = m32.decode_step(params, state, {"token": batch["tokens"][:, t:t + 1]})
                dec.append(lg)
            dec = torch.stack(dec, dim=1)
            err_dec = float((logits - dec).abs().max())
    scale = float(logits.abs().max())
    err_plain = float((logits - plain).abs().max())
    log(f"  consistency at full width, float32, {B}x{S} (logits up to {scale:.4f}): kernel path "
        f"vs plain versions max abs err {err_plain:.3e}"
        + (f"; vs token-by-token decode {err_dec:.3e}" if decode_check else "")
        + f" (tolerance atol = rtol = {CONSISTENCY_TOL})")
    if routing.decisions:
        log(f"  routing: the plain forward replayed the kernel path's experts in "
            f"{len(routing.decisions)} MoE layers; {routing.flips} of {routing.tokens} tokens "
            f"would have picked another top-{cfg.top_k} set, each at a near-tie (largest gap "
            f"between the k-th and next probability {routing.max_gap:.2e}, limit "
            f"{ROUTING_TIE_GAP})")
        if routing.max_gap > ROUTING_TIE_GAP:
            raise AssertionError(f"a routing decision differs at a gap of {routing.max_gap}")
    torch.testing.assert_close(logits, plain, atol=CONSISTENCY_TOL, rtol=CONSISTENCY_TOL)
    if decode_check:
        torch.testing.assert_close(logits, dec, atol=CONSISTENCY_TOL, rtol=CONSISTENCY_TOL)
    return {"batch": B, "seq": S, "logit_scale": scale, "kernel_vs_plain_max_abs_err": err_plain,
            "forward_vs_decode_max_abs_err": err_dec, "tol": CONSISTENCY_TOL,
            "routing_flips": routing.flips, "routing_tokens": routing.tokens,
            "routing_max_gap": routing.max_gap}


# a routing decision may differ between two forwards that differ by float32
# summation order only where the router's k-th and next probabilities are
# this close
ROUTING_TIE_GAP = 1e-4


class MoeRouting:
    """Makes two forwards of a MoE model route alike. ``record()`` keeps the
    top-k experts each ``moe.route`` call picks; ``replay()`` has the next
    forward's calls take them back in order, with their own probabilities
    at those experts renormalised, and counts the tokens whose own top-k set
    differs (a near-tie of the k-th and next probability, which float32
    summation order can tip: it changes that token's output and, through
    capacity, the ranks after it). ``max_gap`` is the largest such gap."""

    def __init__(self):
        self.decisions, self.flips, self.tokens, self.max_gap = [], 0, 0, 0.0

    def _wrap(self, fn):
        import contextlib

        from repro_torch.models import moe

        @contextlib.contextmanager
        def ctx():
            orig = moe.route
            moe.route = lambda p, xt, cfg: fn(orig, p, xt, cfg)
            try:
                yield
            finally:
                moe.route = orig

        return ctx()

    def record(self):
        def rec(orig, p, xt, cfg):
            out = orig(p, xt, cfg)
            self.decisions.append(out[2])
            return out

        return self._wrap(rec)

    def replay(self):
        import torch

        it = iter(list(self.decisions))

        def rep(orig, p, xt, cfg):
            probs, _, own = orig(p, xt, cfg)
            top_e = next(it)
            differ = (own.sort(dim=-1).values != top_e.sort(dim=-1).values).any(dim=-1)
            self.flips += int(differ.sum())
            self.tokens += differ.numel()
            if bool(differ.any()):
                ranked = probs.sort(dim=-1, descending=True).values
                gap = ranked[..., cfg.top_k - 1] - ranked[..., cfg.top_k]
                self.max_gap = max(self.max_gap, float(gap[differ].max()))
            top_p = torch.gather(probs, -1, top_e)
            return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_e

        return self._wrap(rep)


# -- model kernel phase -------------------------------------------------------------------

# -- the train phase ---------------------------------------------------------------

TRAIN_ARCH, TRAIN_HYBRID = "olmo-1b", "zamba2-1.2b"
# one shard of a pretraining data-prep job: 1M documents per worker, about
# 4.1e9 tokens at the corpus's mean length of 512
TRAIN_DOCS, TRAIN_CHECK_DOCS, TRAIN_WORKERS = 8_000_000, 200_000, 8
# train_4k (src/repro/launch/shapes.py): sequence 4096, global batch 256 cut
# to 8 on one card, in 2 microbatches
TRAIN_B, TRAIN_S, TRAIN_MB, TRAIN_STEPS, TRAIN_REPEAT = 8, 4096, 2, 5, 5
TRAIN_WARMUP = 10  # the default lr 3e-4, reached within the short run
GRAD_B, GRAD_S, GRAD_LAYERS = 2, 1024, {TRAIN_ARCH: 2, TRAIN_HYBRID: 7}
GRAD_TOL = 1e-4  # float32, of each gradient's largest magnitude
# with Mamba layers: the SSD layers' float32 gradients are ill-conditioned.
# Against the plain scan in float64, the float32 plain path reads 7.6e-5 to
# 1.8e-4 of a leaf's largest magnitude and the kernel path 6.6e-5 to 2.3e-4,
# so the kernel path and the float32 plain path differ by up to their sum,
# 3.8e-4 on one seed; ``ssd_grad_rule`` sets the limit from that sum, below
# a third of the TF32-operand control (1.4e-2 to 3.8e-2), over 8 seeds of
# zamba2-1.2b at 7 layers (``--grad-readings`` on an H100, PERF.md section 6)
SSD_GRAD_TOL = 1e-3
GRAD_READING_SEEDS = 8
HYBRID_B, HYBRID_S, HYBRID_STEPS = 2, 4096, 2
# a second step from the live and the restored state: equal by bits unless a
# backward op accumulates in a nondeterministic order; then within this
RESTORE_LOSS_RTOL = 1e-4
# the meshes the train checkpoint is rescaled onto: the reference's elastic
# test's (tests/test_fault_tolerance.py) and the 16 x 16 production layout
RESCALE_MESHES = ((2, 1), (8, 1), (4, 2), "16x16")


def train_launches(cfg, microbatches: int) -> dict:
    """Kernel launches of one train step: each layer is recomputed in the
    backward (``remat``), so every forward launch happens twice per
    microbatch; the backward launches no kernel."""
    return {k: 2 * n * microbatches for k, n in expected_launches(cfg).items()}


def train_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Model flops of one step: 6 N per token, plus the causal attention
    products (2 B H S^2 hd per layer forward) three times (forward and
    backward); recomputation not counted."""
    attn_layers = expected_launches(cfg)["flash_attention"]
    return 6.0 * n_params * B * S + 3 * attn_layers * 2.0 * B * cfg.n_heads * S * S * cfg.head_dim


def _tree_bytes(tree) -> int:
    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _train_batch(cfg, B: int, S: int, gen, device) -> dict:
    """Random tokens (and the family's inputs) from ``gen``, next-token
    labels, every position in the loss."""
    import torch

    b = model_batch(cfg, B, S, gen, device)
    b["labels"] = torch.roll(b["tokens"], -1, dims=1)
    b["loss_mask"] = torch.ones((B, S), dtype=torch.float32, device=device)
    return b


def _finite(m: dict, what: str) -> None:
    for k in ("loss", "grad_norm"):
        if not np.isfinite(float(m[k])):
            raise AssertionError(f"{what}: {k} is {float(m[k])}")


def run_pipeline(cfg, *, device, n_docs: int, check_docs: int, workers: int, batch: int,
                 seq: int) -> tuple:
    """``TokenPipeline`` at ``n_docs`` with the launch counts at 0 just
    before it: hash_partition must launch on the card, the histogram
    variant never; the stages' properties; and at ``check_docs`` the card's
    documents equal the CPU's by bits. Returns (pipeline, record)."""
    import torch

    from repro_torch.core import DDFContext
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import registry

    on_card = torch.device(device).type == "cuda"
    kw = dict(vocab=cfg.vocab_size, seq_len=seq, batch=batch, seed=0)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    t = time.perf_counter()
    pipe = TokenPipeline(DDFContext(nworkers=workers, device=device), n_docs=n_docs, **kw)
    _sync(device)
    wall = time.perf_counter() - t
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    docs = pipe.docs.to_numpy()
    counts = pipe.docs.counts.cpu().numpy()
    _require(launches["hash_partition_hist"] == 0, f"pipeline launched the histogram: {launches}")
    _require(not on_card or launches["hash_partition"] > 0, f"pipeline launches {launches}")
    _require(len(np.unique(docs["content_hash"])) == pipe.n_docs, "duplicate content hashes")
    _require(bool((docs["quality"] > 0.05).all()), "a document below the quality threshold")
    _require(bool((np.diff(docs["length"]) >= 0).all()), "lengths out of order")
    _require(int(counts.max() - counts.min()) <= 1, f"worker counts {counts}")
    small = [TokenPipeline(DDFContext(nworkers=workers, device=d), n_docs=check_docs, **kw)
             .docs.to_numpy() for d in (device, "cpu")]
    for k in small[1]:
        _require(small[0][k].tobytes() == small[1][k].tobytes(),
                 f"pipeline at {check_docs} docs: {k} differs between {device} and the CPU")
    rec = {"n_docs": n_docs, "workers": workers, "wall_s": wall, "docs": pipe.n_docs,
           "total_tokens": pipe.total_tokens, "batches": pipe.stream_info.get("batches"),
           "launches": launches, "peak_bytes": peak, "check_docs": check_docs}
    log(f"  pipeline: {n_docs} documents on {workers} workers in {wall:.1f} s "
        f"({rec['batches']} streamed batches): {pipe.n_docs} after dedup and the quality "
        f"filter, {pipe.total_tokens} tokens; launches {rec['launches']}; peak device memory "
        f"{peak} bytes; distinct hashes, quality > 0.05, lengths sorted, worker counts "
        f"{counts.min()}-{counts.max()}; at {check_docs} documents {device} == CPU by bits")
    return pipe, rec


def rescale_check(ckpt_dir: str, step: int, state: dict, device) -> dict:
    """``train.elastic.rescale_state`` of ``state``'s checkpoint at ``step``
    onto each of :data:`RESCALE_MESHES`, one restored state at a time: the
    step number, every leaf equal to ``state``'s by bits, every
    coordinate's shard a view of its leaf (the same storage) with
    ``sharding.local_shape``, and ``bytes_per_device`` equal to the bytes
    of each coordinate's views. On the card it records the peak device
    memory of each restore and its checks."""
    from repro_torch import sharding
    from repro_torch.launch.mesh import MeshLayout, make_production_mesh
    from repro_torch.train.elastic import rescale_state
    from repro_torch.tree import flatten

    import torch

    on_card = torch.device(device).type == "cuda"
    live = flatten(state)
    out = {}
    for sizes in RESCALE_MESHES:
        mesh = make_production_mesh() if sizes == "16x16" else MeshLayout.of(sizes)
        name = "x".join(str(n) for n in mesh.shape.values())
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rs, got_step = rescale_state(ckpt_dir, step, state, mesh, device=device)
        _sync(device)
        restore_s = time.perf_counter() - t
        _require(got_step == step, f"rescale onto {name}: step {got_step}, not {step}")
        flat, specs = flatten(rs), flatten(rs.specs)
        _require(list(flat) == list(live) and all(
            _equal_bits(flat[k], live[k]) for k in live),
            f"rescale onto {name}: the restored state differs from the live one")
        per_device = rs.bytes_per_device()
        coords = 0
        for coord in rs.plan.coords():
            views = flatten(rs.local(coord))
            for k, v in views.items():
                _require(v.untyped_storage().data_ptr() == flat[k].untyped_storage().data_ptr()
                         and tuple(v.shape) == sharding.local_shape(flat[k].shape, specs[k],
                                                                    rs.plan),
                         f"rescale onto {name}: {k} at {coord} is not a view of local_shape")
            held = sum(v.numel() * v.element_size() for v in views.values())
            _require(held == per_device, f"rescale onto {name} at {coord}: views hold {held} "
                     f"bytes, bytes_per_device {per_device}")
            coords += 1
        check_s = time.perf_counter() - t - restore_s
        peak = torch.cuda.max_memory_allocated() if on_card else None
        out[name] = {"devices": coords, "bytes_per_device": per_device,
                     "restore_s": restore_s, "check_s": check_s, "peak_bytes": peak}
        log(f"  rescale onto {name} ({coords} devices): step {got_step}, equal by bits, "
            f"{len(flat)} leaves x {coords} coordinates of views; {per_device} bytes per "
            f"device ({per_device / 2**30:.3f} GiB); restore {restore_s:.1f} s, checks "
            f"{check_s:.2f} s; peak device memory {peak} bytes")
        del rs, flat, views
        gc.collect()
    return out


def _equal_bits(a, b) -> bool:
    """Two tensors of one dtype equal by bits (float32 and int32 leaves)."""
    import torch

    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _steps(step_fn, state, batches, want: dict | None, what: str, guard=None):
    """Each batch one step, the launch counts at 0 before it and ``want``
    after it; returns (state, losses, ms per step, metrics, the last step's
    launch counts as read, every kernel)."""
    from repro_torch.kernels import registry
    from repro_torch.plan.executor import sync

    losses, ms, m = [], [], None
    for i, b in enumerate(batches):
        registry.reset_launch_counts()
        t = time.perf_counter()
        if guard is not None:
            state, m = guard.step(i, step_fn, state, b)
        else:
            state, m = step_fn(state, b)
            sync(m["loss"])
        ms.append((time.perf_counter() - t) * 1e3)
        launches = registry.launch_counts()
        if want is not None:
            expect_launches(launches, want, f"{what} step {i}")
        _require(launches["hash_partition_hist"] == 0, f"{what}: histogram launched")
        _finite(m, f"{what} step {i}")
        losses.append(float(m["loss"]))
    return state, losses, ms, m, launches


def _grads(cfg, params, batch, device, backend: str):
    """(loss, gradient tree) of one float32 ``value_and_grad`` of the train
    loss with the registry's ``backend``."""
    from repro_torch.kernels import registry
    from repro_torch.models import build_model
    from repro_torch.train.train_step import TrainHParams, make_loss_fn, value_and_grad

    with registry.use_backend(backend):
        (loss, _), g = value_and_grad(make_loss_fn(build_model(cfg, device=device),
                                                   TrainHParams()), params, batch)
    return float(loss), g


def _grad_setup(cfg, n_layers: int, B: int, S: int, gen, device):
    import dataclasses

    from repro_torch.models import build_model

    cfg = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    params = build_model(cfg, device=device).init_params(gen)
    return cfg, params, _train_batch(cfg, B, S, gen, device)


def grad_limit(cfg) -> float:
    return SSD_GRAD_TOL if cfg.family in ("ssm", "hybrid") else GRAD_TOL


def grad_check(cfg, n_layers: int, B: int, S: int, gen, device) -> dict:
    """One float32 ``value_and_grad`` of the train loss through the kernels
    (their autograd Functions) against the same with the plain versions
    pinned (plain autograd): every parameter's gradient within
    :func:`grad_limit` of its largest magnitude."""
    import torch

    from repro_torch.kernels import registry

    cfg, params, batch = _grad_setup(cfg, n_layers, B, S, gen, device)
    registry.reset_launch_counts()
    loss, grads = _grads(cfg, params, batch, device, "auto")
    launches = registry.launch_counts()
    ploss, pgrads = _grads(cfg, params, batch, device, "torch")
    errs = _rel_errs(grads, pgrads)
    worst = max(errs, key=errs.get)
    limit = grad_limit(cfg)
    _require(errs[worst] <= limit, f"{cfg.name} gradients: {worst} off by {errs[worst]:.3e} "
             f"(limit {limit:.3e})")
    if torch.device(device).type == "cuda":
        expect_launches(launches, train_launches(cfg, 1), f"{cfg.name} gradient check")
    log(f"  gradients, {cfg.name} at {n_layers} layers, {B}x{S}, float32: kernel path "
        f"(launches {launches['flash_attention']} flash, {launches['ssd_scan']} ssd) vs plain "
        f"autograd: loss {loss:.6f} vs {ploss:.6f}; worst leaf {worst} {errs[worst]:.3e} of "
        f"its largest magnitude; limit {limit:.3e}")
    return {"layers": n_layers, "batch": B, "seq": S, "loss": loss, "plain_loss": ploss,
            "max_rel_err": errs, "limit": limit, "launches": launches}


def _tf32(t):
    """``t`` (float32) with the 13 low mantissa bits cleared, TF32's
    10-bit mantissa, as a kernel that dropped the 3xTF32 residual products
    would read it; the gradient passes straight through."""
    import torch

    r = (t.contiguous().view(torch.int32) & -8192).view(torch.float32)
    return t + (r - t).detach()


def grad_readings(cfgs: dict, seeds: int, B: int, S: int, device="cuda") -> dict:
    """The readings behind :data:`SSD_GRAD_TOL`: for each of ``seeds``
    seeded parameter sets and batches of each ``cfgs`` entry ({config:
    layers}), the worst leaf's distance (of its largest magnitude) from the
    plain path's float32 gradients of the kernel path, of the plain scan at
    half the chunk (the same sums in another order) and of the control, the
    plain scan on TF32 operands (x, B and C); and from the gradients with
    the plain scan in float64, of the kernel path (``kernel64``, the
    kernel's own error) and of the float32 plain path (``plain64``, its
    summation order and rounding). Nothing is required."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def scan(fn):
        ref = ops.ssd_scan_ref
        ops.ssd_scan_ref = lambda x, dt, A, B_, C, D, *, chunk: fn(ref, x, dt, A, B_, C, D,
                                                                      chunk)
        try:
            yield
        finally:
            ops.ssd_scan_ref = ref

    def tf32(ref, x, dt, A, B_, C, D, chunk):
        return ref(_tf32(x), dt, A, _tf32(B_), _tf32(C), D, chunk=chunk)

    def f64(ref, x, dt, A, B_, C, D, chunk):
        return ref(x, dt, A, B_, C, D, chunk=chunk, compute=torch.float64)

    names = ("kernel", "reorder", "control", "kernel64", "plain64")
    out = {}
    for base, n_layers in cfgs.items():
        rows = []
        for seed in range(seeds):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            cfg, params, batch = _grad_setup(base, n_layers, B, S, gen, device)
            _, pgrads = _grads(cfg, params, batch, device, "torch")

            def worst(g, exp):
                errs = _rel_errs(g, exp)
                k = max(errs, key=errs.get)
                return errs[k], k

            row = {"seed": seed}
            kgrads = _grads(cfg, params, batch, device, "auto")[1]
            row["kernel"], row["kernel_leaf"] = worst(kgrads, pgrads)
            if cfg.family in ("ssm", "hybrid"):
                half = dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // 2)
                row["reorder"], row["reorder_leaf"] = worst(
                    _grads(half, params, batch, device, "torch")[1], pgrads)
                with scan(tf32):
                    row["control"], row["control_leaf"] = worst(
                        _grads(cfg, params, batch, device, "torch")[1], pgrads)
                with scan(f64):
                    grads64 = _grads(cfg, params, batch, device, "torch")[1]
                row["kernel64"], row["kernel64_leaf"] = worst(kgrads, grads64)
                row["plain64"], row["plain64_leaf"] = worst(pgrads, grads64)
                del grads64
            log(f"  {cfg.name} at {n_layers} layers, {B}x{S}, seed {seed}: "
                + "; ".join(f"{k} {row[k]:.3e} ({row[k + '_leaf']})" for k in names if k in row))
            rows.append(row)
            del params, batch, pgrads, kgrads
            gc.collect()
        out[base.name] = {"layers": n_layers, "batch": B, "seq": S, "rows": rows}
        for k in names:
            vals = [r[k] for r in rows if k in r]
            if vals:
                out[base.name][k] = {"min": min(vals), "max": max(vals)}
        if "kernel64" in out[base.name]:
            out[base.name]["rule"] = ssd_grad_rule(rows)
        log(f"  {base.name}: " + json.dumps({k: v for k, v in out[base.name].items()
                                             if k in names + ("rule",)}))
    return out


SSD_GRAD_CHOICES = (2e-4, 3e-4, 5e-4, 1e-3)


def ssd_grad_rule(rows: list[dict]) -> float:
    """The SSD families' gradient limit from float64 readings (PERF.md
    section 6, fixed before them): the kernel path's distance from the
    float32 plain path is at most its distance from the float64 plain path
    plus the float32 plain path's; the limit is the smallest choice at
    least 1.5 x the largest per-seed sum and at most a third of the
    smallest control reading, else the standing 1e-3 (never more)."""
    need = 1.5 * max(r["kernel64"] + r["plain64"] for r in rows)
    room = min(r["control"] for r in rows) / 3
    return next((c for c in SSD_GRAD_CHOICES if need <= c <= room), SSD_GRAD_CHOICES[-1])


def _rel_errs(got: dict, exp: dict) -> dict:
    """{leaf: max |got - exp| / max |exp|}."""
    from repro_torch.tree import flatten

    errs, exp = {}, flatten(exp)
    for k, g in flatten(got).items():
        e = exp[k]
        scale = float(e.abs().max())
        errs[k] = float((g - e).abs().max()) / scale if scale else float(g.abs().max())
    return errs


def run_train_path(dense_cfg, hybrid_cfg, *, device="cuda", n_docs: int = TRAIN_DOCS,
                   check_docs: int = TRAIN_CHECK_DOCS, workers: int = TRAIN_WORKERS,
                   batch: int = TRAIN_B, seq: int = TRAIN_S, microbatches: int = TRAIN_MB,
                   steps: int = TRAIN_STEPS, repeat_steps: int = TRAIN_REPEAT,
                   grad_batch: int = GRAD_B, grad_seq: int = GRAD_S,
                   grad_layers: tuple = (GRAD_LAYERS[TRAIN_ARCH], GRAD_LAYERS[TRAIN_HYBRID]),
                   hybrid_batch: int = HYBRID_B, hybrid_seq: int = HYBRID_S,
                   hybrid_steps: int = HYBRID_STEPS, ckpt_dir: str | None = None,
                   shapes: dict | None = None, profile: str | None = None) -> dict:
    """The trainer on ``device``: ``TokenPipeline`` -> ``init_train_state``
    -> ``make_train_step`` under ``StepGuard`` -> ``checkpoint.save`` /
    ``restore``, for ``dense_cfg`` (olmo-1b at full width on the card) fed
    by the pipeline, then the kernel path's gradients against plain
    autograd, and ``hybrid_cfg`` (zamba2-1.2b), whose forward launches both
    model kernels. Every step runs with the launch counts at 0 and must
    launch :func:`train_launches` on the card; the records hold the counts
    as read. ``shapes`` receives, per model, the kernels' shapes of its
    first step on the card."""
    import tempfile

    import torch

    from repro_torch.models import build_model
    from repro_torch.train import checkpoint
    from repro_torch.train.elastic import StepGuard
    from repro_torch.tree import leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainHParams, init_train_state, make_train_step

    on_card = torch.device(device).type == "cuda"
    res = {}
    t0 = time.perf_counter()
    pipe, res["pipeline"] = run_pipeline(dense_cfg, device=device, n_docs=n_docs,
                                         check_docs=check_docs, workers=workers, batch=batch,
                                         seq=seq)
    tmp = tempfile.TemporaryDirectory(prefix="train-ckpt-") if ckpt_dir is None else None
    ckpt_dir = tmp.name if tmp is not None else ckpt_dir

    # -- the dense model, fed by the pipeline
    model = build_model(dense_cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(MODEL_SEED)
    state = init_train_state(model, gen)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    hp = TrainHParams(opt=AdamWConfig(warmup_steps=TRAIN_WARMUP), microbatches=microbatches)
    step_fn = make_train_step(model, hp)
    want = train_launches(dense_cfg, microbatches) if on_card else None
    log(f"  {dense_cfg.name}: {n_params} float32 parameters from a seeded generator, "
        f"{dense_cfg.dtype} compute, train state {_tree_bytes(state)} bytes; "
        f"batch {batch}x{seq} in {microbatches} microbatches; AdamW lr {hp.opt.lr}, warmup "
        f"{hp.opt.warmup_steps} steps; launches per step expected {want}")
    base = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    first = next(pipe)
    restore = (record_shapes(shapes.setdefault(dense_cfg.name, {}))
               if shapes is not None and on_card else None)
    state, losses, first_ms, _, _ = _steps(step_fn, state, [first], want, dense_cfg.name)
    if restore is not None:
        restore()
    guard = StepGuard(os.path.join(ckpt_dir, "emergency"))
    pipe_batches = [next(pipe) for _ in range(steps)]
    state, more, ms, m, launches = _steps(step_fn, state, pipe_batches, want, dense_cfg.name,
                                          guard)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    losses += more
    step_ms = float(np.median(ms))
    positions = batch * seq
    loss_tokens = float(np.mean([b["loss_mask"].sum() for b in pipe_batches]))
    flops = train_flops(dense_cfg, n_params, batch, seq)
    tflops = flops / (step_ms / 1e3) / 1e12
    log(f"  {dense_cfg.name} steps: first {first_ms[0]:.1f} ms, then "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms through StepGuard (median {step_ms:.1f} ms): "
        f"{positions / step_ms * 1e3:.0f} positions/s, {loss_tokens / step_ms * 1e3:.0f} loss "
        f"tokens/s ({loss_tokens / positions:.1%} of positions in the loss); {flops:.3e} model "
        f"flops per step, {tflops:.1f} TFLOP/s ({tflops * 1e12 / BF16_FLOPS_PER_S:.1%} of "
        f"989); launches per step {launches}; losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"grad_norm "
        f"{float(m['grad_norm']):.4f}; peak device memory {peak} bytes"
        + (f" ({peak / 2**30:.2f} GiB)" if peak else "")
        + f"; emergency saves {guard.emergency_saves}")
    rep = next(pipe)
    state, rep_losses, _, _, _ = _steps(step_fn, state, [rep] * repeat_steps, want,
                                        dense_cfg.name)
    _require(rep_losses[-1] < rep_losses[0], f"loss on a repeated batch did not fall: "
             f"{rep_losses}")
    log(f"  {repeat_steps} steps on one repeated batch: losses "
        f"{', '.join(f'{x:.4f}' for x in rep_losses)}")
    res["dense"] = {"arch": dense_cfg.name, "params": n_params, "batch": batch, "seq": seq,
                    "microbatches": microbatches, "lr": hp.opt.lr,
                    "warmup_steps": hp.opt.warmup_steps, "first_ms": first_ms[0], "ms": ms,
                    "positions_per_s": positions / step_ms * 1e3,
                    "loss_tokens_per_s": loss_tokens / step_ms * 1e3, "flops": flops,
                    "tflops": tflops, "launches": launches, "expected_launches": want,
                    "losses": losses,
                    "repeat_losses": rep_losses, "peak_bytes": peak, "base_bytes": base,
                    "state_bytes": _tree_bytes(state)}
    if profile:
        _profile(lambda: step_fn(state, rep), profile,
                 f"one train step of {dense_cfg.name} at {batch}x{seq}")

    # -- the checkpoint of the full state
    _sync(device)
    t = time.perf_counter()
    path = checkpoint.save(ckpt_dir, 1, state)
    save_s = time.perf_counter() - t
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    t = time.perf_counter()
    restored, step_no = checkpoint.restore(ckpt_dir, 1, state)
    _sync(device)
    restore_s = time.perf_counter() - t
    equal = step_no == 1 and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(leaves(state), leaves(restored)))
    _require(equal, "the restored state differs from the live one")
    res["rescale"] = rescale_check(ckpt_dir, 1, state, device)
    after = next(pipe)
    _, live, _, _, _ = _steps(step_fn, state, [after, after], want, "live")
    _, back, _, _, _ = _steps(step_fn, restored, [after, after], want, "restored")
    _require(live[0] == back[0], f"first step from the restored state: loss {back[0]} vs {live[0]}")
    second_bits = live[1] == back[1]
    _require(second_bits or abs(back[1] - live[1]) <= RESTORE_LOSS_RTOL * abs(live[1]),
             f"second step from the restored state: loss {back[1]} vs {live[1]}")
    shutil.rmtree(path)
    del restored
    res["checkpoint"] = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
                         "restored_equal": equal, "loss_equal": live[0] == back[0],
                         "second_loss_bits_equal": second_bits, "losses": [live, back]}
    log(f"  checkpoint: save {nbytes} bytes in {save_s:.1f} s "
        f"({nbytes / save_s / 1e9:.2f} GB/s), restore in {restore_s:.1f} s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s); restored == live by bits; two steps from "
        f"each: losses {live} and {back} (first by bits; second "
        + ("by bits)" if second_bits else f"within {RESTORE_LOSS_RTOL})"))
    del state, step_fn, pipe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- gradients through the kernels against plain autograd
    res["grad_check"] = {}
    for cfg, n in ((dense_cfg, grad_layers[0]), (hybrid_cfg, grad_layers[1])):
        res["grad_check"][cfg.name] = grad_check(cfg, n, grad_batch, grad_seq, gen, device)
        gc.collect()

    # -- the hybrid model: both model kernels under autograd
    model = build_model(hybrid_cfg, device=device)
    state = init_train_state(model, gen)
    n_params = sum(t.numel() for t in leaves(state["params"]))
    step_fn = make_train_step(model, TrainHParams())
    want = train_launches(hybrid_cfg, 1) if on_card else None
    base = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    hb = [_train_batch(hybrid_cfg, hybrid_batch, hybrid_seq, gen, device)
          for _ in range(hybrid_steps + 1)]
    restore = (record_shapes(shapes.setdefault(hybrid_cfg.name, {}))
               if shapes is not None and on_card else None)
    state, h_losses, h_ms, _, _ = _steps(step_fn, state, hb[:1], want, hybrid_cfg.name)
    if restore is not None:
        restore()
    state, more, more_ms, _, h_launches = _steps(step_fn, state, hb[1:], want,
                                                 hybrid_cfg.name)
    h_losses, h_ms = h_losses + more, h_ms + more_ms
    peak = torch.cuda.max_memory_allocated() if on_card else None
    h_step = float(np.median(h_ms[1:]))
    log(f"  {hybrid_cfg.name}: {n_params} parameters, batch {hybrid_batch}x{hybrid_seq}: "
        f"first step {h_ms[0]:.1f} ms, then {', '.join(f'{x:.1f}' for x in h_ms[1:])} ms "
        f"({hybrid_batch * hybrid_seq / h_step * 1e3:.0f} positions/s); launches per step "
        f"{h_launches} (expected {want}); losses {', '.join(f'{x:.4f}' for x in h_losses)}; peak device memory "
        f"{peak} bytes" + (f" ({peak / 2**30:.2f} GiB)" if peak else ""))
    res["hybrid"] = {"arch": hybrid_cfg.name, "params": n_params, "batch": hybrid_batch,
                     "seq": hybrid_seq, "first_ms": h_ms[0], "ms": h_ms[1:],
                     "launches": h_launches, "expected_launches": want,
                     "losses": h_losses, "peak_bytes": peak, "base_bytes": base}
    del state, step_fn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if tmp is not None:
        tmp.cleanup()
    res["cut"] = (f"train_4k's global batch of 256 sequences to {batch} on one card; "
                  f"documents not cut")
    res["wall_s"] = time.perf_counter() - t0
    log(f"  train path: {res['wall_s']:.1f} s; cut: {res['cut']}")
    return res


# -- the planned train phase --------------------------------------------------------

PLANNED_TIMEOUT_S = 420  # the child's start, its pipeline, 12 steps, two checkpoints
PLANNED_DOCS = 1_000_000  # the child's corpus: the train path runs 8M, the batches' shape is one
PLANNED_STEPS = 2
PLANNED_CKPT_LAYERS = 2  # the planned checkpoint's depth: the full state takes 19 s a save
# the planned serve legs: (arch, batch, prompt length) at published widths, a
# prefill then PLANNED_DECODE greedy decode steps; llava's prompt follows its
# 576 patches (8192 positions), whisper's 448 tokens read 1500 frames
PLANNED_SERVE = (("zamba2-1.2b", 4, 4096), ("granite-moe-3b-a800m", 4, 4096),
                 ("llava-next-mistral-7b", 2, 8192 - 576), ("whisper-tiny", 4, 448))
PLANNED_DECODE = 8
METRICS = ("loss", "nll", "ntok", "moe_aux", "grad_norm", "lr")


def _clone_state(state: dict) -> dict:
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), state)


def _timed_steps(step_fn, state, batches, want: dict | None, what: str, device):
    """Each batch one step with the launch and collective counts at 0 before
    it: (state, [metrics as floats], [ms], [launches], [collectives],
    [collectives' census], peak above the memory held before the first step
    and that memory, both None off the card)."""
    import torch

    from repro_torch.core.comm import fsdp
    from repro_torch.kernels import registry

    on_card = torch.device(device).type == "cuda"
    _sync(device)
    base = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    metrics, ms, launches, colls, census = [], [], [], [], []
    for i, b in enumerate(batches):
        registry.reset_launch_counts()
        fsdp.reset_counts()
        t = time.perf_counter()
        state, m = step_fn(state, b)
        _sync(device)
        ms.append((time.perf_counter() - t) * 1e3)
        got = registry.launch_counts()
        if want is not None:
            expect_launches(got, want, f"{what} step {i}")
        _require(got["hash_partition_hist"] == 0, f"{what}: histogram launched")
        _finite(m, f"{what} step {i}")
        metrics.append({k: float(m[k]) for k in METRICS})
        launches.append(got)
        colls.append(fsdp.counts())
        census.append(fsdp.census())
    peak = torch.cuda.max_memory_allocated() - base if on_card else None
    return state, metrics, ms, launches, colls, census, peak, base


def _leaf_bits(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def repeats(exp: dict, exp_m: list, again: dict, again_m: list) -> tuple[set, list]:
    """The leaves and, per step, the metrics on which two one-device runs
    from one state agree by bits."""
    from repro_torch.tree import flatten

    e, a = flatten(exp), flatten(again)
    return ({k for k, v in e.items() if _leaf_bits(v, a[k])},
            [{k for k in METRICS if em[k] == am[k]} for em, am in zip(exp_m, again_m)])


def hold_to_one_card(got: dict, got_m: list, exp: dict, exp_m: list, same: tuple, lr: float,
                     what: str) -> dict:
    """The planned run (state ``got``, metrics ``got_m``) against the one-card
    run (``exp``, ``exp_m``): by bits every leaf and metric on which two
    one-card runs agree by bits (``same``, from :func:`repeats`); elsewhere
    the moments within ``GRAD_TOL`` of each leaf's largest magnitude, the
    parameters within 2 lr (1e-3 lr in the mean: an update near a zero
    gradient may flip its sign), the metrics within rtol ``GRAD_TOL``.
    Returns the counts and the largest readings."""
    from repro_torch.tree import flatten

    g, e = flatten(got), flatten(exp)
    same_leaves, same_metrics = same
    _require(list(g) == list(e), f"{what}: the planned state's leaves differ from one card's")
    rec = {"leaves": len(e), "repeat": 0, "bits": 0, "moment_err": 0.0, "param_err_lr": 0.0,
           "metric_rtol": 0.0, "metrics_by_bits": 0, "metrics": len(exp_m) * len(METRICS)}
    for k, v in e.items():
        if k in same_leaves:
            rec["repeat"] += 1
            _require(_leaf_bits(g[k], v), f"{what}: {k} differs from one card's, whose two "
                     f"runs agree by bits")
            rec["bits"] += 1
            continue
        diff = (g[k].double() - v.double()).abs()
        if k.startswith("params/"):
            worst = float(diff.max()) / lr
            _require(worst <= 2 and float(diff.mean()) / lr <= 1e-3,
                     f"{what}: {k} moved {worst} lr from one card's")
            rec["param_err_lr"] = max(rec["param_err_lr"], worst)
        elif v.dim():
            scale = float(v.double().abs().max()) or 1.0
            err = float(diff.max()) / scale
            _require(err <= GRAD_TOL, f"{what}: {k} differs by {err} of its largest magnitude")
            rec["moment_err"] = max(rec["moment_err"], err)
    for i, (gm, em, sm) in enumerate(zip(got_m, exp_m, same_metrics)):
        for k in METRICS:
            if k in sm:
                _require(gm[k] == em[k], f"{what} step {i}: {k} {gm[k]} vs one card {em[k]}")
                rec["metrics_by_bits"] += 1
            else:
                err = abs(gm[k] - em[k]) / max(abs(em[k]), 1e-30)
                _require(err <= GRAD_TOL, f"{what} step {i}: {k} {gm[k]} vs {em[k]}")
                rec["metric_rtol"] = max(rec["metric_rtol"], err)
    return rec


def planned_vs_one(cfg, batches: list, microbatches: int, plan, device,
                   profile: str | None = None) -> dict:
    """``cfg``'s train step on one device, twice, and planned over the
    group's plan, once, each from the state the train path starts from and
    over ``batches`` (at world 1 a rank's rows are the whole batch): held
    by :func:`hold_to_one_card`; launches as the one-device step's."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.sharding import shard_batch
    from repro_torch.train.train_step import (TrainHParams, init_train_state, make_train_step,
                                              shard_train_state)

    on_card = torch.device(device).type == "cuda"
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(MODEL_SEED)
    whole = init_train_state(model, gen)
    hp = TrainHParams(opt=AdamWConfig(warmup_steps=TRAIN_WARMUP), microbatches=microbatches)
    want = train_launches(cfg, microbatches) if on_card else None
    one_step = make_train_step(model, hp)
    one, one_m, one_ms, one_l, _, _, one_peak, _ = _timed_steps(
        one_step, _clone_state(whole), batches, want, f"{cfg.name} one device", device)
    again, again_m, again_ms, _, _, _, _, _ = _timed_steps(
        one_step, _clone_state(whole), batches, want, f"{cfg.name} one device again", device)
    same = repeats(one, one_m, again, again_m)
    del again
    gc.collect()
    state = shard_train_state(whole, plan)
    del whole
    gc.collect()
    planned_step = make_train_step(model, hp, plan=plan)
    local = [shard_batch(b, plan, microbatches) for b in batches]
    state, got_m, ms, launches, colls, census, peak, base = _timed_steps(
        planned_step, state, local, want, f"{cfg.name} planned", device)
    lr = max(m["lr"] for m in one_m)
    rec = hold_to_one_card(state, got_m, one, one_m, same, lr, f"{cfg.name} planned")
    _require(all(c == colls[0] for c in colls), f"{cfg.name}: collectives vary by step {colls}")
    _require(all(c == census[0] for c in census), f"{cfg.name}: census varies by step {census}")
    rec.update(planned_dry_run(f"{cfg.name} planned step", cfg, batches[0],
                               census[0], plan, device, microbatches=microbatches,
                               peak=peak, base=base))
    rec.update({"arch": cfg.name, "batch": int(next(iter(batches[0].values())).shape[0]),
                "microbatches": microbatches, "planned_ms": ms, "one_ms": one_ms,
                "one_again_ms": again_ms,
                "planned_losses": [m["loss"] for m in got_m],
                "one_losses": [m["loss"] for m in one_m], "launches": launches[-1],
                "one_launches": one_l[-1], "collectives": colls[-1], "peak_extra_bytes": peak,
                "one_peak_extra_bytes": one_peak, "state_bytes": _tree_bytes(state)})
    if profile:
        events = _profile(lambda: planned_step(state, local[-1]), profile,
                          f"one planned train step of {cfg.name}")
        nccl = [e for e in events if "nccl" in e.key.lower()]
        rec["profile_nccl_ms"] = sum(e.self_device_time_total for e in nccl) / 1e3
        rec["profile_nccl_kernels"] = sum(e.count for e in nccl)
    del state, one
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return rec


def planned_dry_run(what: str, cfg, batch: dict, census: dict | None, plan, device, *,
                    kind: str = "train", microbatches: int = 1, peak: int | None = None,
                    base: int | None = None, **kw) -> dict:
    """The dry run (``launch.dryrun``) of this rank's step on the meta
    device at the plan's mesh and rank, on a batch of ``batch``'s shapes:
    its census of collectives must equal the step's ``census`` kind for
    kind (count and bytes), and with ``peak`` (the measured peak above
    ``base``, on the card) the measured must lie within :data:`PEAK_BAND`
    of the predicted peak above the resident arguments. Off the card the
    plain versions stand in for the kernels (a smoke config's head_dim has
    none), which changes no collective."""
    import contextlib

    import torch

    from repro_torch.kernels import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell

    mesh = tuple(plan.mesh.shape[a] for a in plan.mesh.axis_names)
    rank = 0
    for a in plan.mesh.axis_names:
        rank = rank * plan.mesh.shape[a] + plan.mesh.coord[a]
    inputs = {k: torch.empty(tuple(v.shape), dtype=torch.as_tensor(v).dtype, device="meta")
              for k, v in batch.items()}
    B, S = inputs["tokens"].shape[0], inputs["tokens"].shape[1]
    cell = ShapeCell("planned", S, B, kind)
    shape = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    if kind == "decode":  # one token a row: the cell's own inputs
        inputs = None
    kw.update(cell=cell, mesh=mesh, rank=rank, config=cfg, inputs=inputs,
              microbatches=microbatches)
    backend = (contextlib.nullcontext() if torch.device(device).type == "cuda"
               else registry.use_backend("torch"))
    with backend:
        if peak is None:
            dry = dryrun.rank_collectives(cfg.name, shape, **kw)["collectives"]
            rec = {}
        else:
            full = dryrun.run_cell(cfg.name, shape, save=False, verbose=False,
                                   card=dryrun.card_memory(), **kw)
            _require(full["status"] == "ok", f"{what}: dry run {full.get('error')}")
            dry = full["collectives"]["per_op"]
            m = full["memory"]
            rec = {"held_peak": held_peak(f"{what} against its dry run", m["peak_bytes"],
                                          m["resident_bytes"], peak + base, base)}
            _require(rec["held_peak"]["inside_band"],
                     f"{what}: measured peak outside {PEAK_BAND} of the dry run's")
    if census is not None:
        _require(census == dry, f"{what}: census {census} vs the dry run's {dry}")
        log(f"  {what}: collectives {census} equal to the dry run's at mesh {mesh}, "
            f"rank {rank}")
    return {"census": census, "dry_census": dry, **rec}


def planned_checkpoint(cfg, n_layers: int, plan, device) -> dict:
    """``cfg`` cut to ``n_layers``: a planned ``checkpoint.save`` of its
    sharded train state against one card's save of the whole state, file
    for file by bits; the planned restore gives the rank its shards."""
    import dataclasses
    import filecmp
    import tempfile

    import torch

    from repro_torch.models import build_model
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import (init_train_state, shard_train_state,
                                              train_state_specs)
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(MODEL_SEED)
    whole = init_train_state(model, gen)
    state = shard_train_state(whole, plan)
    with tempfile.TemporaryDirectory(prefix="planned-ckpt-") as tmp:
        t = time.perf_counter()
        path = checkpoint.save(os.path.join(tmp, "planned"), 1, state)
        save_s = time.perf_counter() - t
        one = checkpoint.save(os.path.join(tmp, "one"), 1, whole)
        names = sorted(os.listdir(path))
        equal = names == sorted(os.listdir(one)) and all(
            filecmp.cmp(os.path.join(path, n), os.path.join(one, n), shallow=False)
            for n in names)
        nbytes = sum(os.path.getsize(os.path.join(path, n)) for n in names)
        back, step = checkpoint.restore(os.path.join(tmp, "planned"), 1,
                                        train_state_specs(model), device=device, plan=plan)
        live, got = flatten(state), flatten(back)
        restored = step == 1 and list(got) == list(live) and all(
            _leaf_bits(got[k], live[k]) for k in live)
    _require(equal, f"the planned checkpoint's files differ from one card's: {names}")
    _require(restored, "the planned restore differs from the rank's shards")
    return {"arch": cfg.name, "layers": n_layers, "bytes": nbytes, "save_s": save_s,
            "equal": equal, "restored": restored}


def planned_serve(cfg, batch: int, seq: int, serve_plan, device, steps: int = PLANNED_DECODE,
                  gen_seed: int = MODEL_SEED + 2) -> dict:
    """``cfg``'s serving, random float32 weights in its dtype: ``make_prefill``
    on ``batch`` x ``seq`` random tokens, then ``steps`` greedy
    ``make_serve_step`` steps from its state, on one device and then under
    ``serve_plan`` (the rank's ``shard_params`` and
    ``init_decode_state(..., plan=)``, its rows of the batch), each with the
    launch and collective counts at 0 before it. The planned tokens must
    equal one device's by bits, and so must the prefill's launches (on the
    card :func:`expected_launches`) and the peak of requested bytes above
    the resident weights. The whole
    weights are freed before the planned run (llava's 29 GB of float32
    would not fit twice beside its run)."""
    import torch

    from repro_torch import sharding
    from repro_torch.core.comm import fsdp
    from repro_torch.kernels import registry
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.tree import leaves

    on_card = torch.device(device).type == "cuda"
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(gen_seed)
    params = model.init_params(gen)
    inputs = model_batch(cfg, batch, seq, gen, device)
    want = expected_launches(cfg)

    def run(p, plan):
        prefill, step = make_prefill(model, plan), make_serve_step(model, plan)
        rows = sharding.shard_batch(inputs, plan)
        n = rows["tokens"].shape[0]
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            req_base = torch.cuda.memory_stats()["requested_bytes.all.current"]
        registry.reset_launch_counts()
        fsdp.reset_counts()
        with torch.inference_mode():
            t = time.perf_counter()
            nxt, state = prefill(p, model.init_decode_state(n, seq + steps, plan=plan), rows)
            _sync(device)
            prefill_ms = (time.perf_counter() - t) * 1e3
            launches = registry.launch_counts()
            prefill_census = fsdp.census()
            toks = [nxt]
            t = time.perf_counter()
            for _ in range(steps):
                nxt, state = step(p, state, {"token": nxt[:, None]})
                toks.append(nxt)
            _sync(device)
            decode_ms = (time.perf_counter() - t) * 1e3 / steps
        if on_card:
            expect_launches(launches, want, f"{cfg.name} prefill")
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        # the bytes asked for: the allocator's blocks round a request up by up to 1 MiB
        # as its cache's history allows, which moves the allocated peak by as much
        requested = (torch.cuda.memory_stats()["requested_bytes.all.peak"] - req_base
                     if on_card else None)
        return {"tokens": torch.stack(toks), "launches": launches, "prefill_ms": prefill_ms,
                "decode_ms": decode_ms, "peak_extra_bytes": peak,
                "peak_requested_bytes": requested, "collectives": fsdp.counts(),
                "prefill_census": prefill_census, "census": fsdp.census()}

    one = run(params, None)
    n_params = sum(x.numel() for x in leaves(params))
    shards = sharding.shard_params(params, serve_plan)
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    planned = run(shards, serve_plan)
    rows = torch.as_tensor(sharding.batch_rows(batch, serve_plan), device=device)
    same = torch.equal(planned["tokens"], one["tokens"][:, rows])
    _require(same, f"{cfg.name}: the planned serving's tokens differ from one device's")
    _require(planned["launches"] == one["launches"],
             f"{cfg.name}: planned prefill launches {planned['launches']} vs one device "
             f"{one['launches']}")
    _require(planned["peak_requested_bytes"] == one["peak_requested_bytes"],
             f"{cfg.name}: planned peak requested above the weights "
             f"{planned['peak_requested_bytes']} bytes vs one device "
             f"{one['peak_requested_bytes']}")
    rec = {"arch": cfg.name, "batch": batch, "seq": seq, "steps": steps,
           "params": n_params,
           "tokens": int(planned["tokens"].numel()), "tokens_equal": same,
           "launches": {k: planned["launches"][k] for k in want}}
    for name, r in (("one", one), ("planned", planned)):
        rec.update({f"{name}_prefill_ms": r["prefill_ms"], f"{name}_decode_ms": r["decode_ms"],
                    f"{name}_peak_extra_bytes": r["peak_extra_bytes"],
                    f"{name}_peak_requested_bytes": r["peak_requested_bytes"]})
    rec["collectives"] = planned["collectives"]
    # each leg's census against the dry run of the same cut cell: the
    # prefill, and the decode steps as ``steps`` times one step's
    dry_kw = dict(plan_mode="serve", serve_dtype=None, cache_len=seq + steps)
    pre = planned["prefill_census"]
    rec["prefill_census"] = planned_dry_run(f"{cfg.name} planned prefill", cfg, inputs, pre,
                                            serve_plan, device, kind="prefill",
                                            **dry_kw)["census"]
    decode = {k: {f: v[f] - pre.get(k, {}).get(f, 0) for f in ("count", "bytes")}
              for k, v in planned["census"].items()}
    one_step = planned_dry_run(f"{cfg.name} planned serve step", cfg, inputs, None,
                               serve_plan, device, kind="decode", **dry_kw)["dry_census"]
    want = {k: {f: steps * v[f] for f in v} for k, v in one_step.items()}
    _require({k: v for k, v in decode.items() if v["count"]} == want,
             f"{cfg.name}: planned decode census {decode} vs {steps} x the dry run's {one_step}")
    rec["decode_census"] = want
    del shards, one, planned
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return rec


def run_planned_paths(dense_cfg, hybrid_cfg, *, device="cuda", n_docs: int = PLANNED_DOCS,
                      workers: int = TRAIN_WORKERS, batch: int = TRAIN_B, seq: int = TRAIN_S,
                      microbatches: int = TRAIN_MB, hybrid_batch: int = HYBRID_B,
                      hybrid_seq: int = HYBRID_S, steps: int = PLANNED_STEPS,
                      ckpt_layers: int = PLANNED_CKPT_LAYERS, profile: str | None = None,
                      serve=None, decode_steps: int = PLANNED_DECODE) -> dict:
    """The planned train step over the default process group (one rank:
    world 1, where every collective copies), ``make_plan`` of
    ``launch.mesh.make_group_mesh()``: the ``TokenPipeline`` over the group's
    ``DDFContext`` with the plan feeds ``dense_cfg`` (its launch counts at 0:
    hash_partition, never the histogram), ``hybrid_cfg`` takes random
    batches; each model's planned steps are held to its one-device steps
    (:func:`planned_vs_one`), then a planned checkpoint to one card's. Then
    the serve legs ``serve`` ((config, batch, prompt length) each, default
    ``PLANNED_SERVE`` at published widths) under the serve plan of the same
    mesh (:func:`planned_serve`)."""
    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.core import DDFContext
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import registry
    from repro_torch.launch.mesh import make_group_mesh

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    plan = sharding.make_plan(make_group_mesh())
    _require(plan.mesh.size == 1, f"the planned phase is held to one device at world 1, "
             f"not {plan.mesh.size}")
    registry.reset_launch_counts()
    t = time.perf_counter()
    pipe = TokenPipeline(DDFContext(nworkers=workers, device=device, group=dist.group.WORLD),
                         n_docs=n_docs, vocab=dense_cfg.vocab_size, seq_len=seq, batch=batch,
                         seed=0, plan=plan, microbatches=microbatches)
    _sync(device)
    pipe_s = time.perf_counter() - t
    launches = registry.launch_counts()
    _require(launches["hash_partition_hist"] == 0, f"pipeline launched the histogram: {launches}")
    _require(not on_card or launches["hash_partition"] > 0, f"pipeline launches {launches}")
    res = {"pipeline": {"n_docs": n_docs, "docs": pipe.n_docs, "wall_s": pipe_s,
                        "launches": launches}}
    dense = [next(pipe) for _ in range(steps)]
    res["dense"] = planned_vs_one(dense_cfg, dense, microbatches, plan, device, profile)
    gen = torch.Generator(device=device)
    gen.manual_seed(MODEL_SEED + 1)
    hybrid = [_train_batch(hybrid_cfg, hybrid_batch, hybrid_seq, gen, device)
              for _ in range(steps)]
    res["hybrid"] = planned_vs_one(hybrid_cfg, hybrid, 1, plan, device)
    res["checkpoint"] = planned_checkpoint(dense_cfg, ckpt_layers, plan, device)
    from repro_torch.configs import get_config

    serve_plan = sharding.make_plan(plan.mesh, mode="serve")
    legs = serve if serve is not None else [(get_config(a), b, s) for a, b, s in PLANNED_SERVE]
    t = time.perf_counter()
    res["serve"] = [planned_serve(cfg, b, s, serve_plan, device, decode_steps)
                    for cfg, b, s in legs]
    res["serve_wall_s"] = time.perf_counter() - t
    res["wall_s"] = time.perf_counter() - t0
    return res


def run_planned_rank(profile: str | None) -> int:
    """The child of :func:`run_planned_phase`: joins the one-rank NCCL group
    that torchrun's variables describe and runs :func:`run_planned_paths`
    on the train path's models; its record is the last line it prints."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.comm import group
    from repro_torch.kernels import cuda_lib

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's train path
    torch.backends.cudnn.allow_tf32 = False
    cuda_lib.load()  # the parent built the library: this loads it
    dev = group.init_from_env(timeout=GROUP_TIMEOUT_S)
    try:
        log(f"rank {dist.get_rank()} of {dist.get_world_size()} ({dist.get_backend()}) "
            f"on {dev}")
        res = run_planned_paths(get_config(TRAIN_ARCH), get_config(TRAIN_HYBRID), device=dev,
                                profile=profile)
    finally:
        group.close()
    log(json.dumps({"planned_paths": res}))
    return 0


def run_planned_phase(smi: str, profile: str | None) -> dict:
    """The planned train phase in a child process over a one-rank NCCL group
    on cuda:0 (:func:`run_planned_rank`); prints its step times, peaks,
    collectives and wall beside the one-device steps', with the card."""
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, os.path.abspath(__file__), "--planned-rank"]
    if profile:
        cmd += ["--profile", profile]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=PLANNED_TIMEOUT_S,
                          env=env, cwd=HERE)
    wall = time.perf_counter() - t
    lines = proc.stdout.splitlines()
    for ln in lines[:-1]:
        log(f"  | {ln}")
    if proc.returncode != 0 or not lines or not lines[-1].startswith('{"planned_paths"'):
        raise RuntimeError(f"the planned rank failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    res = json.loads(lines[-1])["planned_paths"]
    p = res["pipeline"]
    log(f"  pipeline over the group's DDFContext with the plan: {p['n_docs']} documents in "
        f"{p['wall_s']:.1f} s, {p['docs']} kept; launches {p['launches']}")
    for name in ("dense", "hybrid"):
        r = res[name]
        # the first one-device run warms the process up: its second run is the yardstick
        a, b = float(np.median(r["one_again_ms"])), float(np.median(r["planned_ms"]))
        pk, opk = r["peak_extra_bytes"], r["one_peak_extra_bytes"]
        log(f"  {r['arch']} ({r['batch']} rows, {r['microbatches']} microbatches) on {smi}: "
            f"planned {', '.join(f'{x:.1f}' for x in r['planned_ms'])} ms vs one device "
            f"{', '.join(f'{x:.1f}' for x in r['one_again_ms'])} ms in its second run "
            f"(first {', '.join(f'{x:.1f}' for x in r['one_ms'])}; median ratio {b / a:.3f}); "
            f"peak above the resident states {pk / 2**30:.2f} GiB planned vs "
            f"{opk / 2**30:.2f} GiB one device (with the {r['state_bytes'] / 2**30:.2f} GiB "
            f"state: {(pk + r['state_bytes']) / 2**30:.2f} vs "
            f"{(opk + r['state_bytes']) / 2**30:.2f} GiB); collectives per step "
            f"{r['collectives']}; launches {r['launches']} as one device's")
        log(f"    held to one device: {r['bits']} of {r['leaves']} leaves by bits (the "
            f"{r['repeat']} on which two one-device runs agree), the rest within "
            f"{r['moment_err']:.2e} of a moment's largest magnitude and "
            f"{r['param_err_lr']:.3f} lr; {r['metrics_by_bits']} of {r['metrics']} metrics by "
            f"bits, the rest within rtol {r['metric_rtol']:.2e}; losses {r['planned_losses']}"
            + (f"; profiled NCCL kernels {r['profile_nccl_ms']:.2f} ms in "
               f"{r['profile_nccl_kernels']} launches" if "profile_nccl_ms" in r else ""))
    c = res["checkpoint"]
    log(f"  planned checkpoint of {c['arch']} at {c['layers']} layers: {c['bytes']} bytes saved "
        f"in {c['save_s']:.1f} s, equal to one card's file for file by bits; the restore gives "
        f"the rank its shards by bits")
    for r in res["serve"]:
        log(f"  planned serve of {r['arch']} ({r['params']} parameters, {r['batch']} x "
            f"{r['seq']} prompt, {r['steps']} decode steps) on {smi}: prefill "
            f"{r['planned_prefill_ms']:.1f} ms planned vs {r['one_prefill_ms']:.1f} ms one "
            f"device, decode {r['planned_decode_ms']:.2f} vs {r['one_decode_ms']:.2f} ms a "
            f"step; peak above the resident weights "
            f"{r['planned_peak_extra_bytes'] / 2**30:.2f} vs "
            f"{r['one_peak_extra_bytes'] / 2**30:.2f} GiB (requested: "
            f"{r['planned_peak_requested_bytes']} vs {r['one_peak_requested_bytes']} bytes); "
            f"{r['tokens']} tokens equal to one "
            f"device's by bits; prefill launches {r['launches']} as one device's; "
            f"collectives {r['collectives']}")
    log(f"  planned phase: child process {wall:.1f} s (its paths {res['wall_s']:.1f} s, the "
        f"serve legs {res['serve_wall_s']:.1f} s)")
    res["child_wall_s"] = wall
    return res


FLASH_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}  # bf16: one output rounding;
# f32: sums over up to 8192 keys in another order
SSD_TOL = 3e-5  # of the output's largest magnitude, the reference's own kernel-test tolerance


def _normal(shape, dtype, gen):
    import torch

    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def _time_flash(q, k, v, kw, got, exp) -> dict:
    """The kernel's, the plain version's and scaled_dot_product_attention's
    times on one case (causal or bidirectional, no window), beside the bound
    of its work."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_work

    b, s, h, d = q.shape
    cz, sc = kw["causal"], kw["scale"]
    ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, force="cuda", **kw), iters=5)
    plain_ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, force="torch", **kw),
                            iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=cz, scale=sc)
    lib_err = max_abs_err(lib.transpose(1, 2), exp)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=cz, scale=sc), iters=5)
    flops, nbytes = flash_work(b, s, h, k.shape[2], d, q.element_size(), causal=cz)
    bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
            else "bytes",
            "library_ms": library_ms, "library": "scaled_dot_product_attention",
            "library_max_abs_err": lib_err, "shape": [b, s, h, k.shape[2], d],
            "dtype": str(q.dtype).split(".")[1], "causal": cz, "flops": flops, "bytes": nbytes,
            "tflops": flops / ms * 1e-9, "library_tflops": flops / library_ms * 1e-9}


def flash_phase(path_shapes: dict, gen):
    """flash_attention at every distinct configuration (shape, KV heads,
    causal, window, softcap, scale) that a serve path's prefill or a train
    step gave it, ``path_shapes`` mapping each path's name to its recorded
    set (the zamba2 prefill's first), and at extra cases: a ragged S, gemma2-9b's
    window at B = 1, olmo-1b's, stablelm-3b's (head_dim 80), whisper-tiny's
    encoder (bidirectional, S = 1500) and llava-next-mistral-7b's (window
    4096 at S = 8192); each held against its plain version in bf16 and
    float32, and timed in bf16 at the zamba2 prefill's shape and at
    stablelm-3b's beside the bound, the plain version and
    scaled_dot_product_attention."""
    import torch

    from repro_torch.kernels import ops

    cases, seen = [], set()

    def add(name, b, s, h, kv, d, cz, win, cap, sc):
        key = (b, s, h, kv, d, cz, win, cap, d ** -0.5 if sc is None else sc)
        if key not in seen:
            seen.add(key)
            cases.append((name, b, s, h, kv, d, cz, win, cap, sc))

    for path, shapes in path_shapes.items():
        # one case per configuration, whichever dtype the path ran it in
        for (b, s, h, d), kv, cz, win, cap, sc in sorted({r[:2] + r[3:] for r in shapes}, key=str):
            add(path, b, s, h, kv, d, cz, win, cap, sc)
    add("ragged", 1, cases[0][2] - 27, cases[0][3], cases[0][4], cases[0][5], True, None, None,
        None)
    add("gemma2-9b", 1, 8192, 16, 8, 256, True, 4096, 50.0, 256 ** -0.5)
    add("olmo-1b", 4, 2048, 16, 16, 128, True, None, None, None)
    add("stablelm-3b", 4, 4096, 32, 32, 80, True, None, None, None)
    add("whisper-tiny encoder", 4, 1500, 6, 6, 64, False, None, None, None)
    add("llava-next-mistral-7b", 2, 8192, 32, 8, 128, True, 4096, None, None)
    first = cases[0][0]
    timed = {first: None, "stablelm-3b": None}
    max_err = 0.0
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
            line = (f"  flash_attention {name} B={b} S={s} H={h} KV={kv} hd={d} causal={cz} "
                    f"window={win} softcap={cap} {dt}: max abs err {err:.2e} (tol {tol})")
            if name in timed and timed[name] is None and dt == torch.bfloat16:
                t = timed[name] = _time_flash(q, k, v, kw, got, exp)
                line += (f"; kernel {t['ms']:.3f} ms ({t['tflops']:.1f} TFLOP/s), plain "
                         f"{t['plain_ms']:.3f} ms, SDPA {t['library_ms']:.3f} ms "
                         f"({t['library_tflops']:.1f} TFLOP/s; vs plain "
                         f"{t['library_max_abs_err']:.1e}), bound {t['bound_ms']:.4f} ms")
            log(line)
            del q, k, v, got, exp
            torch.cuda.empty_cache()
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:82", **timed[first],
           "hd80": timed["stablelm-3b"], "cases": [list(c) for c in cases],
           "max_abs_err": max_err}
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


def ssd_phase(path_shapes: dict, gen):
    """ssd_scan at every shape (x, B, chunk) that a path gave it,
    ``path_shapes`` mapping each path's name to its recorded set (the zamba2
    prefill's first, one shape), a ragged length, and G = 2 with ds = 128 at
    chunks 64 and 256, held against its plain version; timed at the
    prefill's shape beside the bound and the plain version."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_work

    cases, seen = [], set()
    for path, shapes in path_shapes.items():
        for (b, L, H, dh), bshape, chunk, _ in sorted(shapes, key=str):
            key = (b, L, H, dh, bshape[2], bshape[3], chunk)
            if key not in seen:
                seen.add(key)
                cases.append(("prefill" if not cases else path,) + key)
    _, b, L, H, dh, G, ds, chunk = cases[0]
    cases += [("ragged", 2, L - 45, H, dh, G, ds, chunk), ("G2-ds128", 2, 2048, H, dh, 2, 128, 64),
              ("G2-ds128", 2, 2048, H, dh, 2, 128, 256)]
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
            flops, nbytes = ssd_work(b_, L_, H_, dh_, G_, ds_, ch)
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


# -- the launch phase ---------------------------------------------------------------

LAUNCH_WORKERS = 6  # processes for the meta dry runs: host work (the card machine has 8 cores)
# dryrun_ddf's rows per worker, cut from configs/paper_cylon.py's 25M: the
# join's own dry run holds 111.4 GiB there (55.7 GiB at 12.5M), and a run
# at 25M did not fit the card (PERF.md section 6)
DDF_ROWS_PER_WORKER = 12_500_000
LAUNCH_SPARE = 0.1  # a grid cell runs on the card when its predicted peak leaves this share free
# measured over predicted peak memory of a step, each counted above what was
# resident before it (PERF.md section 6, written before the first run)
PEAK_BAND = (0.9, 1.1)


def _gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def oracle_join_rows(left, right, n_keys: int) -> int:
    """Rows of the inner join on ``c0``: the sum over keys of cntL * cntR,
    :func:`numpy_oracle`'s ``join_rows`` without its groupby."""
    return int((np.bincount(left["c0"], minlength=n_keys).astype(np.int64)
                * np.bincount(right["c0"], minlength=n_keys)).sum())


def predict_serve_peak(arch: str, B: int, S: int) -> dict:
    """``op_cost`` on the meta device of one serve path's prefill as
    :func:`run_family_path` runs it: float32 weights, a fresh decode state
    of ``ENGINE_MAX_LEN`` positions, B x S tokens (after the image prefix
    for vlm, over the encoder frames for encdec), under inference mode."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.launch.shapes import ShapeCell, input_specs
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill
    from repro_torch.train.train_step import train_state_specs

    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    params = train_state_specs(model)["params"]
    positions = S + (cfg.n_patches if cfg.family == "vlm" else 0)
    inputs = input_specs(cfg, ShapeCell("serve", positions, B, "prefill"))
    prefill = make_prefill(model)
    with torch.inference_mode():
        cost = op_cost.analyze(
            lambda p, x: prefill(p, model.init_decode_state(B, ENGINE_MAX_LEN), x),
            params, inputs)
    return {"peak_bytes": cost.peak_bytes, "resident_bytes": cost.resident_bytes}


def held_peak(what: str, pred_peak: int, pred_resident: int, peak: int, base: int) -> dict:
    """Predicted against measured peak, each whole and above what was
    resident before the step; whether the measured step's share lies in
    :data:`PEAK_BAND` of the predicted."""
    ratio = (peak - base) / (pred_peak - pred_resident)
    inside = PEAK_BAND[0] <= ratio <= PEAK_BAND[1]
    log(f"  {what}: predicted peak {_gib(pred_peak)} ({_gib(pred_peak - pred_resident)} above "
        f"the resident {_gib(pred_resident)}), measured {_gib(peak)} ({_gib(peak - base)} above "
        f"{_gib(base)}): measured / predicted above resident {ratio:.3f}, "
        f"{'inside' if inside else 'OUTSIDE'} the band {PEAK_BAND}")
    return {"predicted_peak_bytes": pred_peak, "predicted_resident_bytes": pred_resident,
            "peak_bytes": peak, "base_bytes": base, "ratio": ratio, "inside_band": inside}


def step_roofline(what: str, cfg, cell, ms: float, roof: dict) -> dict:
    """Step time beside the roofline: model FLOP/s and their share of the
    card's peak (MFU), and the dry run's dominant term."""
    from repro_torch.launch.roofline import HW, model_flops

    mf = model_flops(cfg, cell)
    rate = mf / (ms * 1e-3)
    log(f"  {what}: {ms:.1f} ms per step, {mf:.3e} model flops, {rate / 1e12:.1f} model "
        f"TFLOP/s, MFU {rate / HW['peak_flops']:.2%} of {HW['peak_flops'] / 1e12:.0f}; "
        f"roofline terms compute {roof['t_compute_s'] * 1e3:.1f} ms, memory "
        f"{roof['t_memory_s'] * 1e3:.1f} ms, collective {roof['t_collective_s'] * 1e3:.1f} ms; "
        f"dominant {roof['dominant']}")
    return {"ms": ms, "model_flops": mf, "model_flops_per_s": rate,
            "mfu": rate / HW["peak_flops"], "dominant": roof["dominant"]}


def _to_bf16_(tree: dict) -> None:
    """Every float32 leaf of a nested dict replaced by its bf16 copy, one
    leaf at a time."""
    import torch

    for k, v in tree.items():
        if isinstance(v, dict):
            _to_bf16_(v)
        elif v.dtype == torch.float32:
            tree[k] = v.to(torch.bfloat16)


def _card_inputs(cfg, cell, gen) -> dict:
    """The cell's inputs (``input_specs``) on the card: random tokens below
    the vocabulary, every position in the loss, normal floats."""
    import torch

    from repro_torch.launch.shapes import input_specs

    batch = input_specs(cfg, cell, device="cuda")
    for k, t in batch.items():
        if k == "loss_mask":
            t.fill_(1.0)
        elif t.dtype == torch.int32:
            t.random_(0, cfg.vocab_size, generator=gen)
        else:
            t.normal_(generator=gen)
    return batch


def run_grid_cell(rec: dict, gen) -> dict:
    """One warm step of a launch-grid cell on the card at its full shape, as
    the dry run built it on the meta device: random bf16 weights (a train
    cell's float32 state), the step once to warm, then once timed with the
    launch counts at 0 just before it and required to launch what its
    kind does; its peak memory held to the dry run's."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill, make_serve_step
    from repro_torch.train.train_step import TrainHParams, init_train_state, make_train_step

    _, _, cfg, mb, _ = dryrun.build_cell(rec["arch"], rec["shape"])
    cell = SHAPES[rec["shape"]]
    what = f"{cfg.name} x {cell.name} ({cell.global_batch}x{cell.seq_len}) on the card"
    model = build_model(cfg, device="cuda")
    batch = _card_inputs(cfg, cell, gen)
    if cell.kind == "train":
        state = init_train_state(model, gen)
        step = make_train_step(model, TrainHParams(microbatches=mb))
        want = train_launches(cfg, mb)
        run = lambda: step(state, batch)  # noqa: E731
    else:
        params = model.init_params(gen)
        _to_bf16_(params)
        state = model.init_decode_state(cell.global_batch, cell.seq_len + dryrun.CACHE_PAD)
        if cell.kind == "prefill":
            step, want = make_prefill(model), expected_launches(cfg)
        else:
            state["length"] = cell.seq_len
            step, want = make_serve_step(model), {"flash_attention": 0, "ssd_scan": 0}
        run = lambda: step(params, state, batch)  # noqa: E731
    with torch.inference_mode(cell.kind != "train"):
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        registry.reset_launch_counts()
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        del out
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(launches, want, what)
    res = {"arch": cfg.name, "shape": cell.name, "launches": {k: launches[k] for k in want},
           **step_roofline(f"{what}, launches {want}", cfg, cell, ms, rec["roofline"])}
    res["peak"] = held_peak(what, rec["memory"]["peak_bytes"], rec["memory"]["resident_bytes"],
                            peak, base)
    return res


def launch_ddf(fabric: tuple[float, float]) -> dict:
    """``dryrun_ddf`` on the card at P = 8 over the paper's tables at
    :data:`DDF_ROWS_PER_WORKER` rows per worker, the Hockney prediction from
    this run's fabric fit: hash_partition 2 launches, its histogram and
    segment_reduce none, every overflow counter 0, the joined rows equal to
    the numpy oracle's, the peak held to the join's meta dry run."""
    from repro_torch.configs.paper_cylon import CylonWorkload
    from repro_torch.core.comm.communicator import FabricProfile
    from repro_torch.core.cost_model import CostParams
    from repro_torch.launch import dryrun_ddf

    workload = CylonWorkload(rows_per_worker=DDF_ROWS_PER_WORKER)
    t = time.perf_counter()
    left, right = dryrun_ddf.paper_tables(WORKERS, workload)
    tables_s = time.perf_counter() - t
    params = CostParams(fabric=FabricProfile("device", *fabric))
    rec = dryrun_ddf.run(left, right, P=WORKERS, params=params, save=False, verbose=False)
    expect_launches(rec["launches"], {"hash_partition": 2, "hash_partition_hist": 0,
                                      "segment_reduce": 0}, "dryrun_ddf join")
    _require(not any(rec["overflow"].values()), f"dryrun_ddf overflow {rec['overflow']}")
    n = WORKERS * workload.rows_per_worker
    exp = oracle_join_rows(left, right, max(int(n * workload.cardinality), 1))
    _require(rec["join_rows"] == exp, f"dryrun_ddf join rows {rec['join_rows']} vs oracle {exp}")
    ro, mem = rec["roofline"], rec["memory"]
    rec["held_peak"] = held_peak(
        "dryrun_ddf join", mem["predicted_peak_bytes"], mem["predicted_resident_bytes"],
        mem["bytes_per_device"], mem["base_bytes"])
    log(f"  dryrun_ddf: the paper's join at P={WORKERS} x {rec['rows_per_worker']} rows per "
        f"worker (tables {tables_s:.1f} s): {rec['join_rows']} rows = numpy oracle; launches "
        f"{rec['launches']}; overflow {rec['overflow']}; join {rec['join_ms']:.1f} ms; the "
        f"shuffles' transposes {rec['transpose_ms']:.3f} ms vs Hockney "
        f"{ro['hockney_predicted_shuffle_s'] * 1e3:.3f} ms (alpha {params.alpha:.3e} s, beta "
        f"{params.beta:.3e} s/B): roofline_fraction {ro['roofline_fraction']:.3f}; memory term "
        f"{ro['t_memory_s'] * 1e3:.1f} ms ({rec['bytes_accessed']:.3e} B at 3.35 TB/s); "
        f"peak {_gib(mem['bytes_per_device'])} (tracked on the card "
        f"{_gib(mem['tracked_peak_bytes'])}, on the meta device "
        f"{_gib(mem['predicted_peak_bytes'])})")
    rec["tables_s"] = tables_s
    return rec


def launch_summary(res: dict) -> dict:
    """The launch phase's record without the grid cells' per-kernel and
    memory detail (the printed lines hold them)."""
    keep = ("arch", "shape", "status", "fits_one_card", "flops", "bytes_accessed",
            "state_bytes_per_device")
    grid = [{**{k: r[k] for k in keep if k in r},
             **({"peak_bytes": r["memory"]["peak_bytes"], "dominant": r["roofline"]["dominant"],
                 "useful_flops_ratio": r["roofline"]["useful_flops_ratio"]}
                if r["status"] == "ok" else {})} for r in res["grid"]]
    ddf = {k: v for k, v in res["ddf"].items() if k not in ("collectives",)}
    return {**{k: v for k, v in res.items() if k not in ("grid", "train_cells", "ddf")},
            "grid": grid, "ddf": ddf}


def run_launch_phase(serve_res: dict, train_res: dict, fabric: tuple[float, float],
                     workers: int = LAUNCH_WORKERS) -> dict:
    """The launch phase: the meta dry run of every architecture x shape (in
    ``workers`` processes) and of the train paths' own cells, meanwhile
    ``dryrun_ddf`` on the card and the serve paths' predicted prefill
    peaks; then every grid cell's line, the predicted peaks against this
    run's measured ones, the train paths' steps and one warm step of every
    grid cell that fits with :data:`LAUNCH_SPARE` to spare beside the
    roofline."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, ShapeCell, cell_applicable

    t0 = time.perf_counter()
    card = dryrun.card_memory()
    grid = [(a, s) for a in ARCHS for s in SHAPES]
    train_cells = {TRAIN_ARCH: ShapeCell("train_4k", TRAIN_S, TRAIN_B, "train"),
                   TRAIN_HYBRID: ShapeCell("train_4k", HYBRID_S, HYBRID_B, "train")}
    train_mb = {TRAIN_ARCH: TRAIN_MB, TRAIN_HYBRID: 1}
    cells = grid + [(a, "train_4k", {"cell": c, "microbatches": train_mb[a]})
                    for a, c in train_cells.items()]
    # rank 0 of every architecture's train_4k cell on the 16x16 mesh
    cells += [(a, "train_4k", {"mesh": "16x16", "rank": 0}) for a in ARCHS]
    with ThreadPoolExecutor(1) as background:
        pending = background.submit(dryrun.run_grid, cells, workers=workers, save=False,
                                    verbose=False, card=card)
        ddf = launch_ddf(fabric)
        gc.collect()
        torch.cuda.empty_cache()
        serve_pred = {arch: predict_serve_peak(arch, B, S) for arch, B, S, *_ in SERVE_PATHS}
        recs = pending.result()
    grid_s = time.perf_counter() - t0
    log(f"  dry run of {len(grid)} cells on the meta device in {workers} processes "
        f"(and the train paths' cells): {grid_s:.1f} s; one card = {card[0]:.4e} bytes "
        f"({card[1]})")
    for (arch, shape), rec in zip(grid, recs):
        applicable, reason = cell_applicable(get_config(arch), shape)
        if rec["status"] == "error":
            raise AssertionError(f"dry run {arch} x {shape}: {rec['error']}\n{rec['traceback']}")
        _require((rec["status"] == "skipped") == (not applicable),
                 f"dry run {arch} x {shape}: {rec['status']}, applicable {applicable}")
        if rec["status"] == "skipped":
            log(f"  {rec['arch']} x {shape}: skipped ({reason})")
            continue
        m, ro = rec["memory"], rec["roofline"]
        log(f"  {rec['arch']} x {shape} ({rec['batch']}x{rec['seq']}, {rec['microbatches']} "
            f"microbatch(es)): params {_gib(m['param_bytes'])}, state {_gib(m['state_bytes'])}, "
            f"peak {_gib(m['peak_bytes'])}: "
            + ("fits one card" if rec["fits_one_card"] else "needs more than one card")
            + f"; flops {rec['flops']:.3e}, model {ro['model_flops_total']:.3e}, useful "
            f"{ro['useful_flops_ratio']:.3f}; compute {ro['t_compute_s'] * 1e3:.2f} ms, memory "
            f"{ro['t_memory_s'] * 1e3:.2f} ms, collective {ro['t_collective_s'] * 1e3:.2f} ms "
            f"({ro['dominant']}); state per device "
            + ", ".join(f"{mesh} {n / 2**30:.3f} GiB"
                        for mesh, n in rec["state_bytes_per_device"].items()))
        _require(all(n > 0 for n in rec["state_bytes_per_device"].values()),
                 f"dry run {arch} x {shape}: state bytes per device {rec['state_bytes_per_device']}")

    ranks = recs[len(grid) + len(train_cells):]
    recs = recs[:len(grid) + len(train_cells)]
    log("  train_4k at 16x16, rank 0 (its shards on the meta device, the stand-in "
        "collectives counted):")
    for rec in ranks:
        _require(rec["status"] == "ok", f"dry run {rec['arch']} train_4k 16x16 rank 0: "
                 f"{rec.get('error')}")
        m, ro, c = rec["memory"], rec["roofline"], rec["collectives"]
        _require(m["resident_bytes"] == rec["state_bytes_per_device"]["16x16"],
                 f"{rec['arch']}: rank 0's arguments {m['resident_bytes']} bytes vs its "
                 f"state per device {rec['state_bytes_per_device']['16x16']}")
        log(f"  {rec['arch']} x train_4k x 16x16 rank 0 ({rec['microbatches']} microbatch(es)): "
            f"peak {_gib(m['peak_bytes'])}, state {_gib(m['resident_bytes'])} (= state per "
            f"device at 16x16); collectives "
            + ", ".join(f"{k} {v['count']} x {v['bytes'] / 2**30:.3f} GiB"
                        for k, v in sorted(c["per_op"].items()))
            + f"; compute {ro['t_compute_s'] * 1e3:.2f} ms, memory {ro['t_memory_s'] * 1e3:.2f} "
            f"ms, collective {ro['t_collective_s'] * 1e3:.2f} ms ({ro['dominant']})")

    log("  predicted (meta) against measured peak memory of the paths measured above:")
    held, steps = {}, {}
    for (arch, cell), rec in zip(train_cells.items(), recs[len(grid):]):
        _require(rec["status"] == "ok", f"dry run of the {arch} train path: {rec}")
        res = train_res["dense" if arch == TRAIN_ARCH else "hybrid"]
        what = f"{rec['arch']} train {cell.global_batch}x{cell.seq_len} in {rec['microbatches']}"
        held[f"{arch} train"] = held_peak(what, rec["memory"]["peak_bytes"],
                                          rec["memory"]["resident_bytes"], res["peak_bytes"],
                                          res["base_bytes"])
        steps[f"{arch} train"] = step_roofline(what, get_config(arch), cell,
                                               float(np.median(res["ms"])), rec["roofline"])
    for arch, B, S, *_ in SERVE_PATHS:
        res = serve_res[get_config(arch).name]
        held[f"{arch} prefill"] = held_peak(
            f"{arch} prefill {B}x{S} (float32 weights)", serve_pred[arch]["peak_bytes"],
            serve_pred[arch]["resident_bytes"], res["prefill_peak_bytes"],
            res["prefill_base_bytes"])

    log(f"  grid cells that fit one card with {LAUNCH_SPARE:.0%} to spare, one warm step each "
        f"at full shape (random bf16 weights):")
    measured, not_runnable = {}, {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(MODEL_SEED)
    for rec in recs[:len(grid)]:
        if rec["status"] != "ok" or rec["memory"]["peak_bytes"] > (1 - LAUNCH_SPARE) * card[0]:
            continue
        cfg, cell = get_config(rec["arch"]), SHAPES[rec["shape"]]
        last = cell.seq_len - (cell.kind != "decode")  # the last position the step reads
        key = f"{cfg.name} x {cell.name}"
        if cfg.learned_positions and last >= cfg.max_seq:
            not_runnable[key] = (f"position {last} is past the {cfg.max_seq}-row learned "
                                 f"position table (IndexError on the card)")
            log(f"  {key}: not runnable: {not_runnable[key]}")
            continue
        measured[key] = run_grid_cell(rec, gen)
        gc.collect()
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"  launch phase: {wall:.1f} s")
    return {"grid": recs[:len(grid)], "train_cells": recs[len(grid):], "held_peaks": held,
            "rank_cells": [{"arch": r["arch"], "peak_bytes": r["memory"]["peak_bytes"],
                            "state_bytes": r["memory"]["resident_bytes"],
                            "collectives": r["collectives"]["per_op"],
                            "roofline": {k: r["roofline"][k] for k in
                                         ("t_compute_s", "t_memory_s", "t_collective_s")}}
                           for r in ranks],
            "train_steps": steps, "measured_cells": measured, "not_runnable": not_runnable,
            "ddf": ddf, "card_bytes": card[0], "card_bytes_from": card[1], "wall_s": wall,
            "dry_run_s": grid_s}


# -- profile ---------------------------------------------------------------------------

def _union_us(spans) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _profile(run, path: str, what: str) -> list:
    """Run ``run()`` under ``torch.profiler``; write the table by device time
    to ``path`` and log the device's busy time and idle share. Busy time is
    given twice: the sum of every kernel's and copy's device time, and the
    union of their intervals, which counts once a copy that waits on (or
    runs beside) a kernel; the idle share is the union's complement.
    Returns the device events (``key_averages``)."""
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
    union_us = _union_us([(e.time_range.start, e.time_range.end) for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA])
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    log(f"profile of {what}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms summed, {union_us / 1e3:.1f} ms as the union of the "
        f"kernels' and copies' intervals, idle share {1 - union_us / wall_us:.3f} "
        f"(summed: {1 - busy_us / wall_us:.3f}) ({path})")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  {e.key[:90]}")
    for name in PORT_KERNELS:  # the port's own kernels, wherever they rank
        own = [e for e in device if name in e.key]
        if own:
            log(f"  port kernel {name}: {sum(e.self_device_time_total for e in own) / 1e3:.3f} ms"
                f" in {sum(e.count for e in own)} launches")
    return device


def profile_main_path(P: int, left, right, path: str) -> None:
    """The main path once more under ``torch.profiler``: device time by
    kernel and the device's idle share of the wall time."""
    from repro_torch.core import DDF, DDFContext

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


def profile_lazy_path(P: int, left, right, path: str) -> None:
    """One collect of the lazy path under ``torch.profiler``, its source
    tables copied to the card outside the window."""
    from repro_torch.core import DDF, DDFContext

    ctx = DDFContext(nworkers=P)
    L, R = DDF.from_numpy(left, ctx), DDF.from_numpy(right, ctx)
    _profile(lambda: _lazy_steps(L, R).collect(), path, "one collect of the lazy path")


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


def gamma_fit(P: int, rows_per_worker: int, left) -> float:
    """The cost model's local constant: device seconds per row per worker of
    the main path's local groupby (sum, min, max, count, mean of c1 by c0)
    over the left table, timed with CUDA events."""
    from repro_torch.core import DDF, DDFContext
    from repro_torch.core.local_ops import local_groupby

    L = DDF.from_numpy(left, DDFContext(nworkers=P))
    aggs = {"c1": ("sum", "min", "max", "count", "mean")}
    ms = cuda_time_ms(lambda: local_groupby(L.table(), ("c0",), aggs), iters=3, warmup=1)
    log(f"  local groupby of {P} x {rows_per_worker} rows: {ms:.3f} ms")
    return ms * 1e-3 / rows_per_worker


# -------------------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-per-worker", type=int, default=DEFAULT_ROWS_PER_WORKER)
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile the main path, the patterns path (its steps on the "
                         "main path's tables and its string steps apart), one lazy collect, "
                         "one streamed groupby collect, one concurrent run of the service "
                         "path, one prefill and 15 decode steps of zamba2-1.2b and of "
                         "gemma2-9b, and one train step of olmo-1b; write the tables to PATH "
                         "and to PATH with _patterns, _strings, _lazy, _stream, _service, "
                         "_prefill, _decode, _prefill_gemma2, _decode_gemma2, _train and "
                         "_planned (one planned train step of olmo-1b) "
                         "before its extension")
    ap.add_argument("--grad-readings", action="store_true",
                    help=f"only build the kernels and print the readings behind the SSD "
                         f"families' gradient limit ({GRAD_READING_SEEDS} seeds of "
                         f"{TRAIN_ARCH} and {TRAIN_HYBRID} at the gradient check's size: "
                         f"kernel path, reordered plain scan and a TF32-operand control, "
                         f"each against the plain path); no contract line")
    ap.add_argument("--service-turns", action="store_true",
                    help="only build the kernels and run the service mix at full size on one "
                         "card and over a one-rank NCCL group in this process, in turns (one, "
                         "grouped, grouped, one): each run's wall, summed morsel seconds, "
                         "turns, and the group's broadcast records and gathers with their "
                         "seconds; no contract line")
    ap.add_argument("--grouped-rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--planned-rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--stream-dataset", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is not in {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    if args.grouped_rank:  # the grouped phase's child: no contract line
        return run_grouped_rank(args.rows_per_worker, args.stream_dataset)
    if args.planned_rank:  # the planned phase's child: no contract line
        return run_planned_rank(args.profile)
    from repro_torch.core import cost_model
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
    if args.grad_readings:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.configs import get_config

        log(f"gradient readings (float32, {GRAD_B}x{GRAD_S}; the kernel path's limit now "
            f"{GRAD_TOL} dense, {SSD_GRAD_TOL} with Mamba layers):")
        readings = grad_readings({get_config(a): n for a, n in GRAD_LAYERS.items()},
                                 GRAD_READING_SEEDS, GRAD_B, GRAD_S)
        log(json.dumps({"grad_readings": readings}))
        return 0
    if args.service_turns:
        log("service turns (the service mix, one card and one NCCL rank in turns):")
        log(json.dumps({"service_turns": service_turns()}))
        return 0
    log("tensor-core kernels (nvcc -Xptxas -v; cuobjdump -sass):")
    build = build_report(cuda_lib.load(), info)

    shapes: dict = {}
    restore = record_shapes(shapes)
    cut = (f"rows per worker {args.rows_per_worker} of the paper's "
           f"{PAPER_ROWS_PER_WORKER} (the static-quota layout's peak memory at 25M "
           f"does not fit the card)") if args.rows_per_worker < PAPER_ROWS_PER_WORKER else "none"
    log(f"cut: {cut}")
    t = time.perf_counter()
    left, right = paper_tables(WORKERS, args.rows_per_worker)
    log(f"tables: {time.perf_counter() - t:.1f} s")
    main_res = run_main_path(WORKERS, args.rows_per_worker, shapes, left, right)
    restore()
    for name in DATAFRAME_KERNELS:
        if main_res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    log("  main-path kernel shapes: " + json.dumps(
        {k: sorted(map(str, v)) for k, v in shapes.items()}))
    torch.cuda.empty_cache()

    log(f"patterns path (P={WORKERS}, {args.rows_per_worker} rows per worker; cut: the string "
        f"join and union at {STRING_ROWS_PER_WORKER} rows per worker, where host-side "
        f"vocabulary building sets the pace, not the card):")
    patterns_shapes: dict = {}
    restore = record_shapes(patterns_shapes)
    patterns_res = run_patterns_path(WORKERS, args.rows_per_worker, left, right)
    restore()
    log("  patterns-path kernel shapes: " + json.dumps(
        {k: sorted(map(str, v)) for k, v in patterns_shapes.items()}))
    torch.cuda.empty_cache()

    log(f"lazy path (P={WORKERS}, {args.rows_per_worker} rows per worker; the README's lazy "
        f"example: select, with_column, project, shuffle join, groupby on the join key):")
    lazy_shapes: dict = {}
    restore = record_shapes(lazy_shapes)
    lazy_res = run_lazy_path(WORKERS, left, right)
    restore()
    log("  lazy-path kernel shapes: " + json.dumps(
        {k: sorted(map(str, v)) for k, v in lazy_shapes.items()}))
    for k, v in lazy_shapes.items():
        patterns_shapes.setdefault(k, set()).update(v)
    torch.cuda.empty_cache()

    log(f"streaming path (P={WORKERS}, the paper's left table at {PAPER_ROWS_PER_WORKER} rows "
        f"per worker, nothing cut; the sort and the spill join at "
        f"{STREAM_SMALL_ROWS_PER_WORKER} rows per worker a side and scan_csv at "
        f"{STREAM_CSV_ROWS} rows, where host numpy and Python's CSV parser set the pace):")
    stream_shapes: dict = {}
    restore = record_shapes(stream_shapes)
    stream_profile = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        stream_profile = f"{root}_stream{ext}"
    import atexit
    import tempfile

    stream_dir = tempfile.mkdtemp(prefix="chip-smoke-grouped-dataset-")
    atexit.register(shutil.rmtree, stream_dir, True)  # kept for the grouped phase
    stream_res = run_stream_path(WORKERS, PAPER_ROWS_PER_WORKER, profile_path=stream_profile,
                                 dataset_dir=os.path.join(stream_dir, "left"))
    restore()
    log("  streaming-path kernel shapes: " + json.dumps(
        {k: sorted(map(str, v)) for k, v in stream_shapes.items()}))
    for k, v in stream_shapes.items():
        patterns_shapes.setdefault(k, set()).update(v)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"service path (P={WORKERS}, one QueryService(policy='fair', max_running="
        f"{SERVICE_MAX_RUNNING}) driving {SERVICE_SCANS} streamed groupbys of the paper's left "
        f"table at {PAPER_ROWS_PER_WORKER} rows per worker, nothing cut, beside "
        f"{SERVICE_LAZY} lazy joins, an eager sort and a select; cut: the lazy tables at "
        f"{SERVICE_LAZY_ROWS_PER_WORKER} rows per worker a side, so that four fit beside the "
        f"scans):")
    service_shapes: dict = {}
    restore = record_shapes(service_shapes)
    service_profile = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        service_profile = f"{root}_service{ext}"
    service_res = run_service_path(WORKERS, PAPER_ROWS_PER_WORKER, profile_path=service_profile)
    restore()
    log("  service-path kernel shapes: " + json.dumps(
        {k: sorted(map(str, v)) for k, v in service_shapes.items()}))
    for k, v in service_shapes.items():
        patterns_shapes.setdefault(k, set()).update(v)
    gc.collect()
    torch.cuda.empty_cache()

    log(f"grouped paths (P={WORKERS}, over DDFContext(nworkers={WORKERS}, group=WORLD) in a "
        f"child process, one NCCL rank at world 1 on cuda:0: the main path at "
        f"{args.rows_per_worker} rows per worker, the lazy path on its tables, the streaming "
        f"path's groupby on its {PAPER_ROWS_PER_WORKER}-rows-per-worker dataset killed at half "
        f"its batches and resumed, and the service mix through QueryService(ctx=...), every "
        f"shuffle an NCCL all-to-all of byte views and every host decision from global "
        f"values or rank 0's log; not a test of cross-card traffic, since NCCL refuses two "
        f"ranks on one device: the cross-rank logic is held to the reference by "
        f"tests/test_torch_distributed.py and tests/test_torch_distributed_plans.py (gloo, "
        f"worlds 2 and 8, on the CPU) and, on cards, waits for the first 4-chip cell):")
    grouped_res = run_grouped_phase(
        args.rows_per_worker, {"main": main_res, "lazy": lazy_res, "stream": stream_res,
                               "service": service_res, "coltypes": patterns_res["coltypes"]},
        os.path.join(stream_dir, "left"))
    shutil.rmtree(stream_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    log("kernel phase (each kernel against its plain version on the card, at the shapes "
        "of the main path, the patterns path, the lazy path, the streaming path and the "
        "service path):")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    recs = [hash_phase(shapes["hash_partition"], patterns_shapes.get("hash_partition", set()),
                       gen),
            segment_phase(shapes["segment_reduce"], patterns_shapes.get("segment_reduce", set()),
                          WORKERS, gen)]
    recs.insert(1, hist_record(recs[0]))
    for r in recs:
        r["launches"] = main_res["launches"][r["name"]]
        r["patterns_launches"] = sum(v.get(r["name"], 0)
                                     for v in patterns_res["launches"].values())
        r["lazy_launches"] = lazy_res["launches"][r["name"]]
        r["stream_launches"] = sum(v["launches"][r["name"]]
                                   for v in stream_res["steps"].values())
        r["service_launches"] = service_res["concurrent"]["launches"][r["name"]]
        r["grouped_launches"] = grouped_res["launches"][r["name"]]
    # no engine path of the reference reaches the histogram variant (its
    # shuffle builds destinations only, the streaming runner its histogram
    # on the host), so none here may launch it
    hist = recs[1]
    _require(hist["launches"] == hist["patterns_launches"] == hist["lazy_launches"]
             == hist["stream_launches"] == hist["service_launches"]
             == hist["grouped_launches"] == 0,
             f"hash_partition_hist launched on a path: main {hist['launches']}, patterns "
             f"{hist['patterns_launches']}, lazy {hist['lazy_launches']}, stream "
             f"{hist['stream_launches']}, service {hist['service_launches']}, grouped "
             f"{hist['grouped_launches']}")

    log("fabric fit (on-card all-to-all):")
    alpha, beta = fabric_fit(WORKERS)
    log(f"  DEVICE fabric on {smi}: alpha={alpha:.3e} s, beta={beta:.3e} s/byte "
        f"({1 / beta / 1e9 if beta > 0 else float('inf'):.1f} GB/s of payload)")
    torch.cuda.empty_cache()
    gamma = gamma_fit(WORKERS, args.rows_per_worker, left)
    log(f"  gamma_s_per_row on {smi}: {gamma:.4e} s per row per worker (cost_model holds "
        f"{cost_model.GAMMA_S_PER_ROW:.4e})")
    torch.cuda.empty_cache()

    if args.profile:
        root, ext = os.path.splitext(args.profile)
        profile_main_path(WORKERS, left, right, args.profile)
        torch.cuda.empty_cache()
        _profile(lambda: run_table_steps(WORKERS, args.rows_per_worker, left, right,
                                         check=False),
                 f"{root}_patterns{ext}", "the patterns path's steps on the main path's tables")
        torch.cuda.empty_cache()
        tables = string_tables(WORKERS, left, right)  # host-side work, outside the window
        _profile(lambda: run_string_steps(tables, check=False), f"{root}_strings{ext}",
                 f"the string join and union at {STRING_ROWS_PER_WORKER} rows per worker")
        del tables
        torch.cuda.empty_cache()
        profile_lazy_path(WORKERS, left, right, f"{root}_lazy{ext}")
    del left, right
    torch.cuda.empty_cache()  # the dataframe path's memory goes back to the card

    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    serve_res, flash_shapes, ssd_shapes = {}, {}, {}
    for arch, B, S, cb, cs, decode_check in SERVE_PATHS:
        cfg = get_config(arch)
        model_gen = torch.Generator(device="cuda")
        model_gen.manual_seed(MODEL_SEED)
        prof = None
        if args.profile and arch in PROFILED_PATHS:
            root, ext = os.path.splitext(args.profile)
            tag = PROFILED_PATHS[arch]
            prof = (f"{root}_prefill{tag}{ext}", f"{root}_decode{tag}{ext}")
        path_shapes: dict = {}
        serve_res[cfg.name] = run_family_path(cfg, B, S, cb, cs, gen=model_gen,
                                              decode_check=decode_check, shapes=path_shapes,
                                              profile=prof)
        log("  prefill kernel shapes: " + json.dumps(
            {k: sorted(map(str, v)) for k, v in path_shapes.items()}))
        flash_shapes[f"{arch} prefill"] = path_shapes.get("flash_attention", set())
        if arch == SERVE_ARCH:
            ssd_shapes[f"{arch} prefill"] = path_shapes["ssd_scan"]
        gc.collect()
        torch.cuda.empty_cache()  # this model's parameters go back to the card

    log(f"train path ({TRAIN_ARCH} at full width fed by TokenPipeline at {TRAIN_DOCS} documents "
        f"on {TRAIN_WORKERS} workers, then {TRAIN_HYBRID}; cut: train_4k's global batch of 256 "
        f"to {TRAIN_B} sequences of {TRAIN_S} on one card):")
    train_profile = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        train_profile = f"{root}_train{ext}"
    train_shapes: dict = {}
    train_res = run_train_path(get_config(TRAIN_ARCH), get_config(TRAIN_HYBRID),
                               shapes=train_shapes, profile=train_profile)
    for arch, path_shapes in train_shapes.items():
        log(f"  {arch} train step kernel shapes: " + json.dumps(
            {k: sorted(map(str, v)) for k, v in path_shapes.items()}))
        if "flash_attention" in path_shapes:
            flash_shapes[f"{arch} train step"] = path_shapes["flash_attention"]
        if "ssd_scan" in path_shapes:
            ssd_shapes[f"{arch} train step"] = path_shapes["ssd_scan"]
    _require(set(train_shapes) == {TRAIN_ARCH, TRAIN_HYBRID}
             and f"{TRAIN_HYBRID} train step" in ssd_shapes
             and f"{TRAIN_ARCH} train step" in flash_shapes
             and f"{TRAIN_HYBRID} train step" in flash_shapes,
             f"train steps recorded no kernel shapes: {train_shapes}")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"planned train phase (the train step under make_plan(make_group_mesh()) in a child "
        f"process, one NCCL rank at world 1 on cuda:0: FSDP over the data ranks, every "
        f"weight gathered at use and its gradient reduce-scattered, each a copy at world 1; "
        f"{TRAIN_ARCH} {TRAIN_B}x{TRAIN_S} in {TRAIN_MB} microbatches fed by the TokenPipeline "
        f"over the group's DDFContext at {PLANNED_DOCS} documents, {TRAIN_HYBRID} "
        f"{HYBRID_B}x{HYBRID_S}, {PLANNED_STEPS} steps each from the train path's starting "
        f"state, held to the one-device steps; then the serve legs under "
        f"make_plan(make_group_mesh(), mode='serve'), "
        f"{', '.join(f'{a} {b}x{n}' for a, b, n in PLANNED_SERVE)}, a prefill and "
        f"{PLANNED_DECODE} decode steps each, held to one device's tokens by bits; not a test "
        f"of cross-card traffic: the cross-rank logic, tensor parallelism over 'model' "
        f"included, is held to the reference by tests/test_torch_fsdp.py on gloo worlds 2 "
        f"and 4):")
    planned_profile = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        planned_profile = f"{root}_planned{ext}"
    planned_res = run_planned_phase(smi, planned_profile)
    gc.collect()
    torch.cuda.empty_cache()

    log("model kernel phase (each kernel against its plain version on the card):")
    zamba = serve_res[get_config(SERVE_ARCH).name]
    model_recs = [flash_phase(flash_shapes, gen), ssd_phase(ssd_shapes, gen)]
    for r in model_recs:
        r["launches"] = zamba["prefill_launches"][r["name"]]
        r["launches_by_path"] = {name: res["prefill_launches"][r["name"]]
                                 for name, res in serve_res.items()}
    recs += model_recs
    train_launches_by_kernel = {
        name: {"pipeline": train_res["pipeline"]["launches"][name],
               TRAIN_ARCH: train_res["dense"]["launches"][name],
               TRAIN_HYBRID: train_res["hybrid"]["launches"][name]}
        for name in ("hash_partition", "hash_partition_hist", "segment_reduce",
                     "flash_attention", "ssd_scan")}
    for r in recs:
        r.setdefault("kernel_ms", r["ms"])
        r["train_launches"] = train_launches_by_kernel[r["name"]]
        r["planned_train_launches"] = {
            "pipeline": planned_res["pipeline"]["launches"][r["name"]],
            TRAIN_ARCH: planned_res["dense"]["launches"][r["name"]],
            TRAIN_HYBRID: planned_res["hybrid"]["launches"][r["name"]]}
        r["planned_serve_launches"] = {leg["arch"]: leg["launches"].get(r["name"], 0)
                                       for leg in planned_res["serve"]}
    gc.collect()
    torch.cuda.empty_cache()

    log(f"launch phase (launch/: the dry run of every architecture x shape on the meta device "
        f"at published widths, held to this run's measured peaks and steps; grid cells that "
        f"fit one card run on it; dryrun_ddf: the paper's join at P={WORKERS} on the card):")
    launch_res = run_launch_phase(serve_res, train_res, (alpha, beta))

    log(json.dumps({"build": build}))
    log(json.dumps({"main_path": main_res, "cut": cut}))
    log(json.dumps({"grouped_paths": grouped_res}))
    log(json.dumps({"patterns_path": patterns_res}))
    log(json.dumps({"lazy_path": lazy_res}))
    log(json.dumps({"stream_path": stream_res, "gamma_s_per_row": gamma}))
    log(json.dumps({"service_path": service_res}))
    log(json.dumps({"serve": serve_res}))
    log(json.dumps({"train": train_res}))
    log(json.dumps({"planned_train": planned_res}))
    log(json.dumps({"launch": launch_summary(launch_res)}))
    log(f"smoke run: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": recs}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
