"""Tensor parallelism across cards: the planned train and serve steps of the
PyTorch port over four ranks, held to one card's unplanned steps.

Run on a host with four cards (one rank a card, NCCL):

    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/torch_tp_cards.py

or rehearse on the CPU (gloo, smoke configs, a small batch):

    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/torch_tp_cards.py --device cpu --smoke

What it runs (the model at published widths, random float32 weights from a
seed, bf16 compute):

1. Rank 0 alone: olmo-1b's unplanned train step on one card, 8 x 4096 in 2
   microbatches, 2 steps from one state (the yardstick).
2. Every rank: the same 2 train steps under ``make_plan(make_group_mesh(
   model=M))`` at meshes (2, 2) and (1, 4), from the same state cut to the
   rank's shards, each rank on its rows, the residual stream split over
   the model ranks between blocks (4096 positions divide M); the loss and
   the gradient norm of each step against one card's, within
   ``TRAIN_RTOL``; ms per step, the collectives per step, the peak above
   the resident state on each rank, and the NCCL kernels' device time in
   one profiled step. Each rank's ``fsdp.census()`` of each step (count
   and bytes of each kind) must equal the dry run of that rank at that
   mesh (``launch.dryrun.run_cell`` on the meta device over a stand-in
   mesh), whose predicted peak above the resident arguments is printed
   beside the measured one.
3. Each serving leg of ``SERVE_LEGS``: rank 0 serves it on one card (a
   prefill and 8 decode steps), then every rank under the serve plan at
   (1, 4): the prefill (a first prefill and two decode steps warm the new
   groups up, the second prefill is timed), then 8 decode steps fed one
   card's tokens (each timed, and a ninth profiled for its NCCL kernels),
   each step's greedy token and logits against one card's. zamba2-1.2b
   in bf16 at 4 x 4096 and in float32 at 4 x 512; llava-next-mistral-7b
   in float32 at 2 x (576 patches + 512 tokens) and whisper-tiny in
   float32 at 4 x 448 over 1500 frames, each with its KV cache in its
   compute dtype. In float32 the split's other summation order is the
   only difference, so the logits must agree within ``F32_SERVE_TOL`` of
   their scale.
4. The collectives' own cost over the four ranks: an all-reduce of 8
   bytes (latency) and of 256 MiB of bf16 (bus bandwidth, 2 (n - 1) / n of
   the bytes over the time), 20 and 5 times after a warm-up.

``--train-only`` runs 1 and 2 alone.

The tolerance ``TRAIN_RTOL`` = 2^-6: one card rounds each product of a
row-split weight (attention's ``wo``, the MLP's ``w_down``) to bf16 once;
over M model ranks each rank rounds its partial product to bf16 and the
all-reduce adds the M partials in bf16, up to M roundings of at most 2^-8
of the sum's magnitude each, 2^-6 at M = 4. The loss and the gradient norm
are means and norms over every position of values carrying such errors, so
to first order they move by no more than that share.

Its last line is one JSON object (also written to ``--out``). It imports no
jax and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.comm import fsdp, group  # noqa: E402
from repro_torch.launch.mesh import make_group_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import make_prefill  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (TrainHParams, init_train_state,  # noqa: E402
                                          make_train_step, shard_train_state)
from repro_torch.tree import leaves  # noqa: E402

TRAIN_ARCH = "olmo-1b"
MESHES = (2, 4)  # model axes over 4 ranks: (2, 2) and (1, 4)
SERVE_MODEL = 4
# (arch, dtype, (batch, prompt), the same with --smoke); llava's prompt follows
# its 576 patches
SERVE_LEGS = (("zamba2-1.2b", "bfloat16", (4, 4096), (4, 32)),
              ("zamba2-1.2b", "float32", (4, 512), (4, 32)),
              ("llava-next-mistral-7b", "float32", (2, 512), (2, 8)),
              ("whisper-tiny", "float32", (4, 448), (4, 8)))
TRAIN_RTOL = 2.0**-6
F32_SERVE_TOL = 1e-4  # float32 sums in another order over 38 layers
SEED = 1


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(dev) -> int:
    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(dev, base: int) -> int | None:
    return torch.cuda.max_memory_allocated() - base if dev.type == "cuda" else None


def _batches(cfg, B: int, S: int, steps: int) -> list[dict]:
    gen = torch.Generator().manual_seed(SEED + 1)
    out = []
    for _ in range(steps):
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "loss_mask": torch.ones((B, S), dtype=torch.float32)})
    return out


def _whole_state(model, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return init_train_state(model, gen)


def _steps(step, state, batches, dev) -> tuple[list, list, list, list]:
    """(metrics as floats, ms, collectives, their census) of one step a
    batch."""
    metrics, ms, colls, census = [], [], [], []
    for b in batches:
        fsdp.reset_counts()
        _sync(dev)
        t = time.perf_counter()
        state, m = step(state, b)
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        colls.append(fsdp.counts())
        census.append(fsdp.census())
    return metrics, ms, colls, census


def one_card_train(cfg, batches, mb, dev) -> dict:
    model = build_model(cfg, device=dev)
    state = _whole_state(model, dev)
    step = make_train_step(model, TrainHParams(opt=AdamWConfig(warmup_steps=10),
                                               microbatches=mb))
    base = _peak_reset(dev)
    metrics, ms, _, _ = _steps(step, state, [{k: v.to(dev) for k, v in b.items()}
                                             for b in batches], dev)
    return {"metrics": metrics, "ms": ms, "peak_extra_bytes": _peak(dev, base)}


def _nccl_ms(fn, dev) -> tuple[float | None, int]:
    """The NCCL kernels' device time (ms) and launches in one call of ``fn``."""
    if dev.type != "cuda":
        return None, 0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "nccl" in e.key.lower()]
    return (sum(e.self_device_time_total for e in ev) / 1e3, sum(e.count for e in ev))


def planned_train(cfg, batches, mb, model_axis, dev, one: dict) -> dict:
    model = build_model(cfg, device=dev)
    plan = sharding.make_plan(make_group_mesh(model=model_axis))
    state = shard_train_state(_whole_state(model, dev), plan)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the whole state's memory back
    step = make_train_step(model, TrainHParams(opt=AdamWConfig(warmup_steps=10),
                                               microbatches=mb), plan=plan)
    local = [{k: v.to(dev) for k, v in sharding.shard_batch(b, plan, mb).items()} for b in batches]
    base = _peak_reset(dev)
    metrics, ms, colls, census = _steps(step, state, local, dev)
    peak = _peak(dev, base)
    nccl_ms, nccl_n = _nccl_ms(lambda: step(state, local[-1]), dev)
    dry = dry_run(cfg, batches[0], mb, plan, dev)
    rec = {"mesh": [plan.mesh.shape["data"], model_axis], "metrics": metrics, "ms": ms,
           "collectives": colls[-1], "peak_extra_bytes": peak,
           "state_bytes": sum(t.numel() * t.element_size() for t in leaves(state)),
           "nccl_ms": nccl_ms, "nccl_kernels": nccl_n, "census": census,
           "dry_census": dry["collectives"]["per_op"],
           "census_equal": all(c == dry["collectives"]["per_op"] for c in census),
           "dry_peak_extra_bytes": dry["memory"]["peak_bytes"] - dry["memory"]["resident_bytes"],
           "dry_resident_bytes": dry["memory"]["resident_bytes"]}
    if one is not None:
        rec["rel_err"] = {k: [abs(g[k] - e[k]) / abs(e[k]) for g, e in
                              zip(metrics, one["metrics"])] for k in ("loss", "grad_norm")}
        rec["within_tol"] = all(x <= TRAIN_RTOL for v in rec["rel_err"].values() for x in v)
    return rec


def dry_run(cfg, batch: dict, mb: int, plan, dev) -> dict:
    """``launch.dryrun.run_cell`` of this rank's train step on the meta
    device at the plan's mesh and rank, on a global batch of ``batch``'s
    shapes (the kernels' stand-ins on the card's run, their plain versions
    on the CPU's, which changes no collective)."""
    import contextlib

    from repro_torch.kernels import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell

    inputs = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta")
              for k, v in batch.items()}
    B, S = inputs["tokens"].shape
    rank = plan.mesh.coord["data"] * plan.mesh.shape["model"] + plan.mesh.coord["model"]
    backend = (contextlib.nullcontext() if dev.type == "cuda"
               else registry.use_backend("torch"))
    with backend:
        rec = dryrun.run_cell(cfg.name, "train_4k", cell=ShapeCell("tp", S, B, "train"),
                              microbatches=mb, mesh=(plan.mesh.shape["data"],
                                                     plan.mesh.shape["model"]),
                              rank=rank, config=cfg, inputs=inputs, save=False,
                              verbose=False, card=(80e9, "80e9"))
    if rec["status"] != "ok":
        raise RuntimeError(f"dry run of rank {rank}: {rec['error']}")
    return rec


def collective_cost(dev) -> dict:
    """Latency of an 8-byte all-reduce and bus bandwidth of a 256 MiB bf16
    all-reduce over the default group, timed with CUDA events."""
    if dev.type != "cuda":
        return {}
    world = dist.get_world_size()
    out = {}
    for name, n, iters in (("latency_us", 2, 20), ("busbw_GBps", 128 * 2**20, 5)):
        x = torch.ones(n, dtype=torch.bfloat16 if n > 2 else torch.float32, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            dist.all_reduce(x)
        end.record()
        torch.cuda.synchronize()
        s = start.elapsed_time(end) / 1e3 / iters
        nbytes = x.numel() * x.element_size()
        out[name] = s * 1e6 if n == 2 else 2 * (world - 1) / world * nbytes / s / 1e9
    return out


def serving(cfg, B, S, steps, dev, plan, feed=None) -> dict:
    """The prefill, then ``steps`` decode steps fed ``feed`` (one card's
    tokens; its own greedy tokens when None): tokens and logits of this
    rank's rows, times."""
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    params = model.init_params(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev, generator=gen)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((B, cfg.n_patches, cfg.d_model), device=dev,
                                            generator=gen)
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.randn((B, cfg.enc_positions, cfg.d_model), device=dev,
                                          generator=gen)
    if plan is not None:
        params = sharding.shard_params(params, plan)
    rows = torch.as_tensor(sharding.batch_rows(B, plan), device=dev)
    first = {k: v[rows] for k, v in batch.items()}
    prefill, T = make_prefill(model, plan), S + 2 * steps  # T divides the model axis
    dtype = getattr(torch, cfg.dtype)  # the KV cache in the compute dtype

    def decode(state, tok):
        return model.decode_step(params, state, {"token": tok[:, None]}, plan=plan)

    base = _peak_reset(dev)
    with torch.inference_mode():
        # a first prefill and two decode steps start the groups' communicators
        nxt, state = prefill(params, model.init_decode_state(len(rows), T, dtype, plan=plan), first)
        for _ in range(2):
            lg, state = decode(state, nxt)
        _sync(dev)
        t = time.perf_counter()
        nxt, state = prefill(params, model.init_decode_state(len(rows), T, dtype, plan=plan), first)
        _sync(dev)
        prefill_ms = (time.perf_counter() - t) * 1e3
        toks, logits, step_ms = [nxt], [], []
        for i in range(steps):
            tok = toks[-1] if feed is None else feed[i][rows]
            t = time.perf_counter()
            lg, state = decode(state, tok)
            _sync(dev)
            step_ms.append((time.perf_counter() - t) * 1e3)
            logits.append(lg.float())
            toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
        nccl_ms, nccl_n = _nccl_ms(lambda: decode(state, toks[-1]), dev)
    return {"tokens": torch.stack(toks), "logits": torch.stack(logits), "prefill_ms": prefill_ms,
            "decode_ms": sum(step_ms) / steps, "decode_step_ms": step_ms,
            "decode_nccl_ms": nccl_ms, "decode_nccl_kernels": nccl_n,
            "peak_extra_bytes": _peak(dev, base)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu to rehearse over gloo")
    ap.add_argument("--smoke", action="store_true", help="smoke configs, a small batch")
    ap.add_argument("--out", default="experiments/tp_cards.json")
    ap.add_argument("--train-only", action="store_true",
                    help="the train steps and their dry runs alone (no serving, no "
                         "collective timing)")
    args = ap.parse_args()
    dev = group.init_from_env(device=args.device, timeout=900)
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != 4:
        raise SystemExit(f"run over 4 ranks, not {world}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.kernels import cuda_lib

        if rank == 0:
            cuda_lib.load()  # builds the kernels once, the other ranks then load them
        dist.barrier()
        cuda_lib.load()
    get = get_smoke_config if args.smoke else get_config
    train_cfg = get(TRAIN_ARCH)
    if args.smoke:
        train_cfg = dataclasses.replace(train_cfg, dtype="float32")
    B, S, mb, steps = (8, 32, 2, 2) if args.smoke else (8, 4096, 2, 2)
    dsteps = 4 if args.smoke else 8
    batches = _batches(train_cfg, B, S, steps)
    t0 = time.perf_counter()
    res: dict = {"ranks": world, "device": str(dev)}
    if dev.type == "cuda":
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i",
             str(dev.index)], capture_output=True, text=True).stdout.strip()
    one = one_card_train(train_cfg, batches, mb, dev) if rank == 0 else None
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    obj = [None if one is None else {k: one[k] for k in ("metrics",)}]
    dist.broadcast_object_list(obj, src=0)
    train = [planned_train(train_cfg, batches, mb, m, dev, obj[0]) for m in MESHES]
    splan = sharding.make_plan(make_group_mesh(model=SERVE_MODEL), mode="serve")
    legs, serve_peaks = [], []
    for arch, dtype, full, small in ([] if args.train_only else SERVE_LEGS):
        cfg = dataclasses.replace(get(arch), dtype=dtype)
        SB, SS = small if args.smoke else full
        ref = serving(cfg, SB, SS, dsteps, dev, None) if rank == 0 else None
        feed = [None if ref is None else ref["tokens"][:-1].cpu()]
        dist.broadcast_object_list(feed, src=0)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        got = serving(cfg, SB, SS, dsteps, dev, splan, [t.to(dev) for t in feed[0]])
        serve_peaks.append(got["peak_extra_bytes"])
        if rank == 0:
            exp_tok, exp_lg = ref["tokens"][1:], ref["logits"]
            err = float((got["logits"] - exp_lg).abs().max()) / float(exp_lg.abs().max())
            legs.append({"arch": cfg.name, "dtype": dtype, "batch": SB, "seq": SS,
                         "steps": dsteps, "mesh": [1, SERVE_MODEL],
                         "prefill_token_equal": bool(torch.equal(got["tokens"][0],
                                                                 ref["tokens"][0])),
                         "tokens_equal": int((got["tokens"][1:] == exp_tok).sum()),
                         "tokens": int(exp_tok.numel()), "logit_err": err,
                         "within_tol": dtype != "float32" or err <= F32_SERVE_TOL,
                         "prefill_ms": got["prefill_ms"], "decode_ms": got["decode_ms"],
                         "decode_step_ms": got["decode_step_ms"],
                         "decode_nccl_ms": got["decode_nccl_ms"],
                         "decode_nccl_kernels": got["decode_nccl_kernels"],
                         "one_card_prefill_ms": ref["prefill_ms"],
                         "one_card_decode_ms": ref["decode_ms"],
                         "one_card_peak_extra_bytes": ref["peak_extra_bytes"]})
        del ref, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    coll = None if args.train_only else collective_cost(dev)
    peaks = [None] * world
    dist.all_gather_object(peaks, {"train": [t["peak_extra_bytes"] for t in train],
                                   "serve": serve_peaks,
                                   "dry_train": [t["dry_peak_extra_bytes"] for t in train],
                                   "census_equal": [t["census_equal"] for t in train],
                                   "census": [t["census"][-1] for t in train]})
    if rank == 0:
        res["train"] = {"arch": train_cfg.name, "batch": B, "seq": S, "microbatches": mb,
                        "one_card": {k: one[k] for k in ("metrics", "ms", "peak_extra_bytes")},
                        "planned": train, "rtol": TRAIN_RTOL}
        res["serve"] = legs
        res["collectives"] = coll
        res["peak_extra_bytes_by_rank"] = peaks
        res["wall_s"] = time.perf_counter() - t0
        res["ok"] = (all(t["within_tol"] for t in train)
                     and all(all(p["census_equal"]) for p in peaks)
                     and all(leg["prefill_token_equal"] and leg["within_tol"] for leg in legs))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res), flush=True)
    dist.barrier()
    group.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
