"""The planned train step at model axis 1 against one device's, in turns
between checkouts of the port, on one card: how far a change moves the
planned step's time where it should move nothing.

Run on a host with one card, from the root of a checkout, ``OTHER`` being
another checkout (say, the parent commit unpacked with ``git archive``):

    python scripts/torch_planned_turns.py --roots OTHER . --turns 10

Each turn is one process per root, in the order A B B A A B ... (so that a
drift of the host's speed over the run falls on both alike), each with the
``src/`` of its root first on the path, a one-rank NCCL group and the
kernels its root builds. In each process zamba2-1.2b at published widths
(random float32 weights from a seed, bf16 compute) takes ``--steps`` timed
train steps of 2 x 4096 tokens on one device (``make_train_step(model,
hp)``) and then as many planned ones under ``make_plan(make_group_mesh())``
from the same state, after one warm-up step each; the reading is the median
planned step over the median one-device step, taken in the same process.
The first planned loss must equal the first one-device loss by bits. Each
timed step also records what it spent in Python's garbage collector (and
its full collections) and the caching allocator's retries, device
allocations and frees; a full collection takes 160-250 ms of a step on the
card's host, and where one falls depends on everything the process
allocated before, so ``--gc-off`` runs one before the timed steps and none
during them.

``--witness`` instead runs zamba2-1.2b's serving (4 x 4096 prompts, 8
decode steps) on one card in bf16 and in float32 (the KV cache in the
compute dtype), the same float32 weights, the float32 run fed the
bf16 run's tokens: the logit gap and the share of greedy tokens that bf16
rounding alone gives on one card, the yardstick for the bf16 readings of
``scripts/torch_tp_cards.py``.

Rehearse on the CPU (gloo, the smoke config, a short sequence) with
``--device cpu --smoke``.

The last line of the output is one JSON object (also written to
``--out``). It imports no jax and nothing of the reference package.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ARCH = "zamba2-1.2b"
B, S = 2, 4096
SERVE_B, SERVE_S, DECODE = 4, 4096, 8
SEED = 1


def _smi() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
    except FileNotFoundError:
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def _config(smoke: bool, **changes):
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    return dataclasses.replace((get_smoke_config if smoke else get_config)(ARCH), **changes)


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_ALLOC_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def _timed(step, state, batches, dev, gc_off: bool = False) -> tuple[list, list, list]:
    """(ms of each step but the first, every step's loss, what each timed
    step spent besides: milliseconds in Python's garbage collector, its
    full collections, and the caching allocator's retries, device
    allocations and frees). ``gc_off``: a full collection before the
    steps, and none during them."""
    import gc

    import torch

    cuda = dev.type == "cuda"
    in_gc = {"ms": 0.0, "full": 0, "t": 0.0}

    def watch(phase, info):
        if phase == "start":
            in_gc["t"] = time.perf_counter()
            return
        in_gc["ms"] += (time.perf_counter() - in_gc["t"]) * 1e3
        in_gc["full"] += info["generation"] == 2

    ms, losses, side = [], [], []
    if gc_off:
        gc.collect()
        gc.disable()
    gc.callbacks.append(watch)
    try:
        for b in batches:
            _sync(dev)
            before = torch.cuda.memory_stats() if cuda else {}
            in_gc.update(ms=0.0, full=0)
            t = time.perf_counter()
            state, m = step(state, b)
            _sync(dev)
            ms.append((time.perf_counter() - t) * 1e3)
            after = torch.cuda.memory_stats() if cuda else {}
            losses.append(float(m["loss"]))
            side.append({"gc_ms": in_gc["ms"], "gc_full": in_gc["full"],
                         **{k: after.get(k, 0) - before.get(k, 0) for k in _ALLOC_STATS}})
    finally:
        gc.callbacks.remove(watch)
        gc.enable()
    return ms[1:], losses, side[1:]


def turn(steps: int, device: str | None, smoke: bool, gc_off: bool) -> dict:
    """One process's reading (the path holds the root's ``src/``)."""
    import torch

    from repro_torch import sharding
    from repro_torch.core.comm import group
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainHParams, init_train_state, make_train_step,
                                              shard_train_state)

    dev = group.init_from_env(device=device, timeout=600)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_lib.load()
    seq = 64 if smoke else S
    try:
        cfg = _config(smoke)
        model = build_model(cfg, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        whole = init_train_state(model, gen)
        batches = []
        for _ in range(steps + 1):
            toks = torch.randint(0, cfg.vocab_size, (B, seq + 1), device=dev, generator=gen)
            batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                            "loss_mask": torch.ones((B, seq), dtype=torch.float32, device=dev)})
        hp = TrainHParams(opt=AdamWConfig(warmup_steps=10))
        plan = sharding.make_plan(make_group_mesh())
        state = shard_train_state(whole, plan)  # a copy: the one-device step works in place
        one_ms, one_loss, one_side = _timed(make_train_step(model, hp), whole, batches, dev,
                                            gc_off)
        del whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ms, loss, side = _timed(make_train_step(model, hp, plan=plan), state, batches, dev,
                                gc_off)
    finally:
        group.close()
    # the first step's loss is the forward's, from one state: equal by bits
    return {"one_ms": one_ms, "planned_ms": ms, "first_loss_equal": loss[0] == one_loss[0],
            "losses": loss, "one_losses": one_loss, "one_side": one_side, "planned_side": side,
            "ratio": statistics.median(ms) / statistics.median(one_ms)}


def witness(device: str, smoke: bool) -> dict:
    """bf16 against float32 serving of ``ARCH`` on one card."""
    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        cuda_lib.load()
    seq = 64 if smoke else SERVE_S
    out = {}
    feed = None
    for dtype in ("bfloat16", "float32"):
        cfg = _config(smoke, dtype=dtype)
        model = build_model(cfg, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 2)
        params = model.init_params(gen)
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, seq), device=device, generator=gen)
        with torch.inference_mode():
            st = model.init_decode_state(SERVE_B, seq + DECODE, dtype=getattr(torch, dtype))
            nxt, state = make_prefill(model)(params, st, {"tokens": tokens})
            toks, logits = [nxt], []
            for i in range(DECODE):
                tok = toks[-1] if feed is None else feed[i]
                lg, state = model.decode_step(params, state, {"token": tok[:, None]})
                logits.append(lg.float())
                toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
        out[dtype] = {"tokens": torch.stack(toks), "logits": torch.stack(logits)}
        if feed is None:
            feed = out[dtype]["tokens"][:-1]
        del params, state, model
        if device == "cuda":
            torch.cuda.empty_cache()
    bf, f32 = out["bfloat16"], out["float32"]
    scale = float(f32["logits"].abs().max())
    return {"arch": ARCH, "batch": SERVE_B, "seq": seq, "steps": DECODE,
            "prefill_token_equal": bool(torch.equal(bf["tokens"][0], f32["tokens"][0])),
            "tokens_equal": int((bf["tokens"][1:] == f32["tokens"][1:]).sum()),
            "tokens": int(bf["tokens"][1:].numel()),
            "logit_err": float((bf["logits"] - f32["logits"]).abs().max()) / scale,
            "logit_err_by_step": [float((b - f).abs().max()) / scale
                                  for b, f in zip(bf["logits"], f32["logits"])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"), help="two checkouts of the repo")
    ap.add_argument("--turns", type=int, default=10, help="processes per root")
    ap.add_argument("--steps", type=int, default=3, help="timed steps per run")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--device", default=None, help="cpu to rehearse over gloo")
    ap.add_argument("--smoke", action="store_true", help="the smoke config, a short sequence")
    ap.add_argument("--gc-off", action="store_true",
                    help="no garbage collection during the timed steps (one before them)")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="experiments/planned_turns.json")
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.steps, args.device, args.smoke, args.gc_off)), flush=True)
        return 0
    t0 = time.perf_counter()
    res: dict = {"card": _smi()}
    if not args.witness and not args.roots:
        ap.error("--roots A B, or --witness")
    if args.witness:
        res["witness"] = witness(args.device or "cuda", args.smoke)
    else:
        roots = [os.path.abspath(r) for r in args.roots]
        if args.device != "cpu":  # each root's kernels, built side by side
            builds = [subprocess.Popen([sys.executable, "-c", "from repro_torch.kernels import "
                                        "cuda_lib; cuda_lib.load()"],
                                       env={**os.environ, "PYTHONPATH": os.path.join(r, "src")})
                      for r in roots]
            if any(p.wait() for p in builds):
                raise RuntimeError("a root's kernels did not build")
        extra = (["--device", args.device] if args.device else []) + (
            ["--smoke"] if args.smoke else []) + (["--gc-off"] if args.gc_off else [])
        order = [(0, 1, 1, 0)[i % 4] for i in range(2 * args.turns)]
        readings: list[list] = [[], []]
        for i in order:
            env = {**os.environ, "PYTHONPATH": os.path.join(roots[i], "src"), "RANK": "0",
                   "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(_free_port())}
            env.setdefault("NCCL_SOCKET_IFNAME", "lo")
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                                   "--steps", str(args.steps), *extra], capture_output=True,
                                  text=True, env=env, cwd=roots[i], timeout=600)
            if proc.returncode:
                raise RuntimeError(f"a turn of {roots[i]} failed:\n{proc.stderr[-3000:]}")
            r = json.loads(proc.stdout.splitlines()[-1])
            if not r["first_loss_equal"]:
                raise RuntimeError(f"{roots[i]}: the planned loss differs from one device's")
            readings[i].append(r)
            print(f"{roots[i]}: planned/one {r['ratio']:.4f} (planned {r['planned_ms']}, "
                  f"one {r['one_ms']} ms; planned steps besides {r['planned_side']}, one "
                  f"device's {r['one_side']})", flush=True)
        res["turns"] = {}
        for root, rs in zip(roots, readings):
            ratios = [r["ratio"] for r in rs]
            res["turns"][root] = {"ratios": ratios, "median": statistics.median(ratios),
                                  "min": min(ratios), "max": max(ratios), "runs": rs}
    res["wall_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
