"""Dry run of the launch grid on one card, on the ``meta`` device.

For every (architecture x input shape) cell the cell's step runs once on
``meta`` tensors under :func:`~repro_torch.launch.op_cost.analyze`: the
train step, the prefill or the decode step, exactly as it runs on the card,
with the kernels' wrappers standing in for the kernels. Nothing is
allocated. Each record holds the parameter and state bytes, the tracked
peak against one card's memory (``fits_one_card``), the FLOPs and bytes
moved, and the roofline terms of :mod:`~repro_torch.launch.roofline` with
the model FLOPs. The reference (``launch/dryrun.py``) lowers each cell for
a 256- or 512-chip TPU mesh instead; its production choices are kept:
``MICROBATCHES``, bf16 serving weights, the int8 KV cache at decode for the
decoder-stack families, ``moe_groups`` equal to the device count (here 1),
``CACHE_PAD`` and the long_500k skip. A cell that does not fit is recorded
as needing more than one card; it is neither run nor cut.

Each record also holds ``state_bytes_per_device``: the bytes one device
would hold of the cell's state on the reference's production meshes,
"16x16" and "2x16x16" (``mesh.make_production_mesh``), laid out by the
sharding plans of ``repro_torch.sharding`` in the reference's modes
("serve" for decode cells, "train" for train and prefill cells):
parameters (and the optimizer state), the decode state and the input
batch. They are state bytes, not a peak: activations are not partitioned
on one process.

With ``mesh`` ("16x16", "2x16x16" or (D, M)) and ``rank``, a record is
one rank's part of the cell on that mesh, as the reference's records are
per device: the rank's shards of the arguments (``sharding.local_shape``)
on ``meta``, its rows of the batch, the plan in the reference's mode over
a dry mesh (``mesh.make_dry_mesh``) whose stand-in collectives allocate
their results and move nothing, and ``moe_groups`` equal to the mesh size.
The record then holds the rank's peak and resident bytes, its collectives
(``collectives.per_op``: count and bytes of each kind, the bytes of each
result on this rank) and the roofline with ``n_chips`` the mesh size and
the collective term ``total_bytes / HW["ici_bw"]``. Without a mesh (one
card) nothing is collective, and the term is 0.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh 16x16 --rank 0
  python -m repro_torch.launch.dryrun --all [--mesh 16x16]
  (writes JSON per cell under experiments/dryrun_torch/)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch

from .. import sharding as shard_mod
from ..configs import ARCHS, canonical, get_config
from ..models.model_zoo import build_model
from ..serve.serve_step import make_prefill, make_serve_step
from ..train.train_step import TrainHParams, make_train_step, train_state_specs
from ..tree import tree_map
from . import op_cost
from .mesh import make_dry_mesh, make_production_mesh, parse_mesh
from .roofline import roofline_terms
from .shapes import SHAPES, ShapeCell, cell_applicable, input_specs

__all__ = ["MICROBATCHES", "CACHE_PAD", "CARD_BYTES", "PRODUCTION_MESHES", "build_cell",
           "run_cell", "rank_collectives", "mesh_name", "run_grid", "card_memory", "state_bytes_per_device"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
CACHE_PAD = 512  # decode cache length padding, the reference's
N_DEVICES = 1
PRODUCTION_MESHES = {"16x16": False, "2x16x16": True}  # name: multi_pod
CARD_BYTES = 80e9  # an H100's 80 GB (data sheet), where no card is visible

# Gradient-accumulation microbatches for train_4k: the reference's
# production memory configuration, kept so that the cells are the same.
MICROBATCHES = {
    "deepseek-67b": 2,
    "gemma2-9b": 2,
    "llava-next-mistral-7b": 1,
    "zamba2-1.2b": 1,
    "stablelm-3b": 1,
    "mamba2-1.3b": 1,
    "granite-moe-3b-a800m": 1,
    "granite-moe-1b-a400m": 1,
    "olmo-1b": 1,
    "whisper-tiny": 1,
}


def card_memory() -> tuple[float, str]:
    """(bytes of one card, where the figure comes from): the visible card's
    ``total_memory``, else the H100's 80 GB."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return float(props.total_memory), f"total_memory of {props.name}"
    return CARD_BYTES, "80e9, an H100's 80 GB (no card visible)"


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in op_cost.tensors(tree))


def state_bytes_per_device(cell: ShapeCell, args: tuple) -> dict:
    """{mesh name: bytes one device holds} of a cell's arguments (as
    :func:`build_cell` gives them) on each of :data:`PRODUCTION_MESHES`."""
    out = {}
    for name, multi_pod in PRODUCTION_MESHES.items():
        plan = shard_mod.make_plan(make_production_mesh(multi_pod=multi_pod),
                                   mode="serve" if cell.kind == "decode" else "train")
        if cell.kind == "train":
            n = shard_mod.bytes_per_device(args[0], shard_mod.state_specs(args[0], plan), plan)
        else:
            params, state = args[0], args[1]
            long_ctx = cell.kind == "decode" and cell.global_batch == 1
            n = (shard_mod.bytes_per_device(params, shard_mod.param_specs(params, plan), plan)
                 + shard_mod.bytes_per_device(
                     state, shard_mod.decode_state_specs(state, plan, long_context=long_ctx),
                     plan))
        out[name] = n + shard_mod.bytes_per_device(
            args[-1], shard_mod.batch_specs(args[-1], plan), plan)
    return out


def _rank_shards(tree, specs, plan):
    """Fresh ``meta`` tensors of the shapes one rank holds of ``tree``
    (each its own storage, so that the peak counts the rank's bytes)."""
    if isinstance(tree, dict):
        return {k: _rank_shards(v, specs[k], plan) for k, v in tree.items()}
    return torch.empty(shard_mod.local_shape(tree.shape, specs, plan), dtype=tree.dtype,
                       device="meta")


def _rank_batch(batch: dict, plan, microbatches: int) -> dict:
    """The rows of a global batch one rank takes (``sharding.batch_rows``)."""
    rows = len(shard_mod.batch_rows(next(iter(batch.values())).shape[0], plan, microbatches))
    return {k: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
            for k, v in batch.items()}


def build_cell(arch: str, shape: str, *, cell: ShapeCell | None = None,
               microbatches: int | None = None, overrides: dict | None = None,
               mesh=None, rank: int = 0, config=None, plan_mode: str | None = None,
               serve_dtype: torch.dtype = torch.bfloat16, cache_len: int | None = None,
               long_context: bool | None = None, inputs: dict | None = None):
    """(step function, arguments on ``meta``, the cell's config, its
    microbatches, the plan or None) for one cell. ``cell`` replaces
    ``SHAPES[shape]`` and ``microbatches`` the table's count (a train cell
    cut to what a path runs); ``overrides`` replace config fields.

    ``mesh`` ("16x16", "2x16x16" or (D, M)) makes the arguments rank
    ``rank``'s part of the cell under a plan over :func:`make_dry_mesh`,
    in the reference's mode ("serve" for decode cells, else "train") unless
    ``plan_mode`` names one. ``config`` is used as it is in place of the
    architecture's published config (no ``moe_groups`` or int8 cache set
    here); serving weights and the KV cache are ``serve_dtype`` (the
    reference's bf16), the cache ``cache_len`` positions (default S +
    ``CACHE_PAD``), long-context (the positions over the whole mesh) when
    ``long_context`` says so, by default for a one-row decode. ``inputs``
    (the global batch as ``meta`` tensors) replaces the cell's
    ``input_specs``."""
    cfg = config if config is not None else get_config(arch)
    cell = cell if cell is not None else SHAPES[shape]
    plan, n_devices = None, N_DEVICES
    if mesh is not None:
        sizes, axes = parse_mesh(mesh)
        n_devices = math.prod(sizes)
        plan = shard_mod.make_plan(make_dry_mesh(sizes, axes, rank), mode=plan_mode or (
            "serve" if cell.kind == "decode" else "train"))
    if config is None:
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, moe_groups=n_devices)
        if cell.kind == "decode" and cfg.family in ("dense", "moe", "vlm"):
            # production serving default: the int8 KV cache
            cfg = dataclasses.replace(cfg, kv_quant_decode=True)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg, device="meta")
    specs = input_specs(cfg, cell) if inputs is None else dict(inputs)
    mb = 1
    if cell.kind == "train":
        mb = microbatches if microbatches is not None else MICROBATCHES.get(cfg.name, 1)
        fn = make_train_step(model, TrainHParams(microbatches=mb), plan=plan)
        state = train_state_specs(model)
        if plan is not None:
            st_specs = shard_mod.state_specs(state, plan)
            state = shard_mod.RankState(_rank_shards(state, st_specs, plan), plan, st_specs)
            specs = _rank_batch(specs, plan, mb)
        args = (state, specs)
    else:
        params = train_state_specs(model)["params"]
        if serve_dtype is not None:
            params = tree_map(lambda t: torch.empty_like(t, dtype=serve_dtype)
                              if t.dtype == torch.float32 else t, params)
        if plan is not None:
            params = _rank_shards(params, shard_mod.param_specs(params, plan), plan)
            specs = _rank_batch(specs, plan, 1)
        lc = (cell.kind == "decode" and cell.global_batch == 1) if long_context is None \
            else long_context
        state = model.init_decode_state(
            cell.global_batch, cell.seq_len + CACHE_PAD if cache_len is None else cache_len,
            serve_dtype or torch.bfloat16, plan=plan, long_context=lc and plan is not None)
        if cell.kind == "prefill":
            fn = make_prefill(model, plan)
        else:  # decode: one new token after a cache of S positions
            state["length"] = cell.seq_len
            fn = make_serve_step(model, plan)
        args = (params, state, specs)
    return fn, args, cfg, mb, plan



def rank_collectives(arch: str, shape: str, *, mesh, rank: int = 0, **kw) -> dict:
    """One rank's collectives and state on ``mesh`` without the flop and
    byte counters of :func:`run_cell`: ``{"collectives": {kind: {"count",
    "bytes"}}, "state_bytes": the rank's state arguments (parameters and
    optimizer state, or serving weights and decode state),
    "resident_bytes": every argument}``. ``kw`` are :func:`build_cell`'s."""
    fn, args, _, _, _ = build_cell(arch, shape, mesh=mesh, rank=rank, **kw)
    return {"collectives": op_cost.census_of(fn, *args), "state_bytes": _tree_bytes(args[:-1]),
            "resident_bytes": _tree_bytes(args)}


def mesh_name(mesh) -> str:
    """"1" for one card, else the mesh's sizes joined by "x"."""
    return "1" if mesh is None else "x".join(map(str, parse_mesh(mesh)[0]))


def run_cell(arch: str, shape: str, *, save: bool = True, verbose: bool = True,
             cell: ShapeCell | None = None, microbatches: int | None = None,
             overrides: dict | None = None, card: tuple[float, str] | None = None,
             tag: str = "", mesh=None, rank: int = 0, config=None,
             plan_mode: str | None = None, serve_dtype: torch.dtype = torch.bfloat16,
             cache_len: int | None = None, long_context: bool | None = None,
             inputs: dict | None = None) -> dict:
    """One cell's record: ``status`` "ok", "skipped" (long_500k for a
    full-attention arch) or "error" (with the traceback). ``card`` is
    :func:`card_memory`'s (bytes, source), asked for when not given. With
    ``mesh``, the record is rank ``rank``'s (module docstring); the other
    keywords are :func:`build_cell`'s."""
    cfg0 = config if config is not None else get_config(arch)
    ok, reason = cell_applicable(cfg0, shape)
    where = mesh_name(mesh) + ("" if mesh is None else f" rank {rank}")
    rec = {"arch": cfg0.name, "shape": shape, "mesh": mesh_name(mesh), "tag": tag}
    if mesh is not None:
        rec["rank"] = rank
    if not ok:
        rec.update(status="skipped", reason=reason)
        if verbose:
            print(f"[dryrun] {cfg0.name} x {shape} x {where}: SKIP ({reason})")
        if save:
            _save(rec)
        return rec

    t0 = time.time()
    try:
        kw = dict(cell=cell, microbatches=microbatches, overrides=overrides, config=config,
                  serve_dtype=serve_dtype, cache_len=cache_len, inputs=inputs)
        fn, args, cfg, mb, plan = build_cell(arch, shape, mesh=mesh, rank=rank,
                                             plan_mode=plan_mode, long_context=long_context,
                                             **kw)
        cell = cell if cell is not None else SHAPES[shape]
        n_devices = N_DEVICES if plan is None else plan.mesh.size
        whole = args if plan is None else build_cell(arch, shape, **kw)[1]
        per_device = state_bytes_per_device(cell, whole)
        del whole
        cost = op_cost.analyze(fn, *args)
        card, card_from = card if card is not None else card_memory()
        if cell.kind == "train":
            param_bytes = _tree_bytes(args[0]["params"])
            state_bytes = _tree_bytes(args[0]["opt"])
        else:
            param_bytes, state_bytes = _tree_bytes(args[0]), _tree_bytes(args[1])
        memory = {"param_bytes": param_bytes, "state_bytes": state_bytes,
                  "input_bytes": _tree_bytes(args[-1]), "resident_bytes": cost.resident_bytes,
                  "peak_bytes": cost.peak_bytes, "bytes_per_device": cost.peak_bytes,
                  "card_bytes": card, "card_bytes_from": card_from}
        collectives = {"per_op": cost.collective_counts, "total_bytes": cost.collective_bytes,
                       "total_count": sum(c["count"] for c in cost.collective_counts.values())}
        roof = roofline_terms(cfg, cell, flops=cost.flops, bytes_accessed=cost.bytes,
                              collective=collectives, n_chips=n_devices)
        fits = cost.peak_bytes <= card
        rec.update(
            status="ok",
            n_devices=n_devices,
            batch=cell.global_batch,
            seq=cell.seq_len,
            kind=cell.kind,
            microbatches=mb,
            analyze_s=round(time.time() - t0, 2),
            memory=memory,
            fits_one_card=fits,
            needs="one card" if fits else "more than one card",
            state_bytes_per_device=per_device,
            flops=cost.flops,
            bytes_accessed=cost.bytes,
            kernels=cost.kernels,
            collectives=collectives,
            roofline=roof,
        )
        if verbose:
            print(f"[dryrun] {cfg.name} x {shape} x {where} ({cell.global_batch}x"
                  f"{cell.seq_len}): OK  peak={cost.peak_bytes / 2**30:.2f}GiB "
                  f"({'fits one card' if fits else 'needs more than one card'})  "
                  f"flops={cost.flops:.3e}  bytes={cost.bytes:.3e}  "
                  f"coll={collectives['total_count']}x {cost.collective_bytes:.3e}B  "
                  "state/device " + ", ".join(f"{k} {v / 2**30:.3f}GiB"
                                              for k, v in per_device.items())
                  + f"  ({rec['analyze_s']:.1f}s)")
    except Exception as e:  # noqa: BLE001 -- the grid reports per-cell failures
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {cfg0.name} x {shape} x {where}: FAIL {type(e).__name__}: {e}")
    if save:
        _save(rec)
    return rec


def _cost_rank(cell: tuple[str, str]) -> int:
    """Rough host cost of a cell's meta run, for longest-first scheduling:
    train steps first, deeper models first."""
    cfg = get_config(cell[0])
    kind = SHAPES[cell[1]].kind
    return cfg.n_layers * (MICROBATCHES.get(cfg.name, 1) * 8 if kind == "train" else 1)


def run_grid(cells: list[tuple], *, workers: int = 1, **kw) -> list[dict]:
    """:func:`run_cell` for each (arch, shape) or (arch, shape, its own
    keyword arguments) of ``cells`` with ``kw``, records in the cells'
    order. The meta runs are host work only: with ``workers > 1`` they run
    in as many spawned processes, the costliest first; pass ``card`` then,
    so that no worker asks the card."""
    calls = [(c[0], c[1], {**kw, **(c[2] if len(c) > 2 else {})}) for c in cells]
    if workers <= 1:
        return [run_cell(a, s, **k) for a, s, k in calls]
    order = sorted(range(len(calls)), key=lambda i: -_cost_rank(calls[i][:2]))
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {i: pool.submit(run_cell, calls[i][0], calls[i][1], **calls[i][2])
                   for i in order}
        return [futures[i].result() for i in range(len(calls))]


def _save(rec: dict):
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    where = "1card" if rec["mesh"] == "1" else \
        f"{rec['mesh'].replace('x', '_')}_rank{rec.get('rank', 0)}"
    name = f"{canonical(rec['arch'])}__{rec['shape']}__{where}{tag}.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(rec, f, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes for --all (the meta runs are host work)")
    ap.add_argument("--mesh", default=None,
                    help="16x16, 2x16x16 or DxM: one rank's part on that mesh "
                         "(default: one card)")
    ap.add_argument("--rank", type=int, default=0, help="the rank of --mesh")
    args = ap.parse_args()

    if args.all:
        recs = run_grid([(a, s) for a in ARCHS for s in SHAPES], workers=args.workers,
                        card=card_memory(), mesh=args.mesh, rank=args.rank)
        sys.exit(1 if any(r["status"] == "error" for r in recs) else 0)
    if args.arch is None or args.shape is None:
        ap.error("give --arch and --shape, or --all")
    rec = run_cell(args.arch, args.shape, mesh=args.mesh, rank=args.rank)
    sys.exit(1 if rec["status"] == "error" else 0)


if __name__ == "__main__":
    main()
