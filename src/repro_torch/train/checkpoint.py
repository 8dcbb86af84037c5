"""Checkpoint / restore of a train state, in the reference's on-disk format.

Layout: <dir>/step_<N>/ (``step_%08d``)
  manifest.json  -- step, the flat keys with their shapes and dtypes,
                    ``process_count`` (1)
  shard_0.npz    -- every leaf, under its ``/``-joined dict path
                    (``params/layers/attn/wq``, ``opt/mu/...``, ``opt/step``)

Both packages read and write the same files. ``save`` is atomic: it stages
into ``step_<N>.tmp_0`` and renames it into place (:func:`publish_dir`), so
a crash mid-save never corrupts the previous checkpoint.

One deviation from the reference, with the same files: the reference builds
every leaf's host copy before ``np.savez`` writes them, which at full width
holds the whole state in host memory (olmo-1b: 18.8 GB). ``save`` here
copies one leaf to the host at a time and writes it straight into the
archive, the entries ``np.savez`` writes (stored, zip64, ``<key>.npy``);
``np.load`` reads either.

Over a process group: ``save`` of a ``sharding.RankState`` (every rank's
shards, split over "data" and "model") gathers each leaf whole to rank 0
of the mesh's group, one leaf at a time, and rank 0
writes the same entries and manifest as one card, while the others wait at
a barrier; ``restore(..., plan=...)`` gives each rank its own shards. So a
checkpoint saved over a group reads on one card and in the reference, and
the other way round. Each rank reads every leaf whole and keeps its part.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import zipfile

import numpy as np
import torch

from .. import sharding as shard_mod
from ..core.comm import fsdp
from ..tree import flatten

__all__ = ["save", "restore", "latest_step", "publish_dir", "list_steps", "flatten"]


def publish_dir(tmp: str, final: str) -> str:
    """Atomically publish a staged directory: replace ``final`` with ``tmp``
    via rename. A crash before the rename leaves only a ``*.tmp_*`` dir
    (ignored and cleaned by :func:`list_steps`); a crash after it leaves the
    complete new version. Shared by trainer checkpoints and the streaming
    engine's ``StreamCheckpoint``."""
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def list_steps(directory: str, prefix: str = "step_",
               clean_stale: bool = True) -> list[int]:
    """Valid checkpoint step numbers under ``directory``, ascending.

    A subdirectory counts only when it is ``<prefix><int>`` **and** holds a
    ``manifest.json`` -- a partial dir from a crashed non-atomic writer must
    never be selected for restore. Leftover ``*.tmp_*`` staging dirs from a
    crash mid-publish are ignored and (by default) deleted."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if ".tmp_" in name:
            if clean_stale and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            continue
        if not (name.startswith(prefix) and os.path.isdir(path)):
            continue
        try:
            step = int(name[len(prefix):])
        except ValueError:
            continue
        if not os.path.exists(os.path.join(path, "manifest.json")):
            continue  # partial dir (no atomic publish): never restorable
        steps.append(step)
    return sorted(steps)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return np.asarray(v).nbytes


def _whole_leaves(state):
    """{key: the whole leaf} of ``state`` as rank 0 writes it: a
    ``RankState``'s leaves gathered to rank 0 one at a time (every rank
    runs the gathers; the others get ``None``), any other state's as they
    are; and the bytes the whole leaves take."""
    flat = flatten(state)
    if not isinstance(state, shard_mod.RankState):
        return ((k, v) for k, v in flat.items()), sum(_nbytes(v) for v in flat.values())
    plan = state.plan
    specs = flatten(state.specs)
    need = sum(_nbytes(v) * math.prod(plan.axis_size(a) for a in specs[k]) for k, v in flat.items())
    return ((k, shard_mod.gather_to_root(v, specs[k], plan)) for k, v in flat.items()), need


def save(directory: str, step: int, state, process_index: int = 0) -> str:
    """Write ``state`` (nested dicts of tensors or arrays) as
    ``<directory>/step_<step>``; returns that path. Raises ``OSError``
    before writing anything when the disk cannot hold it. A
    ``sharding.RankState`` is saved whole by rank 0: every rank of its
    group calls ``save``, and every rank raises if rank 0 cannot write."""
    leaves, need = _whole_leaves(state)
    group = (shard_mod.mesh_group(state.plan) if isinstance(state, shard_mod.RankState)
             else None)
    writes = group is None or fsdp.world_and_rank(group)[1] == 0
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp_{process_index}"
    free = need
    if writes:
        if os.path.exists(tmp):  # stale staging dir from a crashed save
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        free = shutil.disk_usage(tmp).free
        if need > free:
            shutil.rmtree(tmp)
    if group is not None:  # rank 0's verdict on every rank, before any gather
        dev = flatten(state)["opt/step"].device
        free = fsdp.broadcast_ints([free], group, dev)[0]
    if need > free:
        raise OSError(f"checkpoint of {need} bytes does not fit the {free} bytes free under "
                      f"{directory!r}")
    keys = {}
    zf = (zipfile.ZipFile(os.path.join(tmp, f"shard_{process_index}.npz"), mode="w",
                          compression=zipfile.ZIP_STORED, allowZip64=True) if writes else None)
    try:
        for k, v in leaves:
            if not writes:
                continue
            a = _host(v)
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
            keys[k] = {"shape": list(a.shape), "dtype": str(a.dtype)}
            del a, v
    finally:
        if zf is not None:
            zf.close()
    if writes:
        manifest = {"step": step, "keys": keys, "process_count": 1}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        publish_dir(tmp, final)
    if group is not None:
        fsdp.barrier(group)
    return final


def latest_step(directory: str) -> int | None:
    """Newest restorable step in ``directory`` (None when there is none).

    Robust to crash debris: leftover ``*.tmp_*`` staging dirs from a save
    interrupted mid-publish are ignored and cleaned, and a partial
    ``step_*`` dir without a ``manifest.json`` is never selected."""
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _fill(specs, flat: dict, prefix: str = ""):
    return {k: _fill(v, flat, f"{prefix}{k}/") if isinstance(v, dict) else flat[prefix + k]
            for k, v in specs.items()}


def restore(directory: str, step: int, state_specs: dict, device=None,
            process_index: int = 0, plan=None):
    """Load ``<directory>/step_<step>`` into the structure of
    ``state_specs`` (a state, or ``train_state_specs`` on the meta device):
    returns (state, step). Each leaf must have its spec's shape; it takes
    the spec's dtype and lands on ``device``, or on the spec's device when
    ``device`` is None (a meta spec needs ``device``). With ``plan`` (a
    train plan over a process group), ``state_specs`` is the whole state's
    layout and the state is this rank's shards, a ``sharding.RankState``."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(
            f"no restorable checkpoint for step {step} under {directory!r} "
            f"(valid steps: {list_steps(directory, clean_stale=False)})")
    with open(manifest_path) as f:
        manifest = json.load(f)
    layout = None
    if plan is not None:
        shard_mod.mesh_group(plan)
        layout = flatten(shard_mod.state_specs(state_specs, plan))
    out = {}
    with np.load(os.path.join(path, f"shard_{process_index}.npz")) as data:
        for key, spec in flatten(state_specs).items():
            arr = data[key]
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} != expected "
                                 f"{tuple(spec.shape)}")
            dev = torch.device(device) if device is not None else spec.device
            if dev.type == "meta":
                raise ValueError(f"leaf {key}: a meta spec needs restore(device=...)")
            t = torch.from_numpy(arr)  # np.load gives C-ordered arrays
            if layout is None:
                out[key] = t.to(device=dev, dtype=spec.dtype)
            else:  # the rank's part, in memory of its own
                t = shard_mod.local_shard(t, layout[key], plan, plan.mesh.coord)
                out[key] = t.to(device=dev, dtype=spec.dtype, copy=True).contiguous()
            del arr, t
    state = _fill(state_specs, out)
    if plan is not None:
        state = shard_mod.RankState(state, plan, shard_mod.state_specs(state_specs, plan))
    return state, manifest["step"]
