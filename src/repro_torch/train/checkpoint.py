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
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

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


def save(directory: str, step: int, state, process_index: int = 0) -> str:
    """Write ``state`` (nested dicts of tensors or arrays) as
    ``<directory>/step_<step>``; returns that path. Raises ``OSError``
    before writing anything when the disk cannot hold it."""
    flat = flatten(state)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp_{process_index}"
    if os.path.exists(tmp):  # stale staging dir from a crashed save
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    need = sum(_nbytes(v) for v in flat.values())
    free = shutil.disk_usage(tmp).free
    if need > free:
        shutil.rmtree(tmp)
        raise OSError(f"checkpoint of {need} bytes does not fit the {free} bytes free under "
                      f"{directory!r}")
    keys = {}
    with zipfile.ZipFile(os.path.join(tmp, f"shard_{process_index}.npz"), mode="w",
                         compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for k, v in flat.items():
            a = _host(v)
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
            keys[k] = {"shape": list(a.shape), "dtype": str(a.dtype)}
            del a
    manifest = {"step": step, "keys": keys, "process_count": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return publish_dir(tmp, final)


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
            process_index: int = 0):
    """Load ``<directory>/step_<step>`` into the structure of
    ``state_specs`` (a state, or ``train_state_specs`` on the meta device):
    returns (state, step). Each leaf must have its spec's shape; it takes
    the spec's dtype and lands on ``device``, or on the spec's device when
    ``device`` is None (a meta spec needs ``device``)."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(
            f"no restorable checkpoint for step {step} under {directory!r} "
            f"(valid steps: {list_steps(directory, clean_stale=False)})")
    with open(manifest_path) as f:
        manifest = json.load(f)
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
            out[key] = t.to(device=dev, dtype=spec.dtype)
            del arr, t
    return _fill(state_specs, out), manifest["step"]
