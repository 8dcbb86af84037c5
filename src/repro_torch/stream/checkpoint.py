"""StreamCheckpoint: atomic snapshots of a streaming query's state.

The streaming runner's per-query state is already explicit — scan cursor
(batch index, equivalently dataset chunk index + in-chunk offset),
device-resident carry tables (groupby partials, unique carry), spill-file
manifests, partial concat outputs, and the folded overflow counters. A
checkpoint is one consistent snapshot of all of it, taken at a morsel
boundary, so a killed query can resume *mid-stream* and produce output
bit-identical to an uninterrupted run. Adaptive streams
(``collect(..., adaptive=True)``) additionally snapshot their
``repro_torch.stats.AdaptiveController`` decision state inside the
active-stage metadata, so a resumed query re-enters the exact corrected
plan and makes the same future re-planning decisions it would have made
uninterrupted.

Layout (one directory per query)::

    <dir>/
      ckpt_00000004/          one snapshot, atomically published
        manifest.json         step, query_key, stage/cursor, completed-stage
                              metadata, JSON-able info counters
        arrays.npz            namespaced numpy payloads: ``active/...`` for
                              the in-flight phase (e.g. carry-table columns
                              + per-worker counts), ``completed/<stage>/...``
                              for finished stages, ``info/...`` counters
      spill/                  persistent spill datasets (sort runs, join
                              hash buckets) — referenced by manifests inside
                              the snapshots, deleted on query success

Publication is an atomic tmp-dir-rename (``train.checkpoint.publish_dir``,
shared with the trainer's checkpoints, as in the reference): a crash
mid-save leaves only a ``*.tmp_*`` staging dir, which :meth:`latest`
ignores and cleans — the previous snapshot stays restorable. The ``checkpoint_publish`` fault site
fires between staging and publication, so chaos tests can prove exactly
that property.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Mapping

import numpy as np

from ..testing import faults as _faults

__all__ = ["StreamCheckpoint"]

_PREFIX = "ckpt_"


class StreamCheckpoint:
    """Atomic store of streaming-query snapshots under one directory.

    ``save``/``load`` move a ``(manifest dict, arrays dict)`` pair; the
    manifest must be JSON-serializable, arrays are numpy. ``latest`` is
    crash-robust: staging dirs and partial snapshots are never selected.
    """

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step:08d}")

    @property
    def spill_root(self) -> str:
        """Parent dir for spill datasets that must survive a crash."""
        return os.path.join(self.directory, "spill")

    def spill_dir(self, tag: str, create: bool = True) -> str:
        """Create (if needed and ``create``) and return a persistent spill
        directory."""
        path = os.path.join(self.spill_root, tag)
        if create:
            os.makedirs(path, exist_ok=True)
        return path

    def save(self, step: int, manifest: Mapping,
             arrays: Mapping[str, np.ndarray]) -> str:
        """Atomically publish snapshot ``step``. The ``checkpoint_publish``
        fault site fires after staging, before the rename — an injected
        crash there leaves the previous snapshot intact."""
        final = self._path(step)
        tmp = final + ".tmp_0"
        if os.path.exists(tmp):  # stale staging dir from a crashed save
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: np.asarray(v) for k, v in arrays.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": int(step), **dict(manifest)}, f)
        _faults.check("checkpoint_publish")
        from ..train.checkpoint import publish_dir
        return publish_dir(tmp, final)

    def steps(self) -> list[int]:
        """Restorable snapshot steps, ascending (cleans ``*.tmp_*`` debris)."""
        from ..train.checkpoint import list_steps
        return list_steps(self.directory, prefix=_PREFIX)

    def latest(self) -> int | None:
        """Newest restorable snapshot step, or None."""
        steps = self.steps()
        return steps[-1] if steps else None

    def load(self, step: int | None = None) -> tuple[dict, dict]:
        """Read snapshot ``step`` (default: latest) as
        ``(manifest, arrays)`` with arrays materialized on host."""
        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(
                    f"no restorable stream checkpoint under {self.directory!r}")
        path = self._path(step)
        manifest_path = os.path.join(path, "manifest.json")
        if not os.path.exists(manifest_path):
            raise FileNotFoundError(
                f"no restorable stream checkpoint for step {step} under "
                f"{self.directory!r} (valid steps: {self.steps()})")
        with open(manifest_path) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        return manifest, arrays

    def prune(self, keep_last: int = 1) -> None:
        """Delete all but the newest ``keep_last`` snapshots."""
        for step in self.steps()[:-keep_last or None]:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def clear(self) -> None:
        """Remove every snapshot and all persistent spill data (called on
        query success — checkpoints are crash artifacts, not results)."""
        for step in self.steps():
            shutil.rmtree(self._path(step), ignore_errors=True)
        shutil.rmtree(self.spill_root, ignore_errors=True)
