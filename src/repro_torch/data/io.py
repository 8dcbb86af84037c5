"""Partitioned I/O (paper §5.3.8): distribute input files across workers,
read each worker's assignment, write one output file per partition.

File distribution is host-side (round-robin or explicit one-to-many
mapping); workers with no assigned data construct an empty dataframe with
the shared schema, exactly as the paper specifies. CSV here covers the
paper's formats list conceptually (CSV/JSON/Parquet) — the assignment and
empty-partition semantics are format-independent. The reference's
``repro.data.io``; partitions land as (P, capacity) tensors on the
context's device. Over a process group (``DDFContext(group=...)``) each
rank reads and writes the files of its own block of workers, and holds
``(P / world, capacity)`` tensors; capacity and the string vocabularies
come from every worker's files, so all ranks agree on them.
"""

from __future__ import annotations

import csv
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core import DDF, DDFContext
from ..core.dataframe import canonical_numpy
from ..core.vocab import DICT_DTYPE, DictVocab
from .dataset import iter_csv_chunks

__all__ = ["read_csv_dist", "write_csv_dist", "assign_files"]


def _np_dtype(d) -> np.dtype:
    """Host numpy dtype for one schema entry (``"dict"`` reads as strings)."""
    return np.dtype(np.str_) if str(d) == DICT_DTYPE else np.dtype(d)


def assign_files(files: Sequence[str], nworkers: int,
                 mapping: Mapping[int, Sequence[str]] | None = None) -> list[list[str]]:
    """Round-robin by default; or a custom worker -> files mapping."""
    if mapping is not None:
        return [list(mapping.get(w, ())) for w in range(nworkers)]
    out: list[list[str]] = [[] for _ in range(nworkers)]
    for i, f in enumerate(files):
        out[i % nworkers].append(f)
    return out


def _read_csv(path: str, schema: Mapping[str, np.dtype]) -> dict[str, np.ndarray]:
    """Read one CSV file into typed columns via the chunked columnar reader
    (``dataset.iter_csv_chunks`` — no row-at-a-time dict materialization)."""
    chunks = list(iter_csv_chunks(path, schema))
    if not chunks:
        return {k: np.zeros((0,), dtype=_np_dtype(d)) for k, d in schema.items()}
    return {k: np.concatenate([c[k] for c in chunks]) for k in schema}


def read_csv_dist(files: Sequence[str], schema: Mapping[str, np.dtype],
                  ctx: DDFContext, capacity: int | None = None,
                  mapping: Mapping[int, Sequence[str]] | None = None) -> DDF:
    """Partitioned input: each worker reads its file assignment; empty
    workers get an empty partition with the shared schema (paper §5.3.8).

    An explicit ``capacity`` smaller than some worker's assigned rows raises
    ``ValueError`` — rows are never silently dropped. Omit ``capacity`` to
    size partitions from the largest assignment. For datasets that should
    not be fully materialized, use ``repro_torch.stream.scan_csv`` instead.
    """
    nw, blk = ctx.nworkers, ctx.workers
    assignment = assign_files(files, nw, mapping)

    def read_worker(flist, sch):
        parts = [_read_csv(f, sch) for f in flist]
        if parts:
            return {k: np.concatenate([p[k] for p in parts]) for k in sch}
        return {k: np.zeros((0,), dtype=_np_dtype(d)) for k, d in sch.items()}

    per_worker = [read_worker(assignment[w], schema) for w in range(blk.lo, blk.hi)]

    # dict-encode string columns against ONE vocab shared by all partitions:
    # the distributed invariant every shuffle relies on (codes comparable
    # across workers) holds by construction for a single ingest. Over a
    # group each rank also reads the string columns of the other ranks'
    # files, so that every rank builds the same vocabulary.
    dict_schema = {k: d for k, d in schema.items() if str(d) == DICT_DTYPE}
    strings = [per_worker[w - blk.lo] if blk.lo <= w < blk.hi
               else read_worker(assignment[w], dict_schema)
               for w in range(nw)] if dict_schema else []
    vocabs: dict[str, DictVocab] = {}
    for k in dict_schema:
        vocabs[k] = DictVocab.from_values(
            np.concatenate([np.asarray(p[k], dtype=np.str_) for p in strings])
            if any(len(p[k]) for p in strings) else np.zeros(0, np.str_))
        for p in per_worker:
            p[k] = vocabs[k].encode(p[k])

    local_lens = [len(next(iter(p.values()))) for p in per_worker]
    lens = blk.gather_workers(torch.tensor(local_lens, dtype=torch.int64,
                                           device=ctx.device)).tolist()
    cap = capacity or max(max(lens), 1)
    if max(lens) > cap:
        offenders = {w: n for w, n in enumerate(lens) if n > cap}
        raise ValueError(
            f"read_csv_dist: capacity={cap} would silently drop rows on "
            f"worker(s) {offenders} (rows assigned > capacity). Pass "
            f"capacity >= {max(lens)}, omit capacity to auto-size, or "
            f"stream the files with repro_torch.stream.scan_csv.")
    cols = {}
    counts = np.asarray(local_lens, np.int32)
    for k, d in schema.items():
        buf = np.zeros((blk.local, cap),
                       dtype=np.int32 if str(d) == DICT_DTYPE else d)
        for w, p in enumerate(per_worker):
            v = p[k]
            buf[w, : len(v)] = v
        # the from_numpy layout: canonical dtypes (x64 off), (local, capacity)
        cols[k] = torch.from_numpy(canonical_numpy(buf)).to(ctx.device)
    return DDF(cols, torch.from_numpy(counts).to(ctx.device), ctx, vocabs)


def write_csv_dist(ddf: DDF, directory: str, prefix: str = "part") -> list[str]:
    """Partitioned output: one file per partition (paper §5.3.8), named by
    the worker's global id. Over a group each rank writes its own workers'
    files; returns the paths this process wrote."""
    os.makedirs(directory, exist_ok=True)
    counts = ddf.counts.cpu().numpy()
    names = sorted(ddf.columns)
    paths = []
    host = {k: v.cpu().numpy() for k, v in ddf.columns.items()}
    for k, vocab in getattr(ddf, "vocabs", {}).items():
        if k in host:  # write decoded strings, not int32 codes
            host[k] = vocab.decode(host[k])
    for i, w in enumerate(range(ddf.ctx.workers.lo, ddf.ctx.workers.hi)):
        path = os.path.join(directory, f"{prefix}-{w:05d}.csv")
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(names)
            for r in range(counts[i]):
                wr.writerow([host[k][i, r] for k in names])
        paths.append(path)
    return paths
