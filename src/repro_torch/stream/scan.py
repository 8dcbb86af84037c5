"""SCAN builders: open chunked datasets (or CSV files) as lazy pipelines.

``scan_dataset`` wraps a ``DatasetManifest`` as a ``LazyDDF`` whose leaf is
a ``SCAN`` plan node; ``scan_csv`` first ingests CSV files into a chunked
dataset (``data.dataset.csv_to_dataset`` — chunked columnar parsing, never
the whole file at once) and then scans it. Neither touches the card: the
batch capacity recorded on the ``SCAN`` node comes from the card's cost
model (``choose_batch_rows`` with ``params_for_fabric``) using only the
manifest's schema and row count. The reference's ``repro.stream.scan``.

Over a process group every rank scans the same dataset directory, and the
batch capacity depends only on the manifest and the global P, so every
rank cuts the same batches. ``scan_csv`` converts on rank 0 alone; the
other ranks open the result once it is whole, and a group whose ranks
cannot see it raises on every rank.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Mapping

import torch

from .. import expr as _expr
from ..core import cost_model
from ..core.api import DDFContext
from ..core.vocab import storage_schema
from ..data.dataset import (
    DEFAULT_CHUNK_ROWS,
    DatasetManifest,
    csv_to_dataset,
    open_dataset,
)
from ..plan import frame as _frame
from ..plan.logical import Scan, Select, schema_names

__all__ = ["scan_dataset", "scan_csv"]


def _batch_capacity(manifest: DatasetManifest, ctx: DDFContext,
                    batch_rows: int | None,
                    memory_budget_bytes: float | None) -> int:
    P = ctx.nworkers
    if batch_rows is None:
        kw = {}
        if memory_budget_bytes is not None:
            kw["memory_budget_bytes"] = memory_budget_bytes
        batch_rows = cost_model.choose_batch_rows(
            P, manifest.row_bytes(),
            cost_model.params_for_fabric(),
            total_rows=max(manifest.num_rows, 1), **kw)
    return max(-(-int(batch_rows) // P), 1)


def scan_dataset(dataset, ctx: DDFContext, batch_rows: int | None = None,
                 memory_budget_bytes: float | None = None,
                 columns: Iterable[str] | None = None,
                 predicate=None) -> "_frame.LazyDDF":
    """Open a chunked dataset as a lazy out-of-core pipeline source.

    Args:
      dataset: a ``DatasetManifest`` or a dataset directory path.
      ctx: execution environment (P workers on one device or over a
        group, whose ranks all see the dataset's directory).
      batch_rows: global rows per streamed batch; default from
        ``cost_model.choose_batch_rows`` (memory ceiling vs per-batch
        dispatch-overhead amortization).
      memory_budget_bytes: per-device batch working-set budget forwarded to
        the batch-sizing model when ``batch_rows`` is not pinned.
      columns: projection pushed straight into the scan — only these
        ``.npz`` members are decoded per batch (same effect as a
        ``.project()`` the optimizer would absorb).
      predicate: a ``repro_torch.expr`` boolean expression — exactly equivalent
        to chaining ``.select(predicate)``. Host-portable predicates
        (``repro_torch.expr.host_portable``) are absorbed into the scan and
        evaluated host-side on each decoded chunk *before* rows are
        admitted to the device (referenced columns outside ``columns`` are
        decoded transiently and dropped after filtering); non-portable
        ones (float arithmetic, 64-bit columns) become a device SELECT
        above the scan so results never diverge from the eager path.
        When the dataset manifest carries per-chunk sketches
        (``repro_torch.stats``, the write-time default), absorbed predicates
        additionally drive *chunk skipping*: chunks whose min/max bounds
        prove zero matching rows are never decoded at all.

    Returns:
      A ``LazyDDF`` whose plan root is a ``SCAN`` leaf. Terminal calls
      route through the streaming engine (``collect_stream``/``to_batches``).
    """
    manifest = dataset if isinstance(dataset, DatasetManifest) \
        else open_dataset(str(dataset))
    cap = _batch_capacity(manifest, ctx, batch_rows, memory_budget_bytes)
    sid = next(_frame._SIDS)
    # the plan/device layers only ever see the STORAGE schema: dict-encoded
    # string columns appear as their int32 code columns, with the vocab
    # riding on the LazyDDF as host metadata
    vocabs = manifest.vocab_map
    stored = storage_schema(manifest.schema)
    have = schema_names(manifest.schema)
    cols = None
    if columns is not None:
        cols = tuple(sorted(str(c) for c in columns))
        missing = [c for c in cols if c not in have]
        if missing:
            raise KeyError(f"scan: unknown column(s) {missing}; "
                           f"available schema: {sorted(have)}")
    preds = ((), (), ())
    device_pred = None
    if predicate is not None:
        if not (isinstance(predicate, _expr.Expr)
                or _expr.is_when_builder(predicate)):
            raise TypeError(
                "scan predicate must be a repro_torch.expr expression (e.g. "
                "col('v') > 3); for legacy callables chain .select() and "
                "let the optimizer probe it")
        e = _expr.prepare_row_expr(predicate, have, "scan",
                                   vocabs=vocabs or None)
        if _expr.host_portable(e, stored):
            preds = (("pred",), (e,), (_expr.to_numpy_fn(e),))
        else:
            # host numpy would evaluate this differently than the device
            # (float promotion / 64-bit truncation): keep it as a device
            # SELECT so predicate= stays exactly equivalent to .select()
            refs = _expr.referenced_columns(e)
            if cols is not None and not refs <= set(cols):
                raise ValueError(
                    f"scan: predicate {e} is not host-portable (it must "
                    "run on device) but references column(s) "
                    f"{sorted(refs - set(cols))} outside columns={cols}; "
                    "include them in columns= or use a host-portable "
                    "(integer/comparison) predicate")
            device_pred = e
    root = Scan(sid=sid, schema=stored, capacity=cap, columns=cols,
                pred_names=preds[0], pred_sigs=preds[1], pred_fns=preds[2])
    if device_pred is not None:
        root = Select(root, _expr.to_torch_fn(device_pred), "pred",
                      tuple(sorted(_expr.referenced_columns(device_pred))),
                      expr=device_pred)
    return _frame.LazyDDF(root, ctx, {}, scans={sid: manifest},
                          vocabs=vocabs)


def scan_csv(files: Iterable[str], schema: Mapping, ctx: DDFContext,
             directory: str | None = None,
             chunk_rows: int = DEFAULT_CHUNK_ROWS,
             batch_rows: int | None = None,
             memory_budget_bytes: float | None = None,
             columns: Iterable[str] | None = None,
             predicate=None) -> "_frame.LazyDDF":
    """Scan CSV files out-of-core: chunked ingestion + ``scan_dataset``.

    Files are converted once into a chunked dataset under ``directory``
    (a fresh temporary directory when None — pass a path to keep/reuse the
    converted dataset) and scanned from there, so repeated pipelines pay
    CSV parsing once. Header/schema mismatches raise ``ValueError`` at
    ingestion time. Unlike ``read_csv_dist`` nothing is materialized on
    the card here; dataset size is bounded by disk, not device memory.

    Over a group rank 0 converts, into ``directory`` (each rank passes the
    same path) or a temporary directory whose path it sends to the others;
    they open it after it is whole. Every rank raises when rank 0's
    conversion fails or when a rank cannot see the converted dataset.
    """
    if ctx.group is None:
        if directory is None:
            directory = tempfile.mkdtemp(prefix="repro-scan-csv-")
        manifest = csv_to_dataset(files, schema, directory, chunk_rows=chunk_rows)
    else:
        manifest = _convert_on_rank0(files, schema, ctx, directory, chunk_rows)
    return scan_dataset(manifest, ctx, batch_rows=batch_rows,
                        memory_budget_bytes=memory_budget_bytes,
                        columns=columns, predicate=predicate)


def _convert_on_rank0(files, schema, ctx: DDFContext, directory: str | None,
                      chunk_rows: int) -> DatasetManifest:
    """``csv_to_dataset`` on rank 0 of ``ctx``'s group, opened by every rank."""
    blk = ctx.workers
    err, codes = None, []
    if blk.rank == 0:
        try:
            if directory is None:
                directory = tempfile.mkdtemp(prefix="repro-scan-csv-")
            csv_to_dataset(files, schema, directory, chunk_rows=chunk_rows)
        except Exception as e:  # every rank raises, rank 0 with the cause
            err = e
        if err is None and directory is not None:
            codes = list(os.fsencode(directory))
    failed, n = blk.broadcast_ints([err is not None, len(codes)])
    if failed:
        if err is not None:
            raise err
        raise RuntimeError("scan_csv: rank 0 could not convert the CSV files; "
                           "its error names the cause")
    sent = os.fsdecode(bytes(blk.broadcast_ints(codes or [0] * n)))
    if directory is None:
        directory = sent
    try:
        manifest = open_dataset(directory)
    except OSError:
        manifest = None
    seen = blk.gather_workers(torch.full((blk.local,), manifest is not None,
                                         dtype=torch.int32, device=blk.device)).cpu()
    blind = sorted({w // blk.local for w in range(blk.nworkers) if not int(seen[w])})
    if blind:
        raise RuntimeError(
            f"scan_csv: rank(s) {blind} of the group cannot see the dataset that rank 0 "
            f"converted into {sent!r}: the ranks need a directory they all see")
    return manifest
