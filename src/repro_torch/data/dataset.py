"""Chunked columnar on-disk dataset format (the streaming engine's storage).

The reference's ``repro.data.dataset`` line for line (numpy only): a dataset
written by either package opens and reads identically in the other.

A *dataset* is a directory of fixed-row-count column chunks plus a JSON
manifest recording the schema and per-chunk row counts:

    dir/
      manifest.json        {"version": 1, "schema": [...], "chunks": [...],
                            "stats": {...}}   # stats optional
      chunk-00000.npz      one compressed array per column
      chunk-00001.npz
      ...

The manifest gives the streaming runner (``repro_torch.stream``) everything it
needs to slice the dataset into cost-model-sized batches without touching
the data: exact global row count, per-chunk offsets, and the schema (so
row width — and therefore batch sizing — is known up front). Chunks are
``.npz`` archives, so reading a *projection* of the columns only
decompresses the requested members — the on-disk half of the planner's
projection pushdown into ``SCAN``.

CSV ingestion (:func:`csv_to_dataset`, :func:`iter_csv_chunks`) parses
``chunk_rows`` rows at a time into typed columns — replacing the old
row-at-a-time ``DictReader`` path that materialized whole files as Python
dicts before the first numpy array existed.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np

from ..core.vocab import DICT_DTYPE, DictVocab, encode_strings, storage_dtype

__all__ = [
    "DatasetManifest",
    "DatasetWriter",
    "DatasetSchemaError",
    "write_dataset",
    "open_dataset",
    "read_chunk",
    "read_rows",
    "csv_to_dataset",
    "iter_csv_chunks",
    "normalize_schema",
    "DEFAULT_CHUNK_ROWS",
]

DEFAULT_CHUNK_ROWS = 65536
_MANIFEST_NAME = "manifest.json"
_VERSION = 1
#: reserved npz member prefix carrying a dict column's per-chunk vocab
_VOCAB_MEMBER = "__vocab__"


class DatasetSchemaError(ValueError):
    """A CSV cell (or appended array) cannot be parsed as its schema dtype.

    Raised with the offending column *named* — the actionable replacement
    for the raw ``ValueError`` numpy's float conversion used to surface on
    non-numeric cells. String-valued columns belong in the dict-encoded
    path: declare them with dtype ``"dict"``."""


def _dtype_name(d) -> str:
    """Canonical dtype string for a schema entry.

    ``"dict"`` passes through (it is not a numpy dtype — codes are stored
    as int32, the vocab rides in the manifest); numpy string dtypes
    (kind U/S) normalize *to* ``"dict"`` so schema inference from string
    arrays lands in the dict-encoded path automatically."""
    if isinstance(d, str) and d == DICT_DTYPE:
        return DICT_DTYPE
    dt = np.dtype(d)
    if dt.kind in ("U", "S"):
        return DICT_DTYPE
    return dt.name


def normalize_schema(schema) -> tuple:
    """Canonical schema tuple ``((name, dtype_str, trailing_shape), ...)``
    sorted by name — the same convention ``repro_torch.plan.logical`` uses.

    Accepts a ``{name: dtype}`` mapping (scalar columns), an iterable of
    ``(name, dtype, tail)`` triples, or an already-normalized tuple. The
    dtype ``"dict"`` (or any numpy string dtype, which normalizes to it)
    marks a dict-encoded string column — int32 codes on disk/device plus a
    manifest-level vocabulary (see docs/TYPES.md).
    """
    if isinstance(schema, Mapping):
        items = [(str(n), _dtype_name(d), ()) for n, d in schema.items()]
    else:
        items = []
        for entry in schema:
            name, dt = entry[0], entry[1]
            tail = tuple(int(x) for x in (entry[2] if len(entry) > 2 else ()))
            items.append((str(name), _dtype_name(dt), tail))
    return tuple(sorted(items))


@dataclasses.dataclass(frozen=True)
class DatasetManifest:
    """Host-side handle on a chunked dataset: directory + schema + chunks.

    ``schema`` is a normalized ``((name, dtype, tail), ...)`` tuple;
    ``chunks`` is ``((filename, rows), ...)`` in on-disk row order. The
    manifest is immutable and hashable so plan nodes / cache keys can
    reference it indirectly via its source id.
    """

    directory: str
    schema: tuple
    chunks: tuple
    #: optional per-chunk ``repro_torch.stats.sketch.ChunkStats`` tuple aligned
    #: with ``chunks`` (None when the dataset carries no sketches); rides
    #: outside cache/checkpoint identity, which hashes schema+chunks only
    stats: tuple | None = None
    #: KMV sketch size the stats were computed with
    stats_k: int = 128
    #: merged vocabularies of the dict-encoded columns:
    #: ``((name, (word, ...)), ...)`` sorted by name. Chunk files carry
    #: their own (smaller) per-chunk vocabs; ``read_chunk`` remaps codes
    #: into this manifest-level space so every decoded batch shares one
    #: code space per column.
    vocabs: tuple = ()

    @property
    def num_rows(self) -> int:
        """Exact global row count (sum of per-chunk counts)."""
        return int(sum(r for _, r in self.chunks))

    @property
    def column_names(self) -> tuple:
        return tuple(n for n, _, _ in self.schema)

    @property
    def vocab_map(self) -> dict:
        """Dict-column vocabularies as ``{name: DictVocab}``."""
        return {n: DictVocab(tuple(words)) for n, words in self.vocabs}

    def row_bytes(self) -> float:
        """Bytes per row implied by the schema (drives batch sizing);
        dict columns count their int32 storage width."""
        total = 0.0
        for _, dt, tail in self.schema:
            size = np.dtype(storage_dtype(dt)).itemsize
            total += size * float(np.prod(tail)) if tail else size
        return max(total, 1.0)

    def save(self) -> str:
        """Write ``manifest.json`` into the dataset directory (atomically:
        tmp file + rename, so a crash mid-save leaves the old manifest —
        the contract :func:`repro_torch.stats.sketch.backfill_stats` relies on).
        Per-chunk sketches, when present, serialize under an optional
        versioned ``stats`` key that pre-stats readers never see."""
        path = os.path.join(self.directory, _MANIFEST_NAME)
        payload = {
            "version": _VERSION,
            "schema": [[n, dt, list(tail)] for n, dt, tail in self.schema],
            "chunks": [[f, int(r)] for f, r in self.chunks],
        }
        if self.stats is not None:
            from ..stats.sketch import STATS_VERSION  # local: avoid cycle
            payload["stats"] = {
                "stats_version": STATS_VERSION,
                "k": int(self.stats_k),
                "chunks": [cs.to_json() for cs in self.stats],
            }
        if self.vocabs:
            payload["vocabs"] = {n: list(words) for n, words in self.vocabs}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, directory: str) -> "DatasetManifest":
        """Read ``manifest.json`` from ``directory``. The optional
        ``stats`` key is parsed when present with a known version and
        silently ignored otherwise — old manifests (and future stats
        formats) load as stats-free datasets, never errors."""
        path = os.path.join(directory, _MANIFEST_NAME)
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != _VERSION:
            raise ValueError(
                f"{path}: unsupported dataset version {payload.get('version')!r}")
        schema = tuple((n, dt, tuple(tail)) for n, dt, tail in payload["schema"])
        chunks = tuple((f, int(r)) for f, r in payload["chunks"])
        stats = None
        stats_k = 128
        raw = payload.get("stats")
        if isinstance(raw, dict):
            from ..stats.sketch import (  # local: avoid import cycle
                STATS_VERSION, ChunkStats, DEFAULT_KMV_K)
            if (raw.get("stats_version") == STATS_VERSION
                    and len(raw.get("chunks", ())) == len(chunks)):
                stats_k = int(raw.get("k", DEFAULT_KMV_K))
                stats = tuple(ChunkStats.from_json(c, stats_k)
                              for c in raw["chunks"])
        vocabs = tuple(sorted(
            (str(n), tuple(str(w) for w in words))
            for n, words in (payload.get("vocabs") or {}).items()))
        return cls(directory, schema, chunks, stats=stats, stats_k=stats_k,
                   vocabs=vocabs)


class DatasetWriter:
    """Incremental chunk writer: append column batches, get a manifest back.

    Buffers appended rows and flushes a ``chunk-NNNNN.npz`` every
    ``chunk_rows`` rows; :meth:`close` flushes the remainder and writes the
    manifest. Used by :func:`write_dataset`, CSV ingestion, and the
    streaming runner's host-side spill (spilled runs *are* datasets).

    With ``stats=True`` (the default) every flushed chunk is sketched
    in-memory (``repro_torch.stats.sketch.ChunkStats``: count, per-column
    min/max, KMV distinct) and the sketches ride into the manifest —
    write-time stats cost one pass over data already in cache. Spill
    writers pass ``stats=False``: spill runs are consumed once, in full.

    ``write=False`` keeps the writer's state, chunk list and manifest but
    writes nothing: a rank of a process group whose spill files another
    rank writes, from the same rows (no two ranks write one file).
    """

    def __init__(self, directory: str, schema=None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS, compress: bool = True,
                 stats: bool = True, stats_k: int = 128, write: bool = True):
        self.write = bool(write)
        if self.write:
            os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.chunk_rows = max(int(chunk_rows), 1)
        self.compress = compress
        self._schema = normalize_schema(schema) if schema is not None else None
        self._buffers: list[dict] = []
        self._buffered = 0
        self._chunks: list[tuple] = []
        self._closed = False
        self.stats_enabled = bool(stats)
        self.stats_k = int(stats_k)
        self._stats: list = []

    @property
    def rows_written(self) -> int:
        return int(sum(r for _, r in self._chunks)) + self._buffered

    def state(self) -> tuple[tuple, dict]:
        """Crash-consistent snapshot: ``(flushed chunks, buffered rows)``.

        The flushed chunks are already durable on disk; the buffered
        remainder (always < ``chunk_rows`` — append flushes eagerly) is
        returned as a column dict for the caller to persist. Together with
        the directory/schema this is everything :meth:`resume` needs."""
        if self._buffers:
            buffered = {n: np.concatenate([b[n] for b in self._buffers])
                        for n, _, _ in self._schema}
        else:
            buffered = {}
        return tuple(self._chunks), buffered

    @classmethod
    def resume(cls, directory: str, schema, chunks,
               buffered: Mapping[str, np.ndarray] | None = None,
               chunk_rows: int = DEFAULT_CHUNK_ROWS,
               compress: bool = True, write: bool = True) -> "DatasetWriter":
        """Rebuild a writer from a :meth:`state` snapshot.

        ``chunks`` are trusted as-is (their files are on disk); chunk files
        written *after* the snapshot are simply overwritten by index as the
        resumed stream re-appends, and never referenced by the final
        manifest — torn post-snapshot writes cannot corrupt the dataset.
        Resumed writers close without stats (sketches for the pre-snapshot
        chunks were lost with the crashed process; :func:`backfill_stats`
        recomputes them on demand)."""
        w = cls(directory, schema=schema, chunk_rows=chunk_rows,
                compress=compress, stats=False, write=write)
        w._chunks = [(f, int(r)) for f, r in chunks]
        if buffered and len(next(iter(buffered.values()))):
            w.append(buffered)
        return w

    def append(self, columns: Mapping[str, np.ndarray]) -> None:
        """Append a batch of rows (same-length arrays keyed by name)."""
        if self._closed:
            raise ValueError("DatasetWriter is closed")
        cols = {k: np.asarray(v) for k, v in columns.items()}
        if self._schema is None:
            self._schema = normalize_schema(
                [(k, v.dtype, v.shape[1:]) for k, v in cols.items()])
        names = set(n for n, _, _ in self._schema)
        if set(cols) != names:
            raise ValueError(f"append: columns {sorted(cols)} do not match "
                             f"schema {sorted(names)}")
        lengths = {len(v) for v in cols.values()}
        if len(lengths) != 1:
            raise ValueError(f"append: column lengths disagree: {lengths}")
        for cn, dt, _ in self._schema:
            if dt == DICT_DTYPE and cols[cn].dtype.kind not in ("U", "S", "O"):
                raise DatasetSchemaError(
                    f"append: column {cn!r} is dict-encoded (string) but got "
                    f"a {cols[cn].dtype} array — dict columns take decoded "
                    "string values; codes are assigned at flush time")
        n = lengths.pop()
        if n == 0:
            return
        self._buffers.append(cols)
        self._buffered += n
        while self._buffered >= self.chunk_rows:
            self._flush(self.chunk_rows)

    def _flush(self, rows: int) -> None:
        if rows <= 0 or self._buffered == 0:
            return
        # one buffer is sliced, not re-concatenated: the reference copies the
        # whole remainder on every flush, quadratic in the rows of one large
        # append (1.6 GB written in ~290 s); the files are the same. A
        # remainder shorter than a chunk is copied, so no view of the
        # caller's arrays outlives append().
        if len(self._buffers) == 1:
            merged = self._buffers[0]
        else:
            merged = {n: np.concatenate([b[n] for b in self._buffers])
                      for n, _, _ in self._schema}
        head = {k: v[:rows] for k, v in merged.items()}
        tail = {k: v[rows:] for k, v in merged.items()}
        if self._buffered - rows < self.chunk_rows:
            tail = {k: v.copy() for k, v in tail.items()}
        fname = f"chunk-{len(self._chunks):05d}.npz"
        # dict columns flush as int32 codes + a per-chunk sorted vocab under
        # the reserved __vocab__<name> member; read_chunk remaps the codes
        # into the manifest-level merged vocab space. Sketches see the
        # *decoded* strings so min/max bounds and KMV distinct stay in value
        # space (chunk skipping on string predicates).
        if self.write:
            payload = dict(head)
            for n, dt, _ in self._schema:
                if dt == DICT_DTYPE:
                    codes, cv = encode_strings(head[n])
                    payload[n] = codes
                    payload[_VOCAB_MEMBER + n] = cv.values
            save = np.savez_compressed if self.compress else np.savez
            save(os.path.join(self.directory, fname), **payload)
        if self.stats_enabled:
            from ..stats.sketch import ChunkStats  # local: avoid cycle
            self._stats.append(ChunkStats.from_columns(head, self.stats_k))
        self._chunks.append((fname, rows))
        self._buffered -= rows
        self._buffers = [tail] if self._buffered else []

    def close(self) -> DatasetManifest:
        """Flush the buffered remainder and write the manifest."""
        if self._closed:
            return self._manifest
        if self._buffered:
            self._flush(self._buffered)
        if self._schema is None:
            raise ValueError("cannot close an empty DatasetWriter without a "
                             "schema (pass schema= at construction)")
        self._closed = True
        # resumed writers lack sketches for pre-snapshot chunks: only a
        # complete per-chunk set is trustworthy, else drop stats entirely
        # (consumers treat "no stats" as "no estimates"; backfill_stats
        # can recompute later)
        stats = (tuple(self._stats)
                 if self.stats_enabled and len(self._stats) == len(self._chunks)
                 else None)
        self._manifest = DatasetManifest(self.directory, self._schema,
                                         tuple(self._chunks), stats=stats,
                                         stats_k=self.stats_k,
                                         vocabs=self._merged_vocabs())
        if self.write:
            self._manifest.save()
        return self._manifest

    def _merged_vocabs(self) -> tuple:
        """Manifest-level vocabs: the sorted union of every flushed chunk's
        per-chunk vocab, read back from disk (robust to :meth:`resume` —
        pre-snapshot chunk vocabs live in their files, not this process)."""
        dict_cols = [n for n, dt, _ in self._schema if dt == DICT_DTYPE]
        if not dict_cols:
            return ()
        if not self.write:
            raise ValueError("a DatasetWriter with write=False cannot merge the "
                             "vocabularies of dict columns: they live in the files")
        acc = {n: DictVocab(()) for n in dict_cols}
        for fname, _ in self._chunks:
            with np.load(os.path.join(self.directory, fname)) as z:
                for n in dict_cols:
                    acc[n] = acc[n].merge(
                        DictVocab(tuple(z[_VOCAB_MEMBER + n])))
        return tuple(sorted((n, acc[n].words) for n in dict_cols))


def write_dataset(data: Mapping[str, np.ndarray], directory: str,
                  chunk_rows: int = DEFAULT_CHUNK_ROWS,
                  compress: bool = True) -> DatasetManifest:
    """Write an in-memory column dict as a chunked dataset; returns its
    manifest. The inverse of reading every row with :func:`read_rows`."""
    w = DatasetWriter(directory, chunk_rows=chunk_rows, compress=compress)
    w.append(data)
    if w._schema is None:  # zero-row input still needs a schema
        w._schema = normalize_schema(
            [(k, np.asarray(v).dtype, np.asarray(v).shape[1:])
             for k, v in data.items()])
    return w.close()


def open_dataset(directory: str) -> DatasetManifest:
    """Load the manifest of a chunked dataset directory."""
    return DatasetManifest.load(directory)


def read_chunk(manifest: DatasetManifest, index: int,
               columns: Sequence[str] | None = None) -> dict:
    """Decode one chunk (optionally a column projection — only the requested
    ``.npz`` members are decompressed). Dict-encoded columns come back as
    int32 codes remapped from the chunk's own vocab into the manifest-level
    merged vocab (a monotone ``np.searchsorted`` gather), so all chunks of
    one dataset share one code space per column."""
    fname, rows = manifest.chunks[index]
    names = tuple(columns) if columns is not None else manifest.column_names
    unknown = [n for n in names if n not in manifest.column_names]
    if unknown:
        raise KeyError(f"read_chunk: unknown column(s) {unknown}; "
                       f"schema: {list(manifest.column_names)}")
    dict_cols = {n for n, dt, _ in manifest.schema if dt == DICT_DTYPE}
    vocabs = manifest.vocab_map if dict_cols & set(names) else {}
    with np.load(os.path.join(manifest.directory, fname)) as z:
        out = {}
        for n in names:
            v = z[n]
            if n in dict_cols and n in vocabs:
                chunk_vocab = DictVocab(tuple(z[_VOCAB_MEMBER + n]))
                remap = chunk_vocab.recode_map(vocabs[n])
                v = (remap[v] if len(remap)
                     else np.zeros_like(v)).astype(np.int32)
            out[n] = v
    for n, v in out.items():
        if len(v) != rows:
            raise ValueError(f"{fname}: column {n!r} has {len(v)} rows, "
                             f"manifest says {rows} (corrupt dataset)")
    return out


def read_rows(manifest: DatasetManifest, start: int, stop: int,
              columns: Sequence[str] | None = None,
              skip_chunks: Sequence[bool] | None = None) -> dict:
    """Global row range ``[start, stop)`` as a column dict, decoding only
    the chunks that overlap the range (the runner's batch reader).

    ``skip_chunks`` (aligned with ``manifest.chunks``) marks chunks whose
    decode may be elided — the statistics layer's chunk-skip mask, where
    True means the chunk provably contributes no rows to the caller's
    predicate. Skipped chunks contribute zero rows (the result simply
    gets shorter); global row offsets are unaffected."""
    names = tuple(columns) if columns is not None else manifest.column_names
    dtypes = {n: (dt, tail) for n, dt, tail in manifest.schema}
    start, stop = max(int(start), 0), max(int(stop), 0)
    parts: dict[str, list] = {n: [] for n in names}
    off = 0
    for i, (_, rows) in enumerate(manifest.chunks):
        lo, hi = max(start, off), min(stop, off + rows)
        if lo < hi and not (skip_chunks is not None and skip_chunks[i]):
            chunk = read_chunk(manifest, i, names)
            for n in names:
                parts[n].append(chunk[n][lo - off:hi - off])
        off += rows
        if off >= stop:
            break
    out = {}
    for n in names:
        dt, tail = dtypes[n]
        out[n] = (np.concatenate(parts[n]) if parts[n]
                  else np.zeros((0,) + tuple(tail),
                                dtype=np.dtype(storage_dtype(dt))))
    return out


# -- CSV ingestion -------------------------------------------------------------

def iter_csv_chunks(path: str, schema, chunk_rows: int = DEFAULT_CHUNK_ROWS
                    ) -> Iterator[dict]:
    """Stream a CSV file as typed column chunks of ``chunk_rows`` rows.

    Parses with ``csv.reader`` and converts column-wise per chunk — never
    materializing the whole file (the old ``DictReader`` path built one
    Python dict per row for the entire file before any array existed).
    Raises ``ValueError`` when the header is missing a schema column; a
    zero-byte file yields no chunks (an empty shard, not an error —
    matching the partitioned-I/O empty-partition semantics).
    """
    schema_t = normalize_schema(schema)
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            return  # zero-byte shard: no header, no rows, no chunks
        missing = [n for n, _, _ in schema_t if n not in header]
        if missing:
            raise ValueError(
                f"{path}: CSV header {header} is missing schema column(s) "
                f"{missing} — schema mismatch")
        idx = {n: header.index(n) for n, _, _ in schema_t}
        rows: list = []
        for row in reader:
            rows.append(row)
            if len(rows) >= chunk_rows:
                yield _typed_chunk(rows, schema_t, idx)
                rows = []
        if rows:
            yield _typed_chunk(rows, schema_t, idx)


def _typed_chunk(rows: list, schema_t: tuple, idx: dict) -> dict:
    out = {}
    for n, dt, _tail in schema_t:
        col = [r[idx[n]] for r in rows]
        if dt == DICT_DTYPE:
            # string columns route into the dict-encoded path: kept as
            # decoded strings here, code-assigned by the DatasetWriter
            out[n] = np.asarray(col, dtype=np.str_)
            continue
        try:
            out[n] = np.asarray(col, dtype=np.dtype(dt))
        except ValueError as exc:
            bad = next((c for c in col if not _parses_as(c, dt)), col[0])
            raise DatasetSchemaError(
                f"column {n!r}: CSV value {bad!r} cannot be parsed as "
                f"{dt} — declare the column as 'dict' to ingest strings "
                f"(dict-encoded), or fix the schema dtype") from exc
    return out


def _parses_as(cell: str, dt: str) -> bool:
    try:
        np.asarray([cell], dtype=np.dtype(dt))
        return True
    except ValueError:
        return False


def csv_to_dataset(files: Iterable[str], schema, directory: str,
                   chunk_rows: int = DEFAULT_CHUNK_ROWS,
                   compress: bool = True) -> DatasetManifest:
    """Chunked CSV ingestion: convert CSV files into a chunked dataset.

    Files are read in order, ``chunk_rows`` rows at a time; the resulting
    dataset concatenates them in file order. Header/schema mismatches raise
    ``ValueError`` naming the offending file and columns.
    """
    w = DatasetWriter(directory, schema=schema, chunk_rows=chunk_rows,
                      compress=compress)
    for path in files:
        for chunk in iter_csv_chunks(path, schema, chunk_rows):
            w.append(chunk)
    return w.close()
