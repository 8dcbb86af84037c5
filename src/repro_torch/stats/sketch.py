"""Per-chunk dataset sketches: row counts, min/max bounds, KMV distinct.

The reference's ``repro.stats.sketch`` line for line (numpy only): the
sketches are serialized into the manifest, so both packages must write the
same bits.

The write-time half of the statistics subsystem. Every chunk a
``DatasetWriter`` flushes gets one :class:`ChunkStats` — the exact row
count, per-column min/max bounds, and a k-minimum-values (KMV) sketch of
each column's distinct hashes — serialized into the dataset's JSON
manifest under an optional, versioned ``stats`` key (old manifests load
unchanged; unknown future stats versions are ignored, never fatal).

Sketches are **mergeable**: chunk sketches roll up to dataset sketches
with :func:`merge_chunk_stats` (min/max combine conservatively, KMV sets
union and re-truncate to the k smallest), so every downstream consumer —
chunk skipping, selectivity estimation, key-cardinality estimation
(``repro_torch.stats.estimate``) — works at either granularity.

Conservatism contract: a column whose min/max cannot be trusted for
pruning (non-scalar tail, or non-finite values — NaN compares unordered,
so ``~(col > 0)`` keeps NaN rows) stores ``None`` bounds, which every
consumer treats as "unknown, do not prune". The KMV hash is the same
lowbias32 / boost-combine family the engine's device shuffle
(``partition.hash32``) and host spill bucketing use, so distinct
estimates describe exactly the key space the shuffle partitions on.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "ColumnStats",
    "ChunkStats",
    "merge_chunk_stats",
    "hash32",
    "DEFAULT_KMV_K",
    "STATS_VERSION",
    "backfill_stats",
]

#: KMV sketch size: distinct-count error ~ 1/sqrt(k-2) (~9% at 128) for a
#: few hundred bytes per column per chunk in the JSON manifest.
DEFAULT_KMV_K = 128

#: version of the ``stats`` manifest payload this module writes/parses
STATS_VERSION = 1

_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)
_HASH_SPACE = float(2**32)


def hash32(col: np.ndarray) -> np.ndarray:
    """lowbias32 over a column, mirroring ``partition.hash32`` bit-for-bit.

    int64/uint64 fold-xor their high word, bools widen to uint32, floats go
    through a float32 bitcast — the same normalization the device shuffle
    and the runner's host spill bucketing apply, so KMV distinct estimates
    are statements about the very hash space keys are partitioned in."""
    x = np.asarray(col)
    if x.dtype.kind in ("U", "S"):
        # decoded dict-column values: a stable per-string hash (crc32)
        # seeds the same lowbias finalizer. Distinct strings == distinct
        # codes, so KMV over decoded values estimates exactly the key
        # cardinality the code-space shuffle partitions on.
        import zlib
        x = np.fromiter((zlib.crc32(str(s).encode("utf-8")) for s in x.ravel()),
                        dtype=np.uint32, count=x.size)
    elif x.dtype in (np.int64, np.uint64):
        u = x.astype(np.uint64)
        x = (u ^ (u >> np.uint64(32))).astype(np.uint32)
    elif x.dtype == np.bool_:
        x = x.astype(np.uint32)
    elif np.issubdtype(x.dtype, np.floating):
        x = np.ascontiguousarray(x.astype(np.float32)).view(np.uint32)
    else:
        x = x.astype(np.uint32)
    # every branch above made a fresh uint32 array: finalize it in place,
    # with one scratch buffer (a chunk's sketch then allocates two arrays,
    # not ten: on hosts where page faults are slow, fresh pages dominate)
    t = np.empty_like(x)
    with np.errstate(over="ignore"):
        for shift, mult in ((16, _M1), (15, _M2)):
            np.bitwise_xor(x, np.right_shift(x, np.uint32(shift), out=t), out=x)
            np.multiply(x, mult, out=x)
        np.bitwise_xor(x, np.right_shift(x, np.uint32(16), out=t), out=x)
    return x


def _scalar(v):
    """Native Python scalar (JSON-exact for int64) or None for non-finite."""
    v = v.item() if hasattr(v, "item") else v
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """Sketch of one scalar column over some row set.

    ``min``/``max`` are native Python scalars, or ``None`` when bounds are
    unusable for pruning (empty column, or non-finite values present —
    NaN rows pass negated predicates, so pruning on a NaN-polluted bound
    would drop matching rows). ``kmv`` holds the k smallest distinct
    lowbias32 hashes (sorted tuple); :meth:`distinct` turns it into a
    distinct-count estimate, exact while fewer than ``k`` hashes exist.
    """

    min: object
    max: object
    kmv: tuple
    k: int = DEFAULT_KMV_K

    @classmethod
    def from_array(cls, arr: np.ndarray, k: int = DEFAULT_KMV_K
                   ) -> "ColumnStats":
        """Sketch one 1-D column array."""
        arr = np.asarray(arr)
        if arr.size == 0:
            return cls(None, None, (), k)
        if arr.dtype.kind in ("U", "S"):
            # decoded dict-column strings: bounds in value space (JSON
            # strings), so chunk skipping can compare string predicates
            u = np.unique(arr.astype(np.str_))
            lo, hi = str(u[0]), str(u[-1])
        else:
            lo, hi = _scalar(arr.min()), _scalar(arr.max())
            if lo is None or hi is None:
                lo = hi = None  # non-finite somewhere: bounds unusable
        hashes = hash32(arr).ravel()
        hashes.sort()
        # the k smallest distinct hashes are those of a sorted prefix
        # holding k distinct values: grow the prefix instead of
        # deduplicating the whole column
        m = min(len(hashes), 4 * k)
        while True:
            smallest = np.unique(hashes[:m])
            if len(smallest) >= k or m == len(hashes):
                break
            m = min(len(hashes), 4 * m)
        kmv = tuple(int(h) for h in smallest[:k])
        return cls(lo, hi, kmv, k)

    def distinct(self) -> float:
        """Distinct-value estimate: exact below ``k``, else the KMV
        estimator ``(k-1) / (kth smallest hash / 2^32)``."""
        if len(self.kmv) < self.k:
            return float(len(self.kmv))
        kth = self.kmv[self.k - 1]
        return (self.k - 1) / ((kth + 1) / _HASH_SPACE)

    def merge(self, other: "ColumnStats") -> "ColumnStats":
        """Combine two sketches of disjoint row sets (conservative: an
        unknown bound on either side stays unknown)."""
        k = min(self.k, other.k)
        lo = None if self.min is None or other.min is None \
            else min(self.min, other.min)
        hi = None if self.max is None or other.max is None \
            else max(self.max, other.max)
        kmv = tuple(sorted(set(self.kmv) | set(other.kmv))[:k])
        return ColumnStats(lo, hi, kmv, k)

    def to_json(self) -> dict:
        """JSON payload for the manifest ``stats`` key."""
        return {"min": self.min, "max": self.max, "kmv": list(self.kmv)}

    @classmethod
    def from_json(cls, d: Mapping, k: int = DEFAULT_KMV_K) -> "ColumnStats":
        """Inverse of :meth:`to_json` (``k`` rides at the stats top level)."""
        return cls(d.get("min"), d.get("max"),
                   tuple(int(h) for h in d.get("kmv", ())), k)


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """Sketch of one dataset chunk: row count + per-column sketches.

    ``columns`` is a name-sorted tuple of ``(name, ColumnStats)`` covering
    scalar (no trailing shape) columns only — vector columns have no
    order/pruning semantics. Frozen and hashable, so a tuple of these can
    ride on the (hashable) ``DatasetManifest``.
    """

    count: int
    columns: tuple

    @classmethod
    def from_columns(cls, cols: Mapping[str, np.ndarray],
                     k: int = DEFAULT_KMV_K) -> "ChunkStats":
        """Sketch one chunk's column dict (scalar columns only)."""
        count = len(next(iter(cols.values()))) if cols else 0
        out = []
        for name in sorted(cols):
            arr = np.asarray(cols[name])
            if arr.ndim != 1:
                continue
            out.append((name, ColumnStats.from_array(arr, k)))
        return cls(int(count), tuple(out))

    def column(self, name: str) -> ColumnStats | None:
        """The named column's sketch, or None when not sketched."""
        for n, cs in self.columns:
            if n == name:
                return cs
        return None

    def merge(self, other: "ChunkStats") -> "ChunkStats":
        """Roll two chunk sketches up into one (shared columns only)."""
        mine = dict(self.columns)
        theirs = dict(other.columns)
        cols = tuple((n, mine[n].merge(theirs[n]))
                     for n in sorted(set(mine) & set(theirs)))
        return ChunkStats(self.count + other.count, cols)

    def to_json(self) -> dict:
        """JSON payload for one entry of the manifest's stats chunk list."""
        return {"count": self.count,
                "columns": {n: cs.to_json() for n, cs in self.columns}}

    @classmethod
    def from_json(cls, d: Mapping, k: int = DEFAULT_KMV_K) -> "ChunkStats":
        """Inverse of :meth:`to_json`."""
        cols = tuple(sorted(
            (n, ColumnStats.from_json(c, k))
            for n, c in d.get("columns", {}).items()))
        return cls(int(d.get("count", 0)), cols)


def merge_chunk_stats(stats: Sequence[ChunkStats]) -> ChunkStats:
    """Roll per-chunk sketches up to one dataset-level sketch."""
    stats = list(stats)
    if not stats:
        return ChunkStats(0, ())
    out = stats[0]
    for s in stats[1:]:
        out = out.merge(s)
    return out


def backfill_stats(directory: str, k: int = DEFAULT_KMV_K,
                   force: bool = False):
    """Compute sketches for an existing dataset and rewrite its manifest
    in place (atomically — tmp file + rename, crash leaves the old
    manifest intact). Datasets that already carry stats are left untouched
    unless ``force=True``. Returns the (re-)loaded ``DatasetManifest``.

    This is the migration path for datasets written before the statistics
    subsystem (or with ``stats=False``): one pass decoding each chunk,
    identical results to write-time sketching."""
    from ..data.dataset import DatasetManifest, read_chunk  # no import cycle

    man = DatasetManifest.load(directory)
    if man.stats is not None and not force:
        return man
    vocabs = man.vocab_map

    def decoded(i: int) -> dict:
        # dict columns come back as codes; sketch the decoded strings so
        # backfilled stats match write-time stats exactly
        cols = read_chunk(man, i)
        return {n: (vocabs[n].decode(v) if n in vocabs else v)
                for n, v in cols.items()}

    stats = tuple(
        ChunkStats.from_columns(decoded(i), k)
        for i in range(len(man.chunks)))
    dataclasses.replace(man, stats=stats, stats_k=k).save()
    return DatasetManifest.load(directory)
