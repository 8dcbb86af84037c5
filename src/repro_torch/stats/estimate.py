"""Predicate interval evaluation, chunk skipping, and plan estimates.

The read-time half of the statistics subsystem: given the per-chunk
sketches ``repro_torch.stats.sketch`` serialized into a dataset manifest, this
module answers three planner questions —

1. **Which chunks can be skipped?** :func:`chunk_skip_mask` evaluates each
   absorbed scan predicate over per-chunk min/max bounds with interval
   arithmetic. A chunk is skipped only when some conjunct is *provably*
   false for every row the bounds admit — the mask is always a subset of
   the truly-empty chunks, so skipping is bit-identical (a skipped chunk's
   rows would all have been filtered before device admission anyway).
2. **How selective is a scan?** :func:`predicate_selectivity` /
   ``PlanStats.scan_selectivity`` replace the optimizer's fixed
   ``SELECT_SELECTIVITY = 0.5`` per predicate with a per-chunk,
   count-weighted estimate: provably true/false chunks contribute 1/0,
   ``col <op> literal`` chunks contribute the uniform-range fraction
   (equality via the KMV distinct estimate), everything else falls back
   to the fixed ratio.
3. **How many groups will a groupby/unique produce?**
   ``PlanStats.groupby_cardinality`` combines per-key-column KMV distinct
   estimates (capped by the row count) into the cardinality fraction
   ``patterns.plan_groupby`` and ``cost_model`` consume in place of the
   ``UNKNOWN_CARDINALITY`` sentinel.

Everything here is conservative by construction: a missing sketch, an
unknown bound, an unsupported expression shape, or a legacy callable
predicate yields "no estimate", and callers fall back to the fixed
ratios — stats can tighten plans, never corrupt them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Mapping

import numpy as np

from ..core.vocab import DICT_DTYPE
from ..expr.tree import (
    Alias,
    BinOp,
    Cast,
    Col,
    Cond,
    Expr,
    Lit,
    UnaryOp,
)
from ..plan.logical import (
    GroupBy,
    Project,
    Rebalance,
    Recode,
    Scan,
    Select,
    Unique,
    walk,
)
from .sketch import ChunkStats, merge_chunk_stats

__all__ = [
    "Interval",
    "expr_interval",
    "chunk_skip_mask",
    "predicate_selectivity",
    "key_cardinality",
    "scan_row_estimate",
    "PlanStats",
    "plan_stats",
]

_FIXED_SELECTIVITY = 0.5  # mirror of plan.logical.SELECT_SELECTIVITY

#: node types that pass key columns through from a scan unchanged — the
#: transparency condition for trusting scan-level key sketches at a
#: downstream groupby/unique (Rename/WithColumn/MapColumns/Join all may
#: rewrite or multiply keys, so they opt out of estimation). Recode is a
#: per-column injective code remap: it changes code *values* but never the
#: number of distinct keys, which is all the cardinality path consumes.
_KEY_TRANSPARENT = (Scan, Select, Project, Rebalance, Recode)


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed value interval with a boolean tag.

    ``boolish`` marks intervals whose values are boolean 0/1 (comparison
    results, boolean literals/columns): only boolish operands combine
    under ``&``/``|``/``^``/``~``-as-not, keeping logical and bitwise
    integer semantics apart. ``None`` anywhere upstream means "unknown"
    and poisons conservatively.
    """

    lo: float
    hi: float
    boolish: bool = False


_TRUE = Interval(1, 1, True)
_FALSE = Interval(0, 0, True)
_MAYBE = Interval(0, 1, True)


def _widen_f32(lo, hi):
    """Widen bounds past float32 rounding (Cast-to-float can round a bound
    toward the interval's interior; nextafter pushes both ends back out)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return (float(np.nextafter(lo32, -np.inf)),
            float(np.nextafter(hi32, np.inf)))


def _bool_pair(a: Interval, b: Interval, fn) -> Interval:
    vals = {fn(x, y) for x in (int(a.lo), int(a.hi))
            for y in (int(b.lo), int(b.hi))}
    return Interval(min(vals), max(vals), True)


def _cmp(op: str, l: Interval, r: Interval) -> Interval:
    """Comparison over intervals: certainly true / certainly false / maybe."""
    if op == "gt":
        if l.lo > r.hi:
            return _TRUE
        if l.hi <= r.lo:
            return _FALSE
        return _MAYBE
    if op == "ge":
        if l.lo >= r.hi:
            return _TRUE
        if l.hi < r.lo:
            return _FALSE
        return _MAYBE
    if op == "lt":
        return _cmp("gt", r, l)
    if op == "le":
        return _cmp("ge", r, l)
    if op == "eq":
        if l.lo == l.hi == r.lo == r.hi:
            return _TRUE
        if l.hi < r.lo or l.lo > r.hi:
            return _FALSE
        return _MAYBE
    if op == "ne":
        inner = _cmp("eq", l, r)
        return Interval(1 - inner.hi, 1 - inner.lo, True)
    raise KeyError(op)


def _arith(op: str, l: Interval, r: Interval) -> Interval | None:
    if op in ("add", "sub", "mul"):
        if op == "add":
            cands = [l.lo + r.lo, l.hi + r.hi]
        elif op == "sub":
            cands = [l.lo - r.hi, l.hi - r.lo]
        else:
            cands = [x * y for x in (l.lo, l.hi) for y in (r.lo, r.hi)]
        cands = [c for c in cands if not math.isnan(c)]
        if not cands:
            return None
        return Interval(min(cands), max(cands))
    if op in ("truediv", "floordiv"):
        if r.lo <= 0 <= r.hi:
            return None  # divisor range spans 0
        cands = [x / y for x in (l.lo, l.hi) for y in (r.lo, r.hi)]
        lo, hi = min(cands), max(cands)
        if op == "floordiv":
            lo, hi = math.floor(lo), math.floor(hi)
        return Interval(lo, hi)
    if op == "mod":
        if r.lo == r.hi and r.lo > 0:
            return Interval(0, r.lo)  # closed over float fmod too
        return None
    return None  # pow and anything exotic: unknown


def expr_interval(e, ranges: Mapping[str, Interval]) -> Interval | None:
    """Evaluate an expression tree to a value interval over column bounds.

    ``ranges`` maps column name -> :class:`Interval` of that column's
    values in the row set under consideration (a chunk); columns with
    unusable bounds are simply absent. Returns None for anything that
    cannot be bounded soundly — every consumer treats None as "cannot
    prune / no estimate". Legacy callable predicates are not ``Expr``
    instances and return None here by construction."""
    if not isinstance(e, Expr):
        return None
    if isinstance(e, Alias):
        return expr_interval(e.child, ranges)
    if isinstance(e, Col):
        return ranges.get(e.name)
    if isinstance(e, Lit):
        if e.kind == "bool":
            return _TRUE if e.value else _FALSE
        if e.kind == "str":
            # an *unbound* string literal (bound ones are int code
            # literals); no numeric interval exists for it
            return None
        v = float(e.value)
        if math.isnan(v):
            return None
        return Interval(v, v)
    if isinstance(e, Cast):
        iv = expr_interval(e.child, ranges)
        if iv is None or iv.boolish:
            return iv  # bool cast keeps 0/1 values
        kind = np.dtype(e.dtype).kind
        if kind in ("i", "u"):
            # astype truncates toward zero; floor/ceil bounds cover it
            return Interval(math.floor(iv.lo), math.ceil(iv.hi))
        if kind == "f":
            lo, hi = _widen_f32(iv.lo, iv.hi)
            return Interval(lo, hi)
        if kind == "b":
            return None  # truthiness cast: not worth modelling
        return None
    if isinstance(e, UnaryOp):
        iv = expr_interval(e.child, ranges)
        if iv is None:
            return None
        if e.op == "neg":
            return Interval(-iv.hi, -iv.lo)
        if e.op == "abs":
            lo, hi = abs(iv.lo), abs(iv.hi)
            if iv.lo <= 0 <= iv.hi:
                return Interval(0, max(lo, hi))
            return Interval(min(lo, hi), max(lo, hi))
        if e.op == "invert":
            if iv.boolish:
                return Interval(1 - iv.hi, 1 - iv.lo, True)
            return Interval(-iv.hi - 1, -iv.lo - 1)  # int ~x == -x-1
        return None
    if isinstance(e, BinOp):
        l = expr_interval(e.left, ranges)
        r = expr_interval(e.right, ranges)
        if e.op in ("and", "or", "xor"):
            # short-circuit soundly: certainly-false & anything is false,
            # certainly-true | anything is true — even if the other side
            # is unbounded
            if e.op == "and" and ((l is not None and l.boolish and l.hi == 0)
                                  or (r is not None and r.boolish
                                      and r.hi == 0)):
                return _FALSE
            if e.op == "or" and ((l is not None and l.boolish and l.lo == 1)
                                 or (r is not None and r.boolish
                                     and r.lo == 1)):
                return _TRUE
            if l is None or r is None or not (l.boolish and r.boolish):
                return None
            return _bool_pair(l, r, {"and": lambda a, b: a & b,
                                     "or": lambda a, b: a | b,
                                     "xor": lambda a, b: a ^ b}[e.op])
        if l is None or r is None:
            return None
        if e.op in ("gt", "ge", "lt", "le", "eq", "ne"):
            return _cmp(e.op, l, r)
        return _arith(e.op, l, r)
    if isinstance(e, Cond):
        p = expr_interval(e.pred, ranges)
        t = expr_interval(e.if_true, ranges)
        f = expr_interval(e.if_false, ranges)
        if p is not None and p.boolish:
            if p.lo == 1:
                return t
            if p.hi == 0:
                return f
        if t is None or f is None:
            return None
        return Interval(min(t.lo, f.lo), max(t.hi, f.hi),
                        t.boolish and f.boolish)
    return None  # Agg and future node types: unknown


def _chunk_ranges(cs: ChunkStats, schema: tuple, vocabs=None) -> dict:
    """Column bound intervals for one chunk (unusable bounds omitted).

    Dict-encoded string columns sketch their *string* min/max; because the
    manifest vocab is sorted, mapping both bounds to their codes yields a
    valid interval over the int32 code column the device (and every bound
    predicate literal) actually sees. Chunk bounds are values present in
    the dataset, so the lookup always hits; a miss (stale stats) just
    omits the column — conservative, never wrong."""
    kinds = {}
    for n, dt, tail in schema:
        if not tail:
            kinds[n] = ("dict" if str(dt) == DICT_DTYPE
                        else np.dtype(dt).kind)
    out = {}
    for name, col in cs.columns:
        if col.min is None or col.max is None:
            continue
        if kinds.get(name) == "dict":
            v = (vocabs or {}).get(name)
            if v is None:
                continue
            lo, hi = v.code_of(str(col.min)), v.code_of(str(col.max))
            if lo is None or hi is None:
                continue
            out[name] = Interval(float(lo), float(hi))
            continue
        boolish = kinds.get(name) == "b"
        out[name] = Interval(float(col.min), float(col.max), boolish)
    return out


def _provably_empty(iv: Interval | None) -> bool:
    return iv is not None and iv.lo == 0 and iv.hi == 0


def chunk_skip_mask(manifest, pred_sigs) -> np.ndarray:
    """Per-chunk skip decisions for a scan's absorbed predicates.

    Returns a bool array aligned with ``manifest.chunks``: True means the
    chunk provably yields zero rows under the conjunction of
    ``pred_sigs`` (or is empty outright) and its decode can be skipped
    without changing results. Without stats, or with only legacy callable
    predicates, nothing is skipped."""
    n = len(manifest.chunks)
    skip = np.zeros(n, dtype=bool)
    stats = getattr(manifest, "stats", None)
    if stats is None or len(stats) != n:
        return skip
    exprs = [s for s in pred_sigs if isinstance(s, Expr)]
    vocabs = getattr(manifest, "vocab_map", None) or {}
    for i, cs in enumerate(stats):
        if cs.count == 0:
            skip[i] = True
            continue
        if not exprs:
            continue
        ranges = _chunk_ranges(cs, manifest.schema, vocabs)
        if any(_provably_empty(expr_interval(e, ranges)) for e in exprs):
            skip[i] = True
    return skip


def _col_cmp_lit(e):
    """Match (possibly aliased/flipped) ``col <op> literal``; returns
    ``(op, column name, value)`` with op normalized to the column-on-the-
    left form, or None."""
    while isinstance(e, Alias):
        e = e.child
    if not isinstance(e, BinOp) or e.op not in ("gt", "ge", "lt", "le",
                                                "eq", "ne"):
        return None
    l, r = e.left, e.right
    while isinstance(l, Alias):
        l = l.child
    while isinstance(r, Alias):
        r = r.child
    flip = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge",
            "eq": "eq", "ne": "ne"}
    if isinstance(l, Col) and isinstance(r, Lit):
        return e.op, l.name, r.value
    if isinstance(l, Lit) and isinstance(r, Col):
        return flip[e.op], r.name, l.value
    return None


def _range_fraction(op: str, lo: float, hi: float, v: float,
                    distinct: float) -> float:
    """Uniform-distribution selectivity of ``col <op> v`` over [lo, hi]."""
    span = hi - lo
    if op in ("eq", "ne"):
        f = 1.0 / max(distinct, 1.0)
        return f if op == "eq" else 1.0 - f
    if span <= 0:
        # single-valued column and the interval test was inconclusive
        # (shouldn't happen); split the difference
        return 0.5
    if op == "gt" or op == "ge":
        f = (hi - v) / span
    else:
        f = (v - lo) / span
    return min(max(f, 0.0), 1.0)


def predicate_selectivity(e, cs: ChunkStats, schema: tuple,
                          vocabs=None) -> float:
    """Estimated fraction of one chunk's rows passing predicate ``e``.

    Interval-provable outcomes give exact 0/1; ``col <op> literal`` uses
    the uniform-range fraction (equality via the KMV distinct estimate);
    anything else falls back to the fixed 0.5 ratio. Dict columns compare
    in code space: bound predicates carry code literals and the chunk's
    string bounds map through ``vocabs``."""
    ranges = _chunk_ranges(cs, schema, vocabs)
    iv = expr_interval(e, ranges)
    if iv is not None and iv.boolish:
        if iv.lo == 1:
            return 1.0
        if iv.hi == 0:
            return 0.0
    m = _col_cmp_lit(e)
    if m is not None:
        op, name, v = m
        col = cs.column(name)
        if col is not None and col.min is not None and col.max is not None:
            lo, hi = col.min, col.max
            voc = (vocabs or {}).get(name)
            if voc is not None:
                lo, hi = voc.code_of(str(lo)), voc.code_of(str(hi))
                if lo is None or hi is None:
                    return _FIXED_SELECTIVITY
            try:
                return _range_fraction(op, float(lo), float(hi),
                                       float(v), col.distinct())
            except (TypeError, ValueError):
                return _FIXED_SELECTIVITY
    return _FIXED_SELECTIVITY


def _scan_chunk_rows(manifest, scan) -> tuple | None:
    """Per-chunk estimated surviving rows for a scan, or None w/o stats.

    Each chunk contributes ``count x prod(per-pred selectivity)``; chunks
    the skip mask prunes contribute zero (their decode never happens)."""
    stats = getattr(manifest, "stats", None)
    if stats is None or len(stats) != len(manifest.chunks):
        return None
    skip = chunk_skip_mask(manifest, scan.pred_sigs)
    vocabs = getattr(manifest, "vocab_map", None) or {}
    out = []
    for i, cs in enumerate(stats):
        if skip[i]:
            out.append(0.0)
            continue
        est = float(cs.count)
        for sig in scan.pred_sigs:
            if isinstance(sig, Expr):
                est *= predicate_selectivity(sig, cs, manifest.schema,
                                             vocabs)
            else:
                est *= _FIXED_SELECTIVITY  # legacy callable: fixed ratio
        out.append(est)
    return tuple(out)


def scan_row_estimate(manifest, scan) -> float | None:
    """Estimated total rows a scan admits over the whole dataset (after
    chunk skipping and predicate filtering); None without stats. Feeds the
    admission controller's working-set estimate for scan-bearing queries."""
    per_chunk = _scan_chunk_rows(manifest, scan)
    if per_chunk is None:
        return None
    return float(sum(per_chunk))


def key_cardinality(manifest, cols) -> float | None:
    """Estimated distinct-key fraction of the dataset over ``cols``.

    Per-column dataset-level KMV distinct estimates multiply (independence
    assumption) and cap at the row count; returned as the fraction in
    (0, 1] that ``patterns.plan_groupby`` consumes. None when stats or any
    requested column sketch is missing."""
    stats = getattr(manifest, "stats", None)
    if not stats or not cols:
        return None
    merged = merge_chunk_stats(stats)
    total = merged.count
    if total <= 0:
        return None
    combined = 1.0
    for c in cols:
        cs = merged.column(c)
        if cs is None:
            return None
        combined *= max(cs.distinct(), 1.0)
    combined = min(combined, float(total))
    return min(max(combined / total, 1.0 / total), 1.0)


def _sole_transparent_scan(node) -> Scan | None:
    """The unique Scan under ``node`` when every intervening node passes
    key columns through untouched; else None."""
    scans = []
    for n in walk(node):
        if not isinstance(n, _KEY_TRANSPARENT):
            return None
        if isinstance(n, Scan):
            scans.append(n)
    return scans[0] if len(scans) == 1 else None


class PlanStats:
    """Bundle of per-scan dataset statistics threaded through the planner.

    Built by :func:`plan_stats` from a ``{sid: DatasetManifest}`` mapping;
    every accessor returns None when it has nothing trustworthy to say, so
    callers always keep their fixed-ratio fallback. ``cache_key`` is a
    content hash of the underlying sketches — plan-cache keys include it
    so plans never alias across datasets (or re-sketched versions of the
    same dataset).
    """

    def __init__(self, manifests: Mapping[int, object]):
        self._m = {sid: man for sid, man in manifests.items()
                   if getattr(man, "stats", None)}
        h = hashlib.sha256()
        for sid in sorted(self._m):
            man = self._m[sid]
            h.update(repr((sid, man.schema, man.stats)).encode())
        self.cache_key = h.hexdigest()

    def __hash__(self):
        return hash(self.cache_key)

    def __eq__(self, other):
        return (isinstance(other, PlanStats)
                and self.cache_key == other.cache_key)

    def has(self, sid: int) -> bool:
        """True when scan ``sid`` has usable sketches."""
        return sid in self._m

    def scan_selectivity(self, scan) -> float | None:
        """Overall surviving-row fraction for a scan's absorbed predicates
        (chunk skipping folded in); None without stats or predicates."""
        man = self._m.get(scan.sid)
        if man is None or not scan.pred_sigs:
            return None
        per_chunk = _scan_chunk_rows(man, scan)
        if per_chunk is None:
            return None
        total = man.num_rows
        if total <= 0:
            return None
        return float(sum(per_chunk)) / float(total)

    def scan_rows(self, scan) -> float | None:
        """Estimated admitted rows for the scan (dataset-wide)."""
        man = self._m.get(scan.sid)
        return None if man is None else scan_row_estimate(man, scan)

    def _node_cardinality(self, node, keys) -> float | None:
        scan = _sole_transparent_scan(node.child)
        if scan is None or not self.has(scan.sid):
            return None
        man = self._m[scan.sid]
        card = key_cardinality(man, keys)
        if card is None:
            return None
        # predicates shrink rows but distinct keys shrink at most as much:
        # re-express the (capped) distinct estimate over the filtered rows
        if scan.pred_sigs:
            sel = self.scan_selectivity(scan)
            if sel:
                card = min(card / max(sel, card), 1.0)
        return card

    def groupby_cardinality(self, node) -> float | None:
        """Estimated group fraction for a GroupBy over a (transparent)
        scan subtree; None whenever keys may have been transformed."""
        if not isinstance(node, GroupBy):
            return None
        return self._node_cardinality(node, node.by)

    def unique_cardinality(self, node) -> float | None:
        """Estimated distinct fraction for a Unique, same contract as
        :meth:`groupby_cardinality`."""
        if not isinstance(node, Unique):
            return None
        return self._node_cardinality(node, node.subset)


def plan_stats(manifests: Mapping[int, object]) -> PlanStats | None:
    """Build :class:`PlanStats` from ``{sid: manifest}``; None when no
    manifest carries sketches (so "no stats" stays one cheap None check
    everywhere downstream)."""
    ps = PlanStats(manifests or {})
    return ps if ps._m else None
