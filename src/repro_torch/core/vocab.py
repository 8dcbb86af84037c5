"""Dictionary encoding for string columns.

A dict-encoded column is a host-side *vocabulary* — a sorted, deduplicated
tuple of strings — paired with a device ``int32`` *codes* array. Because the
vocab is sorted, codes are order-isomorphic with the strings they stand for:
``codes_a < codes_b  <=>  strings_a < strings_b``. Every existing shuffle
pattern therefore composes unchanged — ``hash_partition_ids`` and
``local_groupby`` already key on arbitrary int columns, and ``sort_values``
on codes sorts the decoded strings.

The distributed subtlety is *vocab unification*: two relations carrying
different vocabs for the same column must be recoded into one merged vocab
space before a Join/Union/Difference compares their codes. The merge is
host-side (vocabs are tiny next to data) and each side's remap is a single
monotone ``np.searchsorted`` gather, applied by each binary operator of
the eager ``DDF`` (join, union, difference).

This module is numpy-only (no torch, no engine imports), the reference's
``repro.core.vocab`` line for line, so one vocabulary means the same codes
in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "DICT_DTYPE",
    "DictVocab",
    "encode_strings",
    "is_string_array",
    "storage_dtype",
    "storage_schema",
    "unify_vocabs",
]

#: schema dtype string marking a dict-encoded column in dataset manifests
#: and user-facing schemas. The device/plan layers never see it — they see
#: the *storage* dtype ``int32`` (see :func:`storage_dtype`).
DICT_DTYPE = "dict"


def is_string_array(arr) -> bool:
    """True when ``arr`` is a numpy array of strings (unicode/bytes kind)."""
    return isinstance(arr, np.ndarray) and arr.dtype.kind in ("U", "S")


def storage_dtype(dt: str) -> str:
    """Map a schema dtype string to the on-device storage dtype.

    ``"dict"`` columns are stored as ``int32`` codes; every other dtype is
    its own storage. The plan layer, cost model and streaming runner only
    ever see storage dtypes — ``"dict"`` lives in dataset manifests and
    user schemas, with the vocab riding alongside as host metadata."""
    return "int32" if str(dt) == DICT_DTYPE else dt


def storage_schema(schema) -> tuple:
    """Rewrite a ``((name, dtype, tail), ...)`` schema to storage dtypes."""
    return tuple((n, storage_dtype(dt), tuple(tail)) for n, dt, tail in schema)


@dataclasses.dataclass(frozen=True)
class DictVocab:
    """Sorted, deduplicated vocabulary of one dict-encoded column.

    ``words`` is a tuple of unique strings in ascending order, so the code
    of a word is its index and code order equals string order. Instances
    are immutable and hashable (usable in cache keys and plan nodes).
    """

    words: tuple

    def __post_init__(self):
        w = tuple(str(s) for s in self.words)
        if any(w[i] >= w[i + 1] for i in range(len(w) - 1)):
            w = tuple(sorted(set(w)))
        object.__setattr__(self, "words", w)

    @classmethod
    def from_values(cls, values) -> "DictVocab":
        """Build a vocab from any iterable/array of strings."""
        return cls(tuple(sorted(set(str(s) for s in np.asarray(values).ravel()))))

    @property
    def values(self) -> np.ndarray:
        """The vocabulary as a numpy unicode array (index = code)."""
        return np.asarray(self.words, dtype=np.str_)

    def __len__(self) -> int:
        return len(self.words)

    def __contains__(self, s) -> bool:
        i = int(np.searchsorted(self.values, str(s)))
        return i < len(self.words) and self.words[i] == str(s)

    def code_of(self, s) -> int | None:
        """Code of ``s`` in this vocab, or None when absent."""
        i = int(np.searchsorted(self.values, str(s)))
        return i if i < len(self.words) and self.words[i] == str(s) else None

    def bound(self, s, side: str = "left") -> int:
        """``np.searchsorted`` boundary of ``s`` — the code-space threshold
        for compiling ordered string comparisons (``<``/``<=``/``>``/``>=``)
        against a literal that may be absent from the vocab."""
        return int(np.searchsorted(self.values, str(s), side=side))

    def merge(self, other: "DictVocab") -> "DictVocab":
        """Union of two vocabs (sorted, deduplicated)."""
        if other.words == self.words:
            return self
        return DictVocab(tuple(sorted(set(self.words) | set(other.words))))

    def recode_map(self, merged: "DictVocab") -> np.ndarray:
        """int32 gather map from this vocab's code space into ``merged``'s.

        ``merged`` must be a superset; the map is monotone because both
        vocabs are sorted. ``new_codes = recode_map(merged)[old_codes]``."""
        if not self.words:
            return np.zeros(0, np.int32)
        m = np.searchsorted(merged.values, self.values).astype(np.int32)
        if (np.asarray(merged.values)[m] != self.values).any():
            raise ValueError("recode target vocab is not a superset")
        return m

    def is_identity_into(self, merged: "DictVocab") -> bool:
        """True when recoding into ``merged`` would not change any code."""
        return merged.words[: len(self.words)] == self.words

    def encode(self, values) -> np.ndarray:
        """Strings -> int32 codes. Raises ``KeyError`` naming the first
        value absent from the vocab."""
        arr = np.asarray(values).astype(np.str_)
        codes = np.searchsorted(self.values, arr)
        codes = np.minimum(codes, max(len(self.words) - 1, 0))
        if arr.size and (len(self.words) == 0 or
                         (self.values[codes] != arr).any()):
            if len(self.words) == 0:
                raise KeyError(f"value {arr.ravel()[0]!r} not in empty vocab")
            bad = arr[self.values[codes] != arr].ravel()[0]
            raise KeyError(f"value {bad!r} not in vocab")
        return codes.astype(np.int32)

    def decode(self, codes) -> np.ndarray:
        """int32 codes -> numpy string array (inverse of :meth:`encode`)."""
        c = np.asarray(codes)
        if c.size == 0:
            return np.zeros(c.shape, dtype=self.values.dtype if self.words
                            else np.dtype("<U1"))
        return self.values[c]


def encode_strings(values) -> tuple:
    """Dict-encode a string array: ``(int32 codes, DictVocab)``.

    Uses ``np.unique(return_inverse=True)``, whose unique output is sorted —
    exactly the vocab invariant."""
    arr = np.asarray(values)
    if arr.dtype.kind not in ("U", "S", "O"):
        raise TypeError(f"cannot dict-encode non-string array of dtype "
                        f"{arr.dtype}")
    uniq, inv = np.unique(arr.astype(np.str_), return_inverse=True)
    return inv.astype(np.int32).reshape(arr.shape), DictVocab(tuple(uniq))


def unify_vocabs(*vocabs: DictVocab) -> DictVocab:
    """Merge any number of vocabs into one (sorted union)."""
    out = DictVocab(())
    for v in vocabs:
        out = out.merge(v)
    return out
