"""LM data pipeline on the DDF engine: the paper's patterns as the
trainer's data path.

Stages (each one of the paper's patterns):
  1. partitioned input  -- a synthetic corpus written as a chunked on-disk
                           dataset, opened through ``stream.scan_dataset``
  2. dedup              -- Combine-Shuffle-Reduce ``unique`` on the content
                           hash (streamed, with a carry across batches)
  3. quality filter     -- Embarrassingly-Parallel ``select`` with an
                           ``expr`` predicate
  4. length bucketing   -- Sample-Shuffle-Compute ``sort_values`` by length
                           (host-side spill + merge when streamed)
  5. rebalance          -- Partitioned-I/O repartition (straggler guard)
  6. stats              -- Globally-Reduce aggregations (token budget)

Construction runs the document pipeline through the out-of-core streaming
engine (``collect_stream``); :meth:`TokenPipeline.epoch` streams one epoch
again through ``to_batches``. The same stages as the reference's
``repro.data.pipeline``, and the same documents and batches from a seed.

Batches are fixed-shape host numpy arrays: document tokens are a hash of
(doc_id, position), so the corpus never exists on disk at token
granularity.

Over a grouped ``DDFContext`` every rank holds every document's id and
length (``to_numpy`` answers for all workers) and draws the same global
batch from the same seed. Given a train ``plan`` over the group (and the
step's ``microbatches``) each rank packs only its rows of that batch, laid
out by ``sharding.batch_rows``: what the planned train step takes.
"""

from __future__ import annotations

import tempfile

import numpy as np

from .. import sharding as shard_mod
from ..core import DDFContext
from ..expr import col
from .dataset import write_dataset
from .synthetic import synthetic_token_corpus

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, ctx: DDFContext, n_docs: int, vocab: int, seq_len: int,
                 batch: int, seed: int = 0, quality_threshold: float = 0.05, plan=None,
                 microbatches: int = 1):
        self.ctx = ctx
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        # the rows of each global batch this rank packs (all of them without a group)
        self._rows = (shard_mod.batch_rows(batch, plan, microbatches)
                      if shard_mod.data_group(plan) is not None else None)
        self.seed = seed
        self._quality_threshold = quality_threshold

        corpus = synthetic_token_corpus(n_docs, vocab, seed=seed)
        # 1. partitioned input: the corpus lives as a chunked on-disk
        # dataset, streamed in morsels rather than loaded whole
        self._tmpdir = tempfile.TemporaryDirectory(prefix="repro-corpus-")
        chunk = max(n_docs // 8, 64)
        self._manifest = write_dataset(corpus, self._tmpdir.name, chunk_rows=chunk)
        del corpus
        self._batch_rows = max(n_docs // 4, 64)

        lz = self._doc_plan()
        ddf = lz.collect_stream(prefetch=True)
        self.stream_info = dict(lz.last_info or {})
        self.docs = ddf
        # the per-stage info slots carry the streamed run's counters
        self.dedup_info = self.sort_info = self.rebalance_info = self.stream_info
        # 6. global stats (globally reduce)
        self.total_tokens = int(ddf.agg("length", "sum"))
        self.n_docs = ddf.length()

        host = ddf.to_numpy()
        self._doc_ids = host["doc_id"]
        self._lengths = host["length"]
        self._rng = np.random.default_rng(seed + 1)

    def _doc_plan(self):
        """The lazy document pipeline over the on-disk corpus: scan -> dedup
        (carry) -> quality select -> length sort (spill) -> rebalance."""
        from ..stream import scan_dataset

        return (scan_dataset(self._manifest, self.ctx, batch_rows=self._batch_rows)
                .unique(("content_hash",))
                .select(col("quality") > self._quality_threshold, name="quality")
                .sort_values("length")
                .rebalance())

    def epoch(self, prefetch: bool = True):
        """Stream one epoch of the document pipeline (``to_batches``),
        yielding packed ``(batch, seq_len)`` token blocks per document
        morsel. Docs left over that do not fill a batch are dropped."""
        for host in self._doc_plan().to_batches(prefetch=prefetch):
            ids, lens = host["doc_id"], host["length"]
            for s in range(0, len(ids) - self.batch + 1, self.batch):
                yield self._pack(ids[s:s + self.batch], lens[s:s + self.batch])

    def _pack(self, doc_ids: np.ndarray, lengths: np.ndarray) -> dict:
        """Pack documents into a (batch, seq_len) token block (this rank's
        rows of it under a plan). Tokens are a uint32 hash of (doc_id,
        pos), reproducible across restarts."""
        if self._rows is not None:
            doc_ids, lengths = doc_ids[self._rows], lengths[self._rows]
        doc = doc_ids[:, None].astype(np.uint32)
        pos = np.arange(self.seq_len, dtype=np.uint32)[None, :]
        h = (doc * np.uint32(2654435761) + pos * np.uint32(40503)) & np.uint32(0xFFFFFFFF)
        h ^= h >> np.uint32(16)
        tokens = (h % np.uint32(self.vocab)).astype(np.int32)
        length = np.minimum(lengths, self.seq_len)[:, None]
        mask = (np.arange(self.seq_len)[None, :] < length).astype(np.float32)
        labels = np.roll(tokens, -1, axis=1)
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        """A random fixed-shape token batch sampled from the processed docs
        (the steady-state trainer feed; :meth:`epoch` streams epochs in
        order)."""
        idx = self._rng.integers(0, len(self._doc_ids), size=self.batch)
        return self._pack(self._doc_ids[idx], self._lengths[idx])
