"""Deterministic, sharded, resumable data pipeline.

Multi-host layout: every host computes the same permutation stream from
(seed, epoch) and takes its own slice — no coordination traffic.  The state is
two integers (epoch, offset) carried in checkpoints, so restart/elastic
re-shard resume exactly (a host joining with a different shard count replays
from the same global offset).

Sources: synthetic LM token streams (for the train examples) and the TASTI
workload features.  A background prefetch thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class PipelineState:
    epoch: int = 0
    offset: int = 0  # in global batches within the epoch

    def as_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "offset": self.offset}

    @staticmethod
    def from_dict(d) -> "PipelineState":
        return PipelineState(int(d["epoch"]), int(d["offset"]))


class TokenDataset:
    """Deterministic synthetic LM corpus: documents of zipf-ish tokens with
    local n-gram structure (so the loss actually decreases)."""

    def __init__(self, vocab_size: int, n_docs: int = 2048,
                 doc_len: int = 512, seed: int = 0):
        rng = np.random.default_rng(seed)
        base = rng.zipf(1.5, size=(n_docs, doc_len)).astype(np.int64)
        base = np.clip(base, 1, vocab_size - 1)
        # second-order structure: every other token depends on the previous
        shift = (base[:, :-1] * 31 + 7) % vocab_size
        base[:, 1::2] = shift[:, ::2][:, : base[:, 1::2].shape[1]]
        self.tokens = base.astype(np.int32)
        self.vocab_size = vocab_size

    def batch(self, epoch: int, index: int, batch_size: int,
              seq_len: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(hash((epoch, index)) % (2 ** 32))
        docs = rng.integers(0, len(self.tokens), size=batch_size)
        starts = rng.integers(0, self.tokens.shape[1] - seq_len - 1,
                              size=batch_size)
        tok = np.stack([self.tokens[d, s:s + seq_len + 1]
                        for d, s in zip(docs, starts)])
        return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


class ShardedLoader:
    """Per-host loader: global batches -> this host's shard, with prefetch."""

    def __init__(self, dataset: TokenDataset, global_batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1,
                 state: Optional[PipelineState] = None,
                 batches_per_epoch: int = 1 << 16, prefetch_depth: int = 2):
        assert global_batch % n_hosts == 0
        self.ds = dataset
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.state = state or PipelineState()
        self.batches_per_epoch = batches_per_epoch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, st: PipelineState) -> Dict[str, np.ndarray]:
        b = self.ds.batch(st.epoch, st.offset, self.global_batch, self.seq_len)
        per = self.global_batch // self.n_hosts
        lo = self.host_id * per
        return {k: v[lo:lo + per] for k, v in b.items()}

    def _producer(self) -> None:
        st = dataclasses.replace(self.state)
        while not self._stop.is_set():
            batch = self._make(st)
            nxt = PipelineState(st.epoch, st.offset + 1)
            if nxt.offset >= self.batches_per_epoch:
                nxt = PipelineState(st.epoch + 1, 0)
            try:
                self._q.put((batch, nxt), timeout=0.5)
                st = nxt
            except queue.Full:
                continue

    def next(self) -> Dict[str, np.ndarray]:
        batch, nxt = self._q.get()
        self.state = nxt
        return batch

    def close(self) -> None:
        self._stop.set()
