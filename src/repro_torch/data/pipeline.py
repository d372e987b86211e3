"""Deterministic, shard-aware token data pipeline.

Two sources:
  * ``SyntheticTokens`` — seeded on (seed, step, shard) so every host
    derives its own disjoint slice without coordination; fully
    reproducible across restarts and elastic re-sharding (the stream is a
    pure function of the global step).
  * ``MemmapTokens`` — flat binary token file (np.memmap) with the same
    (step → global batch window) indexing; hosts read disjoint slices.

Both yield {tokens, labels} with labels = next-token shift. Batches are
*global* logical arrays under pjit; per-host sharding comes from the mesh.
A background prefetch thread keeps ``prefetch`` batches ready (overlapping
host data work with device compute).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["SyntheticTokens", "MemmapTokens", "Prefetcher"]


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens; deterministic in (seed, step)."""

    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Zipf-like marginal over the vocab (realistic token frequencies).
        u = rng.random((self.global_batch, self.seq_len + 1))
        toks = np.minimum(
            (self.vocab_size * (u ** 2.2)).astype(np.int32),
            self.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapTokens:
    """Flat uint16/uint32 token file → (step → window) batches."""

    def __init__(self, path: str, *, seq_len: int, global_batch: int,
                 dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        tokens_per_batch = global_batch * (seq_len + 1)
        self.n_batches = len(self.data) // tokens_per_batch
        if self.n_batches == 0:
            raise ValueError("token file smaller than one global batch")

    def batch(self, step: int) -> dict[str, np.ndarray]:
        per = self.global_batch * (self.seq_len + 1)
        off = (step % self.n_batches) * per
        window = np.asarray(self.data[off:off + per]).astype(np.int32)
        window = window.reshape(self.global_batch, self.seq_len + 1)
        return {"tokens": window[:, :-1], "labels": window[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of ``depth`` upcoming batches."""

    def __init__(self, source, *, depth: int = 2, start_step: int = 0):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self.source.batch(step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def get(self) -> dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
