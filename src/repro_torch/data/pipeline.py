"""Data pipeline: deterministic synthetic LM streams + a background
prefetcher whose buffer ring is **SMR-managed** (DESIGN.md §2: a stalled I/O
thread must not leak host memory unboundedly — the same robustness property
the paper gives the KV pool).

Determinism: batch ``i`` is a pure function of (seed, i) — so restarts and
*elastic* resumes (different data-parallel size) replay identical global
batches, which the fault-tolerance tests rely on."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..core.atomics import SmrNode
from ..core.smr.base import SmrScheme


def synthetic_batch(seed: int, index: int, global_batch: int, seq_len: int,
                    vocab_size: int) -> np.ndarray:
    """Markov-ish synthetic tokens: learnable structure (loss can decrease),
    deterministic in (seed, index)."""
    rng = np.random.RandomState((seed * 1_000_003 + index) % (2**31 - 1))
    base = rng.randint(0, vocab_size, size=(global_batch, 1))
    steps = rng.randint(0, 17, size=(global_batch, seq_len))
    toks = (base + np.cumsum(steps, axis=1)) % vocab_size
    return toks.astype(np.int32)


class _BufferNode(SmrNode):
    __slots__ = ("payload", "index")

    def __init__(self, payload, index):
        super().__init__()
        self.payload = payload
        self.index = index

    def reinit(self, payload, index):
        self.payload = payload
        self.index = index


class DataPipeline:
    """Iterator of (index, batch) with optional SMR-governed prefetch."""

    def __init__(self, seed: int, global_batch: int, seq_len: int,
                 vocab_size: int, start_index: int = 0,
                 prefetch: int = 4, smr: Optional[SmrScheme] = None):
        self.seed = seed
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.index = start_index
        self.prefetch = prefetch
        self.smr = smr
        self._q: "queue.Queue[_BufferNode]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if prefetch > 0:
            self._thread = threading.Thread(target=self._producer,
                                            daemon=True)
            self._thread.start()

    def _make(self, i):
        return synthetic_batch(self.seed, i, self.global_batch,
                               self.seq_len, self.vocab_size)

    def _producer(self):
        i = self.index
        while not self._stop.is_set():
            node = _BufferNode(self._make(i), i)
            if self.smr is not None:
                self.smr.alloc_stamp(node)
            while not self._stop.is_set():
                try:
                    self._q.put(node, timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += 1

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._thread is None:
            batch = self._make(self.index)
            self.index += 1
            return batch
        while True:
            node = self._q.get()
            # skip stale buffers after a restart/seek
            if node.index < self.index:
                self._retire(node)
                continue
            self.index = node.index + 1
            payload = node.payload
            self._retire(node)
            return payload

    def _retire(self, node):
        if self.smr is not None:
            with self.smr.guard():
                self.smr.retire(node)

    def seek(self, index: int):
        """Restart/elastic resume: continue from a specific global batch."""
        self.index = index

    def close(self):
        self._stop.set()
        if self._thread is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
