"""Deterministic synthetic data pipeline: the port's copy of
`repro.data.pipeline` (numpy only, bit-equal batches).

A seeded Markov-ish token stream (bigram structure so models actually have
something learnable), resumable by step index: batch i is a pure function
of (seed, i), which is what makes checkpoint-restart exact -- no iterator
state needs to be saved beyond the step counter. Prefetch is a background
thread producing the next batch while the step runs.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTextDataset:
    """Learnable synthetic LM stream: next-token = f(prev) + noise."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, noise: float = 0.1):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        # fixed random bigram successor table
        self._succ = rng.integers(0, vocab_size, size=vocab_size)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        for t in range(1, self.seq + 1):
            nxt = self._succ[toks[:, t - 1]]
            noise_mask = rng.random(self.batch) < self.noise
            nxt = np.where(noise_mask,
                           rng.integers(0, self.vocab, size=self.batch),
                           nxt)
            toks[:, t] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batches(dataset, start_step: int, num_steps: int,
                 prefetch: int = 2):
    """Prefetching iterator over dataset.batch_at(step)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def producer():
        for s in range(start_step, start_step + num_steps):
            q.put((s, dataset.batch_at(s)))
        q.put(stop)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            break
        yield item
