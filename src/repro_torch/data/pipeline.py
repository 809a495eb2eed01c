"""Deterministic synthetic data pipeline.

Two sources, copied from the reference package's ``repro/data/pipeline.py``
so that batches are bit-identical to it:
  * ``RandomTokenDataset`` — i.i.d. tokens (throughput benchmarking; loss
    stays at ln(V)).
  * ``MarkovDataset`` — a fixed random permutation transition
    ``next = perm[cur]`` with noise; a real LM drives loss toward
    -log(1-noise), so training runs can demonstrate learning.

Batches are pure functions of (seed, step) — any worker can regenerate any
step's batch, which is what makes JJPF-style task rescheduling exact: a
re-executed training task reads identical data.

``ShardedLoader`` moves each batch to one device (``.to(device)``) and
prefetches on a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class RandomTokenDataset:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(0, self.vocab_size,
                            (self.global_batch, self.seq_len + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class MarkovDataset:
    """next = perm[cur] with probability 1-noise, else uniform."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, noise: float = 0.05):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab_size).astype(np.int32)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        flip = rng.random((B, S)) < self.noise
        rand = rng.integers(0, V, (B, S), dtype=np.int32)
        for t in range(S):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(flip[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_dataset(kind: str, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, **kw):
    if kind == "random":
        return RandomTokenDataset(vocab_size, seq_len, global_batch, seed)
    if kind == "markov":
        return MarkovDataset(vocab_size, seq_len, global_batch, seed, **kw)
    raise ValueError(kind)


class ShardedLoader:
    """Device placement + prefetch: each batch's arrays become tensors on
    ``device`` (the CPU when None)."""

    def __init__(self, dataset, *, device=None, prefetch: int = 2,
                 start_step: int = 0):
        self.dataset = dataset
        self.device = torch.device(device) if device is not None else None
        self.prefetch = prefetch
        self.start_step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _place(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            out[k] = t if self.device is None else t.to(self.device)
        return out

    def _worker(self, from_step: int) -> None:
        step = from_step
        while not self._stop.is_set():
            batch = self._place(self.dataset.batch_at(step))
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        self._thread = threading.Thread(
            target=self._worker, args=(self.start_step,), daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
