"""Synthetic LM data with a background prefetch (port of
``repro/train/data.py``).

An infinite deterministic token stream: batch ``i`` is a numpy draw from
a generator seeded by ``seed + i · 0x9E3779B9`` (the reference's, so both
packages see the same integers, and any worker can regenerate any batch
after a restart), prefetched ``depth`` batches ahead on a background
thread while the device computes.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def synth_batch(
    batch_idx: int, batch: int, seq: int, vocab: int, seed: int = 0
) -> dict:
    """Deterministic batch #batch_idx (regenerable anywhere): int32
    ``tokens`` and ``labels`` (B, seq), labels the tokens shifted by one."""
    rng = np.random.default_rng(
        np.uint64(seed) + np.uint64(batch_idx) * np.uint64(0x9E3779B9)
    )
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def to_device(batch: dict, device) -> dict:
    """A numpy batch as int32 tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class Prefetcher:
    """Background prefetch of synthetic batches, ``depth`` ahead, yielding
    (index, batch); with ``device`` the batch's int32 tensors are already
    there, else numpy arrays."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 start_idx: int = 0, depth: int = 2, device=None):
        self.batch, self.seq, self.vocab, self.seed = batch, seq, vocab, seed
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.idx = start_idx
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        i = self.idx
        while not self._stop.is_set():
            b = synth_batch(i, self.batch, self.seq, self.vocab, self.seed)
            if self.device is not None:
                b = to_device(b, self.device)
            while not self._stop.is_set():
                try:
                    self.q.put((i, b), timeout=0.5)
                    i += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2)
