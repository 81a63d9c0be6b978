"""Batch iteration over RAM-cached datasets (port of
``wsl4mis_tpu/data/loader.py``): an epoch-shuffled index stream, and a
background-thread prefetch."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch of host batches."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        yield item


def batch_iterator(dataset, batch_size: int, seed: int = 0,
                   drop_last: bool = True,
                   include_index: bool = False) -> Iterator[dict]:
    """Endless epoch-shuffled batches of {'image': (B,H,W), 'label':
    (B,H,W)} (plus 'index' (B,)) from any dataset with .images/.labels."""
    n = len(dataset)
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    rng = np.random.RandomState(seed)
    while True:
        perm = rng.permutation(n)
        end = n - batch_size + 1 if drop_last else n
        for start in range(0, end, batch_size):
            idx = perm[start:start + batch_size]
            batch = {"image": dataset.images[idx],
                     "label": dataset.labels[idx]}
            if include_index:
                batch["index"] = idx
            yield batch
