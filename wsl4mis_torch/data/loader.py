"""Batch iteration over RAM-cached datasets (port of
``wsl4mis_tpu/data/loader.py``): an epoch-shuffled index stream, its
labeled + unlabeled pairing for the semi-supervised methods, and a
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


def paired_iterator(labeled, unlabeled, labeled_bs: int, unlabeled_bs: int,
                    seed: int = 0, images: bool = False) -> Iterator[dict]:
    """Semi-supervised index batches {"index": (labeled_bs + unlabeled_bs,)
    int32} into the stack [labeled; unlabeled] (unlabeled indices offset by
    len(labeled)), in the order of the JAX package's paired_iterator, which
    ships the images: labeled first, the labeled stream cycling and the
    epoch keyed to the unlabeled one (train_mean_teacher_2D.py:106-138).
    With `images`, those slices themselves, {"image", "label"}, as the JAX
    iterator yields them (less its "labeled_bs", which a bundle's
    batch_parts carry)."""
    lab_it = batch_iterator(labeled, labeled_bs, seed=seed,
                            include_index=True)
    unlab_it = batch_iterator(unlabeled, unlabeled_bs, seed=seed + 1,
                              include_index=True)
    offset = len(labeled)
    while True:
        lab, unlab = next(lab_it), next(unlab_it)
        if images:
            yield {k: np.concatenate([lab[k], unlab[k]])
                   for k in ("image", "label")}
        else:
            yield {"index": np.concatenate(
                [lab["index"], unlab["index"] + offset]).astype(np.int32)}
