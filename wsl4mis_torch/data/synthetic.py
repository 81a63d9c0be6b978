"""Synthetic ACDC-like data made from a seed, for runs without the data.

Each slice is a phantom of nested ellipses: class 3 inside class 2 (a
ring) and class 1 to one side, on background 0, with per-class intensity
plus Gaussian noise, so a network can learn it in a few hundred steps.
``sup_type="scribble"`` keeps the label on a sparse diagonal grid of
pixels and marks the rest with the ignore class 4.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .acdc import _nearest_zoom2d

_INTENSITY = np.array([0.1, 0.5, 0.7, 0.9], np.float32)


@dataclass
class ArraySliceDataset:
    """In-memory slices: images (N,H,W) float32, labels (N,H,W) int32 (the
    supervision), dense_labels (N,H,W) int32 where known (ScribbleVC's
    class-presence table reads them), and where host augmentation needs
    them the slices at their native size (lists, as AcdcSliceDataset's
    keep_native holds them)."""

    images: np.ndarray
    labels: np.ndarray
    dense_labels: np.ndarray | None = None
    native_images: list | None = None
    native_labels: list | None = None

    def __len__(self) -> int:
        return self.images.shape[0]


def _phantoms(rng: np.random.RandomState, n: int, h: int, w: int):
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[None, :, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, None, :]

    def draw(lo, hi):
        return rng.uniform(lo, hi, (n, 1, 1)).astype(np.float32)

    cy, cx = draw(-0.2, 0.2), draw(-0.2, 0.2)
    ay, ax = draw(0.2, 0.35), draw(0.2, 0.35)
    r = ((yy - cy) / ay) ** 2 + ((xx - cx) / ax) ** 2
    side = np.where(rng.rand(n, 1, 1) > 0.5, 1.0, -1.0).astype(np.float32)
    r1 = ((yy - cy) / (1.2 * ay)) ** 2 + ((xx - cx - side * 1.3 * ax)
                                         / (0.7 * ax)) ** 2
    labels = np.zeros((n, h, w), np.int32)
    labels[r1 < 1.0] = 1
    labels[r < 1.0] = 2
    labels[r < 0.45] = 3
    images = _INTENSITY[labels] + 0.1 * rng.standard_normal(
        (n, h, w)).astype(np.float32)
    return images.astype(np.float32), labels


def _scribble(labels: np.ndarray) -> np.ndarray:
    h, w = labels.shape[-2:]
    keep = (np.add.outer(np.arange(h), np.arange(w)) % 12) == 0
    return np.where(keep, labels, 4).astype(np.int32)


def synthetic_slices(n: int, patch_size=(256, 256), seed: int = 0,
                     sup_type: str = "label",
                     chunk: int = 64) -> ArraySliceDataset:
    rng = np.random.RandomState(seed)
    h, w = patch_size
    images, labels, dense = [], [], []
    for start in range(0, n, chunk):
        im, lab = _phantoms(rng, min(chunk, n - start), h, w)
        images.append(im)
        labels.append(_scribble(lab) if sup_type == "scribble" else lab)
        dense.append(lab)
    return ArraySliceDataset(np.concatenate(images), np.concatenate(labels),
                             np.concatenate(dense))


def zoomed_with_native(native: ArraySliceDataset,
                       patch_size=(256, 256)) -> ArraySliceDataset:
    """`native`'s slices zoomed (order 0) to patch_size, as the H5 reader
    zooms them, with the native ones kept for host augmentation."""
    def zoom(stack):
        return np.stack([_nearest_zoom2d(a, patch_size) for a in stack])

    return ArraySliceDataset(zoom(native.images), zoom(native.labels),
                             zoom(native.dense_labels),
                             native_images=list(native.images),
                             native_labels=list(native.labels))


def synthetic_volumes(n: int, depth: int, h: int, w: int,
                      seed: int = 1) -> list[dict]:
    """n volumes {"case", "image" (D,H,W) f32, "label" (D,H,W) int32}."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        im, lab = _phantoms(rng, depth, h, w)
        out.append({"case": f"synthetic{i:03d}", "image": im, "label": lab})
    return out
