"""Segmentation utilities (reference dataloaders/utils.py + utils/util.py;
the port's copy of ``wsl4mis_tpu/utils/seg_utils.py``, host numpy and
scipy).

  * decode_segmap — class map -> RGB visualization (dataloaders/utils.py:86)
  * post_processing — largest-connected-component filtering per class
    (dataloaders/utils.py:215-226)
  * compute_sdf — signed distance field of a binary mask
    (utils/util.py:109-144, scipy EDT based)
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# Pascal-style color palette for up to 21 classes
_COLORS = np.asarray(
    [
        (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
        (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0),
        (192, 0, 0), (64, 128, 0), (192, 128, 0), (64, 0, 128),
        (192, 0, 128), (64, 128, 128), (192, 128, 128), (0, 64, 0),
        (128, 64, 0), (0, 192, 0), (128, 192, 0), (0, 64, 128),
    ],
    dtype=np.uint8,
)


def decode_segmap(label_mask: np.ndarray, n_classes: int = 4) -> np.ndarray:
    """(H, W) int class map -> (H, W, 3) uint8 RGB."""
    label_mask = np.clip(label_mask.astype(np.int64), 0, len(_COLORS) - 1)
    return _COLORS[label_mask]


def post_processing(prediction: np.ndarray, num_classes: int = 4) -> np.ndarray:
    """Keep only the largest 2D connected component of each foreground
    class (dataloaders/utils.py:215-226 semantics)."""
    out = np.zeros_like(prediction)
    struct = ndimage.generate_binary_structure(2, 1)
    for c in range(1, num_classes):
        mask = prediction == c
        if not mask.any():
            continue
        labeled, n = ndimage.label(mask, struct)
        if n == 1:
            out[mask] = c
            continue
        sizes = ndimage.sum(mask, labeled, range(1, n + 1))
        keep = np.argmax(sizes) + 1
        out[labeled == keep] = c
    return out


def cross_entropy2d(logit: np.ndarray, target: np.ndarray,
                    ignore_index: int = 255, weight=None,
                    size_average: bool = True,
                    batch_average: bool = True) -> float:
    """Reference dataloaders/utils.py:131-148 (unused by any train
    script; kept for inventory completeness). logit: (N, H, W, C) f32
    (NHWC — this framework's convention; the reference takes NCHW);
    target: (N, H, W) int. Sum-CE over non-ignored pixels with optional
    per-class weights, divided by H*W (size_average) and N
    (batch_average)."""
    n, h, w, c = logit.shape
    logit = np.asarray(logit, np.float64)
    target = np.asarray(target, np.int64)
    logp = logit - logit.max(axis=-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=-1, keepdims=True))
    valid = target != ignore_index
    tclip = np.where(valid, target, 0)
    picked = np.take_along_axis(logp, tclip[..., None], axis=-1)[..., 0]
    wvec = (np.ones(c) if weight is None
            else np.asarray(weight, np.float64))
    loss = -(picked * wvec[tclip] * valid).sum()
    if size_average:
        loss /= h * w
    if batch_average:
        loss /= n
    return float(loss)


def get_mc_dice(pred: np.ndarray, gt: np.ndarray, num: int = 2) -> np.ndarray:
    """Reference dataloaders/utils.py:200-212 (unused by any train
    script). Per-foreground-class dice summed over the batch, smooth
    1.0 in the denominator; num includes background."""
    pred = np.asarray(pred, np.int64)
    gt = np.asarray(gt, np.int64)
    total = np.zeros(num - 1)
    for i in range(len(pred)):
        for j in range(1, num):
            p = pred[i] == j
            g = gt[i] == j
            total[j - 1] += 2.0 * (p & g).sum() / (
                1.0 + p.sum() + g.sum()
            )
    return total


def compute_sdf(segmentation: np.ndarray) -> np.ndarray:
    """Signed distance field, normalized to [-1, 1]: negative inside,
    positive outside, zero on the boundary (utils/util.py:109-144)."""
    seg = segmentation.astype(bool)
    if not seg.any():
        return np.zeros_like(segmentation, dtype=np.float64)
    pos_dist = ndimage.distance_transform_edt(seg)
    neg_dist = ndimage.distance_transform_edt(~seg)
    sdf = neg_dist / max(neg_dist.max(), 1e-8) - pos_dist / max(
        pos_dist.max(), 1e-8
    )
    boundary = seg & ~ndimage.binary_erosion(
        seg, ndimage.generate_binary_structure(seg.ndim, 1)
    )
    sdf[boundary] = 0
    return sdf
