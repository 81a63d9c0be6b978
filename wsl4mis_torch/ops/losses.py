"""Main-path segmentation losses, channels-last (port of
``wsl4mis_tpu/ops/losses.py:20-88``).

``logits``/``probs`` are (B, H, W, C) float; ``labels`` (B, H, W) int.
Scribble supervision marks unannotated pixels with the ignore class 4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def one_hot(labels, num_classes):
    """f32 one-hot by comparison: a label outside [0, num_classes) (the
    ignore class 4 with 4 classes) gives a zero row, as jax.nn.one_hot
    does (F.one_hot would raise)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def cross_entropy(logits, labels, ignore_index: int | None = None):
    """Mean NLL over non-ignored pixels; the denominator is
    max(count, 1), so an all-ignored batch gives 0 rather than NaN."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -(logp * one_hot(labels, logits.shape[-1]).to(logp.dtype)).sum(-1)
    if ignore_index is None:
        return nll.mean()
    mask = (labels != ignore_index).to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _soft_dice_all(probs, target, smooth=1e-5):
    """Per-class 1 - (2 sum(pt) + s) / (sum(p^2) + sum(t^2) + s)."""
    axes = tuple(range(probs.ndim - 1))
    intersect = (probs * target).sum(axes)
    y_sum = (target * target).sum(axes)
    z_sum = (probs * probs).sum(axes)
    return 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)


def dice_loss(probs, labels, num_classes: int):
    """Multi-class soft Dice, mean over classes."""
    return _soft_dice_all(probs, one_hot(labels, num_classes)).mean()


def pdice_loss(probs, labels, num_classes: int, ignore_index: int = 4):
    """Partial Dice: score and target masked where labels == ignore."""
    mask = (labels != ignore_index).float()[..., None]
    target = one_hot(labels, num_classes)
    return _soft_dice_all(probs * mask, target * mask).mean()
