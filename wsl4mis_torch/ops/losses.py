"""Segmentation losses, channels-last (port of
``wsl4mis_tpu/ops/losses.py``).

``logits``/``probs`` are (B, H, W, C) float; ``labels`` (B, H, W) int.
Scribble supervision marks unannotated pixels with the ignore class 4.

Under a process group the losses the methods use are those of the global
batch: their sums and counts over the batch go through
``parallel.global_sums`` and their means through ``parallel.global_mean``
(without a group both return their input, and the arithmetic is the
single-process one). ``intensity_variance_losses``, ``size_loss``,
``focal_loss`` and ``supcon_loss``, which no method calls, stay per
process.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import parallel


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
        return parallel.global_mean(nll.mean())
    mask = (labels != ignore_index).to(nll.dtype)
    total, count = parallel.global_sums((nll * mask).sum(), mask.sum())
    return total / count.clamp(min=1.0)


def _soft_dice_all(probs, target, smooth=1e-5):
    """Per-class 1 - (2 sum(pt) + s) / (sum(p^2) + sum(t^2) + s)."""
    axes = tuple(range(probs.ndim - 1))
    intersect, y_sum, z_sum = parallel.global_sums(
        (probs * target).sum(axes), (target * target).sum(axes),
        (probs * probs).sum(axes))
    return 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)


def dice_loss(probs, labels, num_classes: int):
    """Multi-class soft Dice, mean over classes."""
    return _soft_dice_all(probs, one_hot(labels, num_classes)).mean()


def pdice_loss(probs, labels, num_classes: int, ignore_index: int = 4):
    """Partial Dice: score and target masked where labels == ignore."""
    mask = (labels != ignore_index).float()[..., None]
    target = one_hot(labels, num_classes)
    return _soft_dice_all(probs * mask, target * mask).mean()


def entropy_map(probs):
    """Per-pixel entropy, keepdims on the channel."""
    return -(probs * torch.log(probs + 1e-6)).sum(-1, keepdim=True)


def entropy_minimization(probs):
    """Unnormalized entropy, mean over pixels."""
    return parallel.global_mean(entropy_map(probs).mean())


def entropy_loss(probs, num_classes: int):
    """Pixelwise entropy normalized by log(num_classes), mean over pixels."""
    return entropy_minimization(probs) / math.log(num_classes)


def softmax_mse_loss(input_logits, target_logits):
    """Elementwise (softmax(a) - softmax(b))^2; gradients flow to
    `input_logits` only (the target is detached, the teacher's side)."""
    p = torch.softmax(input_logits, dim=-1)
    q = torch.softmax(target_logits, dim=-1).detach()
    return (p - q) ** 2


def softmax_kl_loss(input_logits, target_logits):
    """F.kl_div(log_softmax(a), softmax(b), reduction='mean'): the mean is
    over elements, not the batch; the target is detached."""
    logp = F.log_softmax(input_logits, dim=-1)
    q = torch.softmax(target_logits, dim=-1).detach()
    return parallel.global_mean(
        (q * (torch.log(q.clamp(min=1e-30)) - logp)).mean())


def symmetric_mse_loss(a, b):
    """mean((a - b)^2), gradients to both sides."""
    return parallel.global_mean(((a - b) ** 2).mean())


def _maxpool3x3(x):
    """3x3 stride-1 SAME max pool on NHWC (padding counts as -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1)
    return y.permute(0, 2, 3, 1)


def tv_loss(probs):
    """Min-pool / contour total-variation regularizer:
    min_pool = -maxpool(-p); contour = relu(maxpool(min_pool) - min_pool);
    loss = mean(|contour|). The caller selects the channels."""
    min_pool = -_maxpool3x3(-probs)
    contour = F.relu(_maxpool3x3(min_pool) - min_pool)
    return parallel.global_mean(contour.abs().mean())


def mumford_shah_loss(image, probs, penalty: str = "l1"):
    """Level-set homogeneity + prediction TV. image (B,H,W,Ci), probs
    (B,H,W,C). Both terms are sums, not means; the caller weights them."""
    level = 0.0
    for ich in range(image.shape[-1]):
        tgt = image[..., ich:ich + 1]
        pcentroid = (tgt * probs).sum((1, 2)) / probs.sum((1, 2))  # (B,C)
        plevel = tgt - pcentroid[:, None, None, :]
        level = level + (plevel * plevel * probs).sum()
    dh = (probs[:, 1:] - probs[:, :-1]).abs()
    dw = (probs[:, :, 1:] - probs[:, :, :-1]).abs()
    if penalty == "l2":
        dh, dw = dh * dh, dw * dw
    return parallel.global_sum(level + dh.sum() + dw.sum())


def intensity_variance_losses(image, probs, num_classes: int):
    """(inter, intra): per class c the probability-weighted mean intensity
    mu_c = sum(img p_c) / sum(p_c); intra = sum_c sum(p_c (img - mu_c)^2) /
    sum(p_c); inter = the (population) variance of the class means."""
    img = image[..., 0]
    means = []
    intra = 0.0
    for c in range(num_classes):
        p = probs[..., c]
        denom = p.sum() + 1e-6
        mu = (img * p).sum() / denom
        intra = intra + (p * (img - mu) ** 2).sum() / denom
        means.append(mu)
    inter = torch.stack(means).var(unbiased=False)
    return inter, intra


def size_loss(logits, target, margin: float = 0.1):
    """Penalty on predicted soft areas outside (1 +- margin) of the
    target's per-class pixel counts; foreground classes only."""
    probs = torch.softmax(logits, dim=-1)
    spatial = tuple(range(1, probs.ndim - 1))
    out_counts = probs.sum(spatial)  # (B, C)
    c = probs.shape[-1]
    tgt_counts = one_hot(target.reshape(target.shape[0], -1), c).sum(1)
    lower = tgt_counts * (1 - margin)
    upper = tgt_counts * (1 + margin)
    pen_small = (out_counts - lower) ** 2 * (out_counts < lower)
    pen_big = (out_counts - upper) ** 2 * (out_counts > upper)
    res = pen_small[:, 1:] + pen_big[:, 1:]
    numel = math.prod(probs.shape[ax] for ax in spatial)
    return (res / numel).mean()


def focal_loss(logits, labels, gamma: float = 2.0, alpha=None):
    """Focal loss, mean reduction; the modulating factor is detached."""
    c = logits.shape[-1]
    logp = F.log_softmax(logits.reshape(-1, c), dim=-1)
    flat = labels.reshape(-1)
    lp = (logp * one_hot(flat, c).to(logp.dtype)).sum(-1)
    pt = lp.exp().detach()
    if alpha is not None:
        at = torch.as_tensor(alpha, dtype=logp.dtype,
                             device=logp.device)[flat.long()]
        lp = lp * at
    return (-((1 - pt) ** gamma) * lp).mean()


def supcon_loss(features, labels=None, mask=None, temperature=0.07,
                contrast_mode="all", base_temperature=0.07):
    """Supervised contrastive loss. features (B, V, D) L2-normalized views;
    labels (B,) int or mask (B, B); neither gives SimCLR's identity mask."""
    if features.ndim != 3:
        raise ValueError("features must be (batch, views, dim)")
    b, v, _ = features.shape
    if labels is not None and mask is not None:
        raise ValueError("specify labels or mask, not both")
    if labels is None and mask is None:
        mask = torch.eye(b, dtype=torch.float32, device=features.device)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).float()
    else:
        mask = mask.float()
    contrast = features.transpose(0, 1).reshape(v * b, -1)
    if contrast_mode == "one":
        anchor, anchor_count = features[:, 0], 1
    else:
        anchor, anchor_count = contrast, v
    logits = anchor @ contrast.T / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    mask = mask.repeat(anchor_count, v)
    n = b * anchor_count
    logits_mask = 1.0 - torch.eye(n, mask.shape[1], dtype=torch.float32,
                                  device=features.device)
    mask = mask * logits_mask
    exp_logits = logits.exp() * logits_mask
    log_prob = logits - exp_logits.sum(1, keepdim=True).log()
    mean_log_prob_pos = (mask * log_prob).sum(1) / mask.sum(1).clamp(
        min=1e-12)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, b).mean()
