"""On-device batch augmentation with the reference policy (port of
``wsl4mis_tpu/data/augment_device.py``).

Per sample, in distribution as ``_augment_one`` (augment_device.py:123-133):

    u1 > 0.5             -> branch 0: rot90 by k ~ U{0..3}, flip axis ~ U{0,1}
    else u2 > 0.5        -> branch 1: nearest rotate by angle ~ U{-20..19}
    else                 -> branch 2: identity

``sample_policy`` draws the (B, 4) policy from a torch.Generator;
``ops.augment.augment_batch`` applies it (the CUDA kernel on the card).
``augment_batch_s2l`` draws a policy of the same distribution (that of
``_augment_one_multi``, augment_device.py:67-105) for Scribble2Label's
(image, scribble, weight rows), every map filled with 0.
"""

from __future__ import annotations

import torch

from ..ops import augment as _augment


def sample_policy(generator, labels) -> torch.Tensor:
    """(B, 4) int32 rows (branch, k, axis, angle) on labels' device."""
    b, dev = labels.shape[0], labels.device
    u = torch.rand((b, 2), generator=generator, device=dev)
    branch = torch.where(u[:, 0] > 0.5, 0, torch.where(u[:, 1] > 0.5, 1, 2))
    k = torch.randint(0, 4, (b,), generator=generator, device=dev)
    axis = torch.randint(0, 2, (b,), generator=generator, device=dev)
    angle = torch.randint(-20, 20, (b,), generator=generator, device=dev)
    return torch.stack([branch, k, axis, angle], 1).to(torch.int32)


def augment_batch(generator, images, labels):
    """images (B,H,W) f32, labels (B,H,W) int32 -> augmented pair."""
    return _augment.augment_batch(images, labels,
                                  sample_policy(generator, labels))


def augment_batch_s2l(generator, images, scribbles, weights):
    """images (B,H,W) f32, scribbles (B,H,W) int32, weights (B,H,W,4) f32
    -> the three maps augmented jointly per sample, filled with 0."""
    return _augment.augment_batch_s2l(images, scribbles, weights,
                                      sample_policy(generator, scribbles))
