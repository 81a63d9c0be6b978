"""Batch augmentation by a given per-sample policy (kernel + plain version).

Port of the function of ``wsl4mis_tpu/ops/pallas/augment_pallas.py``
(``_aug_kernel``) with the exact rotation of
``wsl4mis_tpu/data/augment_device.py`` in place of the TPU's 3-shear
workaround; see ``csrc/augment.cu``. The policy is an input, (B, 4) int32
rows of (branch, k, axis, angle):

* branch 0: ``rot90`` by k, then a flip along axis (square planes);
* branch 1: nearest rotation by the integer angle in degrees; outside
  pixels take 0 (image) or 4 / 0 (label: 4 when it holds class 4);
* branch 2: identity.

``data.augment_device.sample_policy`` draws the policy. A CUDA tensor goes
to the kernel (or the wrapper raises), a CPU tensor to
``augment_batch_plain``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = {"augment": 0}


def _cos_sin(policy):
    """(B, 2) f32 cos and sin of the angle in radians, computed in f32."""
    theta = policy[:, 3].float() * torch.tensor(
        math.pi / 180.0, dtype=torch.float32, device=policy.device)
    return torch.stack([torch.cos(theta), torch.sin(theta)], 1).contiguous()


def _label_fill(labels):
    """(B,) int32: 4 where the sample's label holds the ignore class 4."""
    has4 = (labels == 4).flatten(1).any(1)
    return (has4.to(torch.int32) * 4).contiguous()


def augment_batch_plain(images, labels, policy):
    """Plain PyTorch version: index maps and one gather per plane."""
    b, h, w = images.shape
    dev = images.device
    branch = policy[:, 0].view(b, 1, 1)
    k = (policy[:, 1] % 4).view(b, 1, 1)
    axis = policy[:, 2].view(b, 1, 1)
    i = torch.arange(h, device=dev).view(1, h, 1).expand(b, h, w)
    j = torch.arange(w, device=dev).view(1, 1, w).expand(b, h, w)
    # branch 0: rot90(x, k)[fi, fj] at the flipped index (fi, fj)
    fi = torch.where(axis == 0, h - 1 - i, i)
    fj = torch.where(axis == 0, j, w - 1 - j)
    si0 = torch.where(k == 0, fi, torch.where(
        k == 1, fj, torch.where(k == 2, h - 1 - fi, h - 1 - fj)))
    sj0 = torch.where(k == 0, fj, torch.where(
        k == 1, w - 1 - fi, torch.where(k == 2, w - 1 - fj, fi)))
    # branch 1: inverse-map nearest rotation about the plane's center
    cs = _cos_sin(policy)
    c = cs[:, 0].view(b, 1, 1)
    s = cs[:, 1].view(b, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, device=dev, dtype=torch.float32) - cy).view(1, h, 1)
    xx = (torch.arange(w, device=dev, dtype=torch.float32) - cx).view(1, 1, w)
    sy = c * yy + s * xx + cy
    sx = (-s) * yy + c * xx + cx
    inside = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    si1 = torch.floor(sy + 0.5).long().clamp(0, h - 1)
    sj1 = torch.floor(sx + 0.5).long().clamp(0, w - 1)
    si = torch.where(branch == 0, si0, torch.where(branch == 1, si1, i))
    sj = torch.where(branch == 0, sj0, torch.where(branch == 1, sj1, j))
    inside = inside | (branch != 1)
    src = (si * w + sj).reshape(b, -1)
    img = images.reshape(b, -1).gather(1, src).view(b, h, w)
    lab = labels.reshape(b, -1).gather(1, src).view(b, h, w)
    img = torch.where(inside, img, torch.zeros((), dtype=img.dtype,
                                                device=dev))
    lab = torch.where(inside, lab, _label_fill(labels).view(b, 1, 1))
    return img, lab


def _augment_kernel(images, labels, policy):
    b, h, w = images.shape
    if images.dtype != torch.float32 or labels.dtype != torch.int32 \
            or policy.dtype != torch.int32:
        raise TypeError("augment: images float32, labels and policy int32")
    if tuple(labels.shape) != (b, h, w) or tuple(policy.shape) != (b, 4):
        raise ValueError(f"augment: images {tuple(images.shape)}, labels "
                         f"{tuple(labels.shape)}, policy "
                         f"{tuple(policy.shape)} disagree")
    if h != w:
        raise ValueError("augment: rot90 needs square planes")
    for t in (labels, policy):
        if t.device != images.device:
            raise ValueError("augment: operands on different devices")
    if not all(t.is_contiguous() for t in (images, labels, policy)):
        raise ValueError("augment: operands must be contiguous")
    cos_sin = _cos_sin(policy)
    fill = _label_fill(labels)
    img_out = torch.empty_like(images)
    lab_out = torch.empty_like(labels)
    lib = _build.lib("augment")
    with torch.cuda.device(images.device):
        err = lib.augment(
            images.data_ptr(), labels.data_ptr(), policy.data_ptr(),
            cos_sin.data_ptr(), fill.data_ptr(), img_out.data_ptr(),
            lab_out.data_ptr(), b, h, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check("augment", "augment", err)
    launches["augment"] += 1
    return img_out, lab_out


def augment_batch(images, labels, policy):
    """images (B,H,W) f32, labels (B,H,W) int32, policy (B,4) int32 ->
    (images, labels) augmented per sample."""
    if images.is_cuda:
        return _augment_kernel(images, labels, policy)
    if images.device.type == "cpu":
        return augment_batch_plain(images, labels, policy)
    raise RuntimeError(f"no augment implementation for {images.device}")
