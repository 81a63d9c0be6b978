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

``augment_batch_s2l`` is Scribble2Label's variant (no Pallas counterpart:
``wsl4mis_tpu/data/augment_device.augment_batch_s2l`` runs in XLA): the
same policy on the image, the scribble and the (B, H, W, 4) f32 EMA weight
rows, every map filled with 0 (the scribble takes no ignore-class fill).

``data.augment_device.sample_policy`` draws the policy. A CUDA tensor goes
to the kernel (or the wrapper raises), a CPU tensor to
``augment_batch_plain``. ``launches`` counts wrapper calls that launch
the kernels (one C entry point each: ``augment`` the label-fill flags,
then the tiles; ``augment_s2l`` the tiles alone).
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = {"augment": 0, "augment_s2l": 0}

# label words per fill-flag block (FLAG_CHUNK of csrc/augment.cu)
_FLAG_CHUNK = 4096


def _cos_sin(policy):
    """(B, 2) f32 cos and sin of the angle in radians, computed in f32: the
    angle times f32(pi / 180) (a Python float rounds to that in an f32
    multiply), as the kernel computes them."""
    theta = policy[:, 3].float() * (math.pi / 180.0)
    return torch.stack([torch.cos(theta), torch.sin(theta)], 1)


def _label_fill(labels):
    """(B,) int32: 4 where the sample's label holds the ignore class 4."""
    has4 = (labels == 4).flatten(1).any(1)
    return has4.to(torch.int32) * 4


def augment_batch_plain(images, labels, policy, weights=None,
                        label_fill=None):
    """Plain PyTorch version: index maps and one gather per plane.

    weights: optional (B, H, W, K) channel planes carried with the same
    maps (filled with 0); label_fill: None for the rule (4 where the label
    holds class 4, else 0) or a fixed fill. Returns (images, labels) or,
    with weights, (images, labels, weights)."""
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
    fill = (_label_fill(labels).view(b, 1, 1) if label_fill is None
            else torch.tensor(label_fill, dtype=lab.dtype, device=dev))
    lab = torch.where(inside, lab, fill)
    if weights is None:
        return img, lab
    k = weights.shape[-1]
    wgt = weights.reshape(b, -1, k).gather(
        1, src[..., None].expand(-1, -1, k)).view(b, h, w, k)
    wgt = torch.where(inside[..., None], wgt,
                      torch.zeros((), dtype=wgt.dtype, device=dev))
    return img, lab, wgt


def _augment_kernel(images, labels, policy):
    """One ctypes call, no PyTorch launch and no host-device sync: the
    label fill and cos / sin are computed on the card."""
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
    if not 1 <= b <= 65535:
        raise ValueError(f"augment: batch {b} outside 1..65535")
    if labels.device != images.device or policy.device != images.device:
        raise ValueError("augment: operands on different devices")
    if not (images.is_contiguous() and labels.is_contiguous()
            and policy.is_contiguous()):
        raise ValueError("augment: operands must be contiguous")
    flags = torch.empty((b * -(-h * w // _FLAG_CHUNK),), dtype=torch.int32,
                        device=images.device)
    img_out = torch.empty_like(images)
    lab_out = torch.empty_like(labels)
    lib = _build.lib("augment")
    with _build.on_device(images):
        err = lib.augment(
            images.data_ptr(), labels.data_ptr(), policy.data_ptr(),
            flags.data_ptr(), img_out.data_ptr(), lab_out.data_ptr(), b, h,
            w, _build.stream(images))
    _build.check("augment", "augment", err)
    launches["augment"] += 1
    return img_out, lab_out


def _augment_s2l_kernel(images, scribbles, weights, policy):
    """One ctypes call, no PyTorch launch and no host-device sync, no fill
    flags: every map fills with 0."""
    b, h, w = images.shape
    if images.dtype != torch.float32 or weights.dtype != torch.float32 \
            or scribbles.dtype != torch.int32 or policy.dtype != torch.int32:
        raise TypeError("augment_s2l: images and weights float32, scribbles "
                        "and policy int32")
    if tuple(scribbles.shape) != (b, h, w) \
            or tuple(weights.shape) != (b, h, w, 4) \
            or tuple(policy.shape) != (b, 4):
        raise ValueError(f"augment_s2l: images {tuple(images.shape)}, "
                         f"scribbles {tuple(scribbles.shape)}, weights "
                         f"{tuple(weights.shape)}, policy "
                         f"{tuple(policy.shape)} disagree")
    if h != w:
        raise ValueError("augment_s2l: rot90 needs square planes")
    if not 1 <= b <= 65535:
        raise ValueError(f"augment_s2l: batch {b} outside 1..65535")
    if any(t.device != images.device for t in (scribbles, weights, policy)):
        raise ValueError("augment_s2l: operands on different devices")
    if not all(t.is_contiguous() for t in (images, scribbles, weights,
                                           policy)):
        raise ValueError("augment_s2l: operands must be contiguous")
    img_out = torch.empty_like(images)
    scr_out = torch.empty_like(scribbles)
    wgt_out = torch.empty_like(weights)
    lib = _build.lib("augment")
    with _build.on_device(images):
        err = lib.augment_s2l(
            images.data_ptr(), scribbles.data_ptr(), weights.data_ptr(),
            policy.data_ptr(), img_out.data_ptr(), scr_out.data_ptr(),
            wgt_out.data_ptr(), b, h, w, _build.stream(images))
    _build.check("augment", "augment_s2l", err)
    launches["augment_s2l"] += 1
    return img_out, scr_out, wgt_out


def augment_batch_s2l(images, scribbles, weights, policy):
    """images (B,H,W) f32, scribbles (B,H,W) int32, weights (B,H,W,4) f32,
    policy (B,4) int32 -> the three maps augmented per sample, all filled
    with 0."""
    if images.is_cuda:
        return _augment_s2l_kernel(images, scribbles, weights, policy)
    if images.device.type == "cpu":
        return augment_batch_plain(images, scribbles, policy,
                                   weights=weights, label_fill=0)
    raise RuntimeError(f"no augment_s2l implementation for {images.device}")


def augment_batch(images, labels, policy):
    """images (B,H,W) f32, labels (B,H,W) int32, policy (B,4) int32 ->
    (images, labels) augmented per sample."""
    if images.is_cuda:
        return _augment_kernel(images, labels, policy)
    if images.device.type == "cpu":
        return augment_batch_plain(images, labels, policy)
    raise RuntimeError(f"no augment implementation for {images.device}")
