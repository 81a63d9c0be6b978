"""Gated CRF loss (Obukhov et al. 2019): kernel, plain version, full surface.

Port of ``wsl4mis_tpu/ops/gated_crf.py`` (``gated_crf_loss``, the scan over
the window's offsets, and ``select_gated_crf``'s dispatch) and of
``wsl4mis_tpu/ops/pallas/gated_crf_pallas.py`` (``gated_crf_loss_pallas``).
For each pixel p and each non-centre offset o of a (2r+1)^2 box,

    k(p, o) = sum_d w_d * exp(-0.5 * ||f_d(p+o) - f_d(p)||^2)
    loss    = (sum k - sum_o sum_c k(p, o) y_c(p+o) y_c(p)) / (B * H * W)

with features f = [xy / sigma_xy, image / sigma_rgb] per descriptor, and
features and probabilities zero outside the image: a border pixel's kernel
against an outside neighbour is w * exp(-0.5 ||f(p)||^2), which adds to
``sum k`` and nothing to the product term.

* ``gated_crf_products`` is the contraction (prod_c(p) = sum_o k y_c(p+o)
  and per-image sum k): the CUDA kernels of ``csrc/gated_crf.cu`` for a
  CUDA tensor (or the wrapper raises), ``gated_crf_products_plain`` for a
  CPU tensor. Given each descriptor's xy sigma (``split_features``), the
  kernel builds the xy features from the pixel coordinates and reads only
  the other channels; the plain version builds the full stacked features.
  ``launches`` counts wrapper calls that launch the kernels (one C entry
  point: the contraction, then the f64 fold of sum k).
* ``gated_crf_loss`` routes like the JAX package's dispatch: the default
  surface goes through the ``torch.autograd.Function`` over the
  contraction, whose backward is analytic, grad_probs = -2 g prod / (B H
  W). That is exact because the kernel operator is symmetric on in-image
  pairs. ``mask_src`` / ``mask_dst`` / ``compatibility`` /
  ``custom_modality_downsamplers`` break the symmetry (or the feature
  construction) and take ``gated_crf_loss_plain``, the offset loop
  differentiated by autograd, on any device. ``image`` gets no gradient on
  the Function route.

Sums over pixels are folded in float64 (the kernel's per-block f32 partials
of sum k, at most 1024 * 120 * sum(w) each; the plain loop's per-offset
sums; the product term): sum k is of order 1e7-1e8 at training sizes,
where one f32 ulp is 1-8, and the loss is a difference of two such sums.
The loss comes back as f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

DEFAULT_KERNELS_DESC = ({"weight": 1.0, "xy": 6.0, "rgb": 0.1},)

launches = {"gated_crf": 0}

# limits of csrc/gated_crf.cu
MAX_CLASSES = 8
MAX_FEATURES = 8
MAX_DESCRIPTORS = 4
_MAX_SMEM = 232448
_TILE = (32, 32)  # (rows, columns) of a block's tile


def _smem_bytes(c, f, nd, radius):
    """Shared memory of one block (Geom::bytes of csrc/gated_crf.cu): the
    probabilities as float4s (classes padded to 4 or 8) on an odd pitch,
    f feature planes on a pitch of 1 mod 8, and nd x / y tables."""
    ph, pw = _TILE[0] + 2 * radius, _TILE[1] + 2 * radius
    ncp = 4 if c <= 4 else 8
    return 4 * (ncp * ph * (pw | 1) + f * ph * (((pw + 6) & ~7) + 1)
                + nd * (pw + ph))


# ---- features and masks ----------------------------------------------------


def _area_downsample(x, h, w):
    """adaptive_avg_pool2d for integer factors: (B,H,W,C) -> (B,h,w,C)."""
    b, hi, wi, ci = x.shape
    if (hi, wi) == (h, w):
        return x
    if hi % h or wi % w:
        raise ValueError(
            f"modality {hi}x{wi} is not an integer multiple of {h}x{w}")
    fh, fw = hi // h, wi // w
    return x.reshape(b, h, fh, w, fw, ci).mean(dim=(2, 4))


def _downsample(x, modality, h, w, custom_modality_downsamplers):
    """The modality's custom downsampler if one is given, else area."""
    if (custom_modality_downsamplers is not None
            and modality in custom_modality_downsamplers):
        return custom_modality_downsamplers[modality](x, (h, w))
    return _area_downsample(x, h, w)


def _fix_mask(mask, h, w, custom_modality_downsamplers):
    """(B,H,W,1) float mask at prediction resolution; NaNs and
    interpolation-softened edges (< 1) become 0."""
    mask = mask.float()
    if tuple(mask.shape[1:3]) != (h, w):
        mask = _downsample(mask, "mask", h, w, custom_modality_downsamplers)
    mask = torch.nan_to_num(mask, nan=0.0)
    return torch.where(mask < 1.0, torch.zeros_like(mask), mask)


def split_features(image, kernels_desc, h, w, downsamplers=None):
    """(feats (B,h,w,F) f32 contiguous, weights, nf_splits, xy_sigmas): each
    descriptor's image modalities at prediction resolution, scaled by
    1/sigma. Descriptor d owns the next nf_splits[d] channels (0 for an
    xy-only descriptor) and has the x (column) and y (row) meshes /
    xy_sigmas[d] ahead of them, or none where that is None: the kernel
    builds those from the coordinates."""
    planes, splits, xy = [], [], []
    for desc in kernels_desc:
        sigma = desc.get("xy")
        xy.append(None if sigma is None else float(sigma))
        n = 0
        for modality, s in desc.items():
            if modality in ("weight", "xy"):
                continue
            feat = _downsample(image.float(), modality, h, w, downsamplers)
            planes.append(feat / s)
            n += feat.shape[-1]
        splits.append(n)
    weights = [float(d["weight"]) for d in kernels_desc]
    if not planes:
        feats = image.new_empty((image.shape[0], h, w, 0), dtype=torch.float32)
    elif len(planes) == 1:
        feats = planes[0].contiguous()
    else:
        feats = torch.cat(planes, dim=-1).contiguous()
    return feats, weights, splits, xy


def stacked_features(image, kernels_desc, h, w, downsamplers=None):
    """(feats (B,h,w,F) f32 contiguous, weights, nf_splits): every feature
    of every descriptor, the xy meshes stored too."""
    feats, weights, splits, xy = split_features(image, kernels_desc, h, w,
                                                downsamplers)
    feats, splits = _with_xy(feats, splits, xy)
    return feats, weights, splits


def _with_xy(feats, nf_splits, xy_sigmas):
    """The full stacked features and their split from split_features'
    form: each descriptor's x, y meshes / sigma, then its channels."""
    b, h, w, _ = feats.shape
    xx = torch.arange(w, dtype=torch.float32, device=feats.device)
    yy = torch.arange(h, dtype=torch.float32, device=feats.device)
    stacks, splits = [], []
    for part, sigma in zip(torch.split(feats, list(nf_splits), dim=-1),
                           xy_sigmas):
        cols = [part]
        if sigma is not None:
            cols = [(xx / sigma).view(1, 1, w, 1).expand(b, h, w, 1),
                    (yy / sigma).view(1, h, 1, 1).expand(b, h, w, 1), part]
        stacks += cols
        splits.append(sum(c.shape[-1] for c in cols))
    return torch.cat(stacks, dim=-1).contiguous(), splits


# ---- plain PyTorch versions ------------------------------------------------


def _offset_loop(probs, feats, weights, nf_splits, radius, src_pad=None,
                 dst=None):
    """(prod (B,H,W,C) f32, ksum (B,) f64): the loop over the non-centre
    offsets on zero-padded maps. src_pad (B,H+2r,W+2r) gates the neighbour
    pixel, dst (B,H,W) the centre pixel."""
    b, h, w, _ = probs.shape
    r = radius
    fpad = F.pad(feats, (0, 0, r, r, r, r))
    ppad = F.pad(probs, (0, 0, r, r, r, r))
    centre = torch.split(feats, nf_splits, dim=-1)
    prod = torch.zeros_like(probs)
    ksum = torch.zeros((b,), dtype=torch.float64, device=probs.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            if dy == r and dx == r:
                continue
            shifted = torch.split(fpad[:, dy:dy + h, dx:dx + w], nf_splits,
                                  dim=-1)
            kernel = torch.zeros((b, h, w), dtype=torch.float32,
                                 device=probs.device)
            for wgt, fs, fc in zip(weights, shifted, centre):
                diff = fs - fc
                kernel = kernel + wgt * torch.exp(
                    -0.5 * (diff * diff).sum(-1))
            if src_pad is not None:
                kernel = kernel * src_pad[:, dy:dy + h, dx:dx + w]
            if dst is not None:
                kernel = kernel * dst
            prod = prod + kernel[..., None] * ppad[:, dy:dy + h, dx:dx + w]
            ksum = ksum + kernel.sum(dim=(1, 2), dtype=torch.float64)
    return prod, ksum


def gated_crf_products_plain(probs, feats, radius, weights, nf_splits,
                             xy_sigmas=None):
    """Plain version of the kernel: (prod, ksum) with no autograd graph;
    with xy_sigmas, feats are split_features' (the xy meshes are added)."""
    with torch.no_grad():
        if xy_sigmas is not None:
            feats, nf_splits = _with_xy(feats, nf_splits, xy_sigmas)
        return _offset_loop(probs, feats, list(weights), list(nf_splits),
                            radius)


def gated_crf_loss_plain(probs, image, kernels_desc=DEFAULT_KERNELS_DESC,
                         radius: int = 5, mask_src=None, mask_dst=None,
                         compatibility=None,
                         custom_modality_downsamplers=None):
    """The full surface, differentiated by autograd through the loop.

    probs (B,H,W,C) softmax probabilities; image (B,Hi,Wi,Ci).
    * mask_src (B,H,W,1) gates the kernel's source (neighbour) pixels; the
      denominator becomes mask_src.sum().clamp(1).
    * mask_dst (B,H,W,1) gates its destination (centre) pixels and
      overrides the denominator with mask_dst.sum().clamp(1).
    * compatibility (C,C): rows L1-normalized and scaled by C-1; the loss
      becomes sum(compat * (y^T K y)), without the sum-k term.
    * custom_modality_downsamplers: {modality: fn(x, (h, w))} in place of
      the area downsampler for over-resolution modalities and masks.
    """
    b, h, w, c = probs.shape
    r = radius
    probs = probs.float()
    dsm = custom_modality_downsamplers
    feats, weights, nf_splits = stacked_features(image, kernels_desc, h, w,
                                                  dsm)
    denom = torch.tensor(float(b * h * w), device=probs.device)
    src_pad = dst = None
    if mask_src is not None:
        mask_src = _fix_mask(mask_src, h, w, dsm)
        denom = mask_src.sum().clamp(min=1.0)
        src_pad = F.pad(mask_src[..., 0], (r, r, r, r))
    if mask_dst is not None:
        mask_dst = _fix_mask(mask_dst, h, w, dsm)
        denom = mask_dst.sum().clamp(min=1.0)
        dst = mask_dst[..., 0]
    prod, ksum = _offset_loop(probs, feats, weights, nf_splits, r, src_pad,
                              dst)
    if compatibility is None:
        loss = ksum.sum() - (prod * probs).sum(dtype=torch.float64)
    else:
        compat = torch.as_tensor(compatibility, dtype=torch.float32,
                                 device=probs.device)
        compat = (c - 1) * compat / compat.abs().sum(
            dim=1, keepdim=True).clamp(min=1e-12)
        product_cc = torch.einsum("bhwi,bhwj->ij", probs.double(),
                                  prod.double())
        loss = (compat * product_cc).sum()
    return (loss / denom).float()


# ---- kernel wrapper --------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _desc_arrays(weights, nf_splits, xy):
    """The C entry point's host arrays (weights, xy sigmas, desc_of) of one
    descriptor list, built once."""
    nd = len(weights)
    return ((ctypes.c_float * nd)(*weights), (ctypes.c_float * nd)(*xy),
            (ctypes.c_int * max(sum(nf_splits), 1))(
                *[d for d, nf in enumerate(nf_splits) for _ in range(nf)]))


def _products_kernel(probs, feats, radius, weights, nf_splits,
                     xy_sigmas=None):
    """One ctypes call, no PyTorch launch: the contraction and the f64 fold
    of the per-block partials of sum k."""
    b, h, w, c = probs.shape
    f = feats.shape[-1]
    nd = len(weights)
    xy_sigmas = (None,) * nd if xy_sigmas is None else tuple(xy_sigmas)
    if any(s is not None and not float(s) > 0.0 for s in xy_sigmas):
        raise ValueError(f"gated_crf: xy sigmas {list(xy_sigmas)} must be "
                         "positive")
    xy = tuple(0.0 if s is None else float(s) for s in xy_sigmas)  # 0: none
    if probs.dtype != torch.float32 or feats.dtype != torch.float32:
        raise TypeError("gated_crf: probs and feats must be float32")
    if feats.ndim != 4 or tuple(feats.shape[:3]) != (b, h, w):
        raise ValueError(f"gated_crf: probs {tuple(probs.shape)} and feats "
                         f"{tuple(feats.shape)} disagree")
    if feats.device != probs.device:
        raise ValueError("gated_crf: operands on different devices")
    if not (probs.is_contiguous() and feats.is_contiguous()):
        raise ValueError("gated_crf: operands must be contiguous")
    if (len(nf_splits) != nd or len(xy) != nd or sum(nf_splits) != f
            or any(n < 0 or (n == 0 and s == 0.0)
                   for n, s in zip(nf_splits, xy))):
        raise ValueError(f"gated_crf: feature split {list(nf_splits)} (xy "
                         f"{list(xy)}) does not cover {f} features of {nd} "
                         "descriptors")
    if not (1 <= c <= MAX_CLASSES and f <= MAX_FEATURES
            and 1 <= nd <= MAX_DESCRIPTORS and 1 <= b <= 65535):
        raise ValueError(
            f"gated_crf: {c} classes, {f} features, {nd} descriptors, batch "
            f"{b} exceed the kernel's limits ({MAX_CLASSES}, {MAX_FEATURES}, "
            f"{MAX_DESCRIPTORS}, 65535)")
    smem = _smem_bytes(c, f, nd, radius)
    if radius < 0 or smem > _MAX_SMEM:
        raise ValueError(f"gated_crf: radius {radius} needs {smem} bytes of "
                         f"shared memory (limit {_MAX_SMEM})")
    w_arr, xy_arr, desc_of = _desc_arrays(tuple(map(float, weights)),
                                          tuple(nf_splits), xy)
    lib = _build.lib("gated_crf")
    blocks = -(-h // _TILE[0]) * -(-w // _TILE[1])
    prod = torch.empty_like(probs)
    # ksum (B,) f64, then the f32 partials of sum k (B * blocks) behind it
    buf = torch.empty((b + -(-b * blocks // 2),), dtype=torch.float64,
                      device=probs.device)
    with _build.on_device(probs):
        err = lib.gated_crf_products(
            probs.data_ptr(), feats.data_ptr(), prod.data_ptr(),
            buf.data_ptr() + 8 * b, buf.data_ptr(), b, h, w, c, f, radius,
            nd, ctypes.addressof(w_arr), ctypes.addressof(xy_arr),
            ctypes.addressof(desc_of), _build.stream(probs))
    _build.check("gated_crf", "gated_crf", err)
    launches["gated_crf"] += 1
    return prod, buf[:b]


def gated_crf_products(probs, feats, radius, weights, nf_splits,
                       xy_sigmas=None):
    """probs (B,H,W,C) f32, feats (B,H,W,F) f32 (descriptor d owns the next
    nf_splits[d] channels, weighted weights[d]) -> (prod (B,H,W,C) f32,
    ksum (B,) f64). xy_sigmas (split_features): descriptor d also has the
    x, y meshes / xy_sigmas[d] (None: not), which feats do not hold; without
    it feats hold every feature. No autograd."""
    if probs.is_cuda:
        return _products_kernel(probs, feats, radius, weights, nf_splits,
                                 xy_sigmas)
    if probs.device.type == "cpu":
        return gated_crf_products_plain(probs, feats, radius, weights,
                                        nf_splits, xy_sigmas)
    raise RuntimeError(f"no gated_crf implementation for {probs.device}")


# ---- autograd --------------------------------------------------------------


def _loss_from_products(probs, prod, ksum):
    """(sum k - sum prod * probs) / (B H W), folded in f64, as f32."""
    b, h, w, _ = probs.shape
    total = ksum.sum() - (prod * probs).sum(dtype=torch.float64)
    return (total / (b * h * w)).float()


class _GatedCRF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, probs, feats, radius, weights, nf_splits, xy_sigmas):
        prod, ksum = gated_crf_products(probs, feats, radius, weights,
                                        nf_splits, xy_sigmas)
        ctx.save_for_backward(prod)
        return _loss_from_products(probs, prod, ksum)

    @staticmethod
    def backward(ctx, g):
        (prod,) = ctx.saved_tensors
        b, h, w, _ = prod.shape
        return (-2.0 * g / (b * h * w)) * prod, None, None, None, None, None


def gated_crf_loss(probs, image, kernels_desc=DEFAULT_KERNELS_DESC,
                   radius: int = 5, mask_src=None, mask_dst=None,
                   compatibility=None, custom_modality_downsamplers=None):
    """probs (B,H,W,C) softmax probabilities, image (B,H,W,Ci) -> the scalar
    loss. See the module docstring for the routes."""
    if any(a is not None for a in (mask_src, mask_dst, compatibility,
                                   custom_modality_downsamplers)):
        return gated_crf_loss_plain(
            probs, image, kernels_desc, radius, mask_src, mask_dst,
            compatibility, custom_modality_downsamplers)
    _, h, w, _ = probs.shape
    with torch.no_grad():
        feats, weights, nf_splits, xy = split_features(image, kernels_desc,
                                                       h, w)
    return _GatedCRF.apply(probs.float().contiguous(), feats, radius,
                           tuple(weights), tuple(nf_splits), tuple(xy))
