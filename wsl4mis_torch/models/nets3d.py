"""The 3D segmentation nets (port of ``wsl4mis_tpu/models/nets3d.py``),
NDHWC, built by ``net_factory_3d``:

* UNet3D: UnetConv3 stages (3x3x3 conv + InstanceNorm + ReLU, twice) at
  filters (64, 128, 256, 512, 1024) / 4, 2x2x2 max-pool downsampling, a
  trilinear x2 upsample + concat decoder, dropout 0.3 at the centre and
  before the 1x1x1 head.
* AttentionUNet3D: the same trunk with grid-attention gated skips (two
  gates fused by 1x1x1 conv + BN + ReLU) and deep supervision (1x1x1 heads
  upsampled trilinearly, fused by a last 1x1x1 conv).
* VNet: five levels of (1, 2, 3, 3, 3) conv + norm + ReLU stages,
  stride-2 2x2x2 conv down, transposed conv up, additive skips, channel
  dropout 0.5 on the deepest and the last features; the norm is BatchNorm
  (net_factory_3d's), GroupNorm (16 groups), InstanceNorm or none.
* VoxResNet: pre-activation residual blocks (InstanceNorm + ReLU + 3x3x3
  conv, bias-free) at three scales, trilinear (align_corners) upsampling.

Numerics follow the JAX package: InstanceNorm is torch's affine-free one
(f32 statistics, ``layers.instance_norm``); BatchNorm is flax's (f32,
momentum 0.9, eps 1e-5), cast before the ReLU, and GroupNorm flax's (f32,
eps 1e-6, ``layers.GroupNorm``); trilinear upsampling is
``layers.interp_axis`` along each axis in turn; kernels are kaiming-normal
(fan in) in flax's DHWIO layout, biases zero. The convolutions are
cuDNN's (``F.conv3d``; 1x1x1: matmuls), as they are XLA's in the JAX
package.

Each model holds its submodules in lists named after flax's module kinds
in flax's call order (``utils.params.zoo_key`` maps a flax tree onto it).
Dropout masks come from rngs["dropout"] in the forward's order, or are
given as ``drop_masks``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.params import zoo_key
from .layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dropout,
    GroupNorm,
    instance_norm,
    interp_axis,
)
from .unet import _gen


def _conv3(c, o, kernel=(3, 3, 3), stride=1, bias=True, padding="SAME",
           dtype=torch.bfloat16, generator=None):
    return Conv(c, o, kernel, stride, bias=bias, padding=padding,
                dtype=dtype, generator=generator, init="kaiming")


def _one(k=1):
    return (k, k, k)


def upsample3d(x, factor: int = 2, align_corners: bool = False):
    """Trilinear upsampling of NDHWC by an integer factor."""
    for axis in (1, 2, 3):
        x = interp_axis(x, axis, x.shape[axis] * factor, align_corners)
    return x


def resize3d(x, size, align_corners: bool = False):
    for axis, n in zip((1, 2, 3), size):
        x = interp_axis(x, axis, n, align_corners)
    return x


def maxpool3d(x):
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2)
    return y.permute(0, 2, 3, 4, 1)


class UnetConv3(nn.Module):
    """Two (conv3x3x3 -> InstanceNorm -> ReLU) stages."""

    def __init__(self, in_ch, features, dtype, generator=None):
        super().__init__()
        self.conv3 = nn.ModuleList(
            _conv3(c, features, dtype=dtype, generator=generator)
            for c in (in_ch, features))

    def forward(self, x):
        for conv in self.conv3:
            x = F.relu(instance_norm(conv(x)))
        return x


class UnetUp3CT(nn.Module):
    """Trilinear x2 upsample of the deep path, concat the skip, UnetConv3."""

    def __init__(self, skip_ch, deep_ch, features, dtype, generator=None):
        super().__init__()
        self.unet_conv3 = nn.ModuleList(
            [UnetConv3(skip_ch + deep_ch, features, dtype, generator)])

    def forward(self, skip, deep):
        x = torch.cat([skip, upsample3d(deep, 2)], dim=-1)
        return self.unet_conv3[0](x)


def _filters(feature_scale):
    return [int(c / feature_scale) for c in (64, 128, 256, 512, 1024)]


class _Trunk(nn.Module):
    """UnetConv3 encoder stages c1..center of UNet3D / AttentionUNet3D."""

    def _build_trunk(self, in_ch, f, dtype, generator):
        chans = [in_ch] + f[:-1]
        self.unet_conv3 = nn.ModuleList(
            UnetConv3(c, o, dtype, generator) for c, o in zip(chans, f))

    def _encode(self, x):
        feats = [self.unet_conv3[0](x)]
        for block in self.unet_conv3[1:]:
            feats.append(block(maxpool3d(feats[-1])))
        return feats


class UNet3D(_Trunk):
    flax_key = staticmethod(zoo_key)

    def __init__(self, num_classes: int = 2, feature_scale: int = 4,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        f = _filters(feature_scale)
        self._build_trunk(in_ch, f, dtype, generator)
        self.unet_up3_ct = nn.ModuleList(
            UnetUp3CT(f[i], f[i + 1], f[i], dtype, generator)
            for i in (3, 2, 1, 0))
        self.conv3 = nn.ModuleList([_conv3(f[0], num_classes, _one(),
                                           dtype=dtype, generator=generator)])

    def forward(self, x, train: bool = False, rngs=None, drop_masks=None):
        """drop_masks: optional two element keep masks (centre, last
        decoder feature) in place of the draws from rngs["dropout"]."""
        drop = Dropout(_gen(rngs, "dropout"), drop_masks)
        c1, c2, c3, c4, center = self._encode(x)
        if train:
            center = drop(center, 0.3)
        u = center
        for up, skip in zip(self.unet_up3_ct, (c4, c3, c2, c1)):
            u = up(skip, u)
        if train:
            u = drop(u, 0.3)
        return self.conv3[0](u).float()


class GridAttentionBlock3D(nn.Module):
    """The 'concatenation' grid-attention gate: (gated x, attention)."""

    def __init__(self, in_ch, gate_ch, inter_channels, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.conv3 = nn.ModuleList([
            _conv3(in_ch, inter_channels, _one(2), 2, bias=False,
                   padding="VALID", **kw),
            _conv3(gate_ch, inter_channels, _one(), **kw),
            _conv3(inter_channels, 1, _one(), **kw),
            _conv3(in_ch, in_ch, _one(), **kw)])
        self.batch_norm = nn.ModuleList([BatchNorm(in_ch)])

    def forward(self, x, g, train: bool):
        theta, phi, psi, w = self.conv3
        theta_x = theta(x)
        phi_g = resize3d(phi(g), theta_x.shape[1:4])
        att = torch.sigmoid(psi(F.relu(theta_x + phi_g)))
        att = resize3d(att, x.shape[1:4])
        w_y = self.batch_norm[0](w(att * x), train).to(self.dtype)
        return w_y, att


class MultiAttentionBlock(nn.Module):
    """Two gates fused by 1x1x1 conv + BN + ReLU."""

    def __init__(self, in_ch, gate_ch, inter_channels, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.grid_attention_block3_d = nn.ModuleList(
            GridAttentionBlock3D(in_ch, gate_ch, inter_channels, dtype,
                                 generator) for _ in range(2))
        self.conv3 = nn.ModuleList([_conv3(2 * in_ch, in_ch, _one(),
                                           dtype=dtype, generator=generator)])
        self.batch_norm = nn.ModuleList([BatchNorm(in_ch)])

    def forward(self, x, g, train: bool):
        (g1, a1), (g2, a2) = (gate(x, g, train)
                              for gate in self.grid_attention_block3_d)
        h = self.batch_norm[0](self.conv3[0](torch.cat([g1, g2], -1)), train)
        return F.relu(h).to(self.dtype), torch.cat([a1, a2], -1)


class AttentionUNet3D(_Trunk):
    flax_key = staticmethod(zoo_key)

    def __init__(self, num_classes: int = 2, feature_scale: int = 4,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        f = _filters(feature_scale)
        kw = dict(dtype=dtype, generator=generator)
        self._build_trunk(in_ch, f, dtype, generator)
        # gates at levels 3, 2, 1, each gated by the level below
        self.multi_attention_block = nn.ModuleList(
            MultiAttentionBlock(f[i], f[i + 1], f[i], dtype, generator)
            for i in (3, 2, 1))
        self.unet_up3_ct = nn.ModuleList(
            UnetUp3CT(f[i], f[i + 1], f[i], dtype, generator)
            for i in (3, 2, 1, 0))
        self.conv3 = nn.ModuleList(
            [_conv3(f[4], f[4], _one(), **kw)]  # the gating signal
            + [_conv3(f[i], num_classes, _one(), **kw) for i in (3, 2, 1, 0)]
            + [_conv3(4 * num_classes, num_classes, _one(), **kw)])

    def forward(self, x, train: bool = False, rngs=None):
        c1, c2, c3, c4, center = self._encode(x)
        gating_conv, *dsv, fuse = self.conv3
        gating = F.relu(instance_norm(gating_conv(center)))
        ups, gates = self.unet_up3_ct, self.multi_attention_block
        g4, _ = gates[0](c4, gating, train)
        u4 = ups[0](g4, center)
        g3, _ = gates[1](c3, u4, train)
        u3 = ups[1](g3, u4)
        g2, _ = gates[2](c2, u3, train)
        u2 = ups[2](g2, u3)
        u1 = ups[3](c1, u2)
        d = [upsample3d(head(z), s) for head, z, s in
             zip(dsv[:3], (u4, u3, u2), (8, 4, 2))]
        d1 = dsv[3](u1)
        return fuse(torch.cat([d1, d[2], d[1], d[0]], -1)).float()


# (stages, filter multiple) of VNet's encoder levels; the decoder mirrors
_VNET_LEVELS = ((1, 1), (2, 2), (3, 4), (3, 8), (3, 16))
# VNet's module list of each normalization with parameters
_NORM_LISTS = {"batchnorm": "batch_norm", "groupnorm": "group_norm"}


class VNet(nn.Module):
    """VNet; the modules in flax's order: per level its down conv (levels
    2-5), then its stage convs, each conv with its norm; per decoder level
    the transposed conv (with its norm), then its stages; the 1x1x1 head.
    normalization: "batchnorm" (net_factory_3d's; flax's BatchNorm_k, in
    ``batch_norm``), "groupnorm" (GroupNorm_k, 16 groups, in
    ``group_norm``), "instancenorm" (instance_norm, no parameters) or any
    other string, none, as in the JAX package."""

    flax_key = staticmethod(zoo_key)

    def __init__(self, num_classes: int = 2, n_filters: int = 16,
                 normalization: str = "batchnorm", has_dropout: bool = True,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        self.dtype = dtype
        self.normalization = normalization
        self.has_dropout = has_dropout
        layer = {"batchnorm": BatchNorm,
                 "groupnorm": lambda c: GroupNorm(c, num_groups=16)}.get(
            normalization)
        kw = dict(dtype=dtype, generator=generator)
        convs, norms, ups = [], [], []
        ch = in_ch
        for level, (stages, mult) in enumerate(_VNET_LEVELS):
            feat = n_filters * mult
            if level:
                convs.append(_conv3(ch, feat, _one(2), 2, padding="VALID",
                                    **kw))
                norms.append(feat)
                ch = feat
            for _ in range(stages):
                convs.append(_conv3(ch, feat, **kw))
                norms.append(feat)
                ch = feat
        for stages, mult in _VNET_LEVELS[-2::-1]:
            feat = n_filters * mult
            ups.append(ConvTranspose(ch, feat, _one(2), 2, init="kaiming",
                                     **kw))
            norms.append(feat)
            for _ in range(stages):
                convs.append(_conv3(feat, feat, **kw))
                norms.append(feat)
            ch = feat
        convs.append(_conv3(ch, num_classes, _one(), **kw))
        self.conv3 = nn.ModuleList(convs)
        if layer is not None:
            setattr(self, _NORM_LISTS[normalization],
                    nn.ModuleList(layer(c) for c in norms))
        self.conv_transpose = nn.ModuleList(ups)

    def forward(self, x, train: bool = False, rngs=None,
                turnoff_drop: bool = False, drop_masks=None):
        """drop_masks: optional two (N,1,1,1,C) keep masks (the deepest and
        the last features) in place of the draws from rngs["dropout"]."""
        convs, ups = iter(self.conv3), iter(self.conv_transpose)
        name = _NORM_LISTS.get(self.normalization)
        norms = iter(getattr(self, name) if name else ())
        drop = Dropout(_gen(rngs, "dropout"), drop_masks)
        dropping = self.has_dropout and train and not turnoff_drop

        def norm(z):
            if self.normalization == "batchnorm":
                return next(norms)(z, train)
            if self.normalization == "groupnorm":
                return next(norms)(z)
            if self.normalization == "instancenorm":
                return instance_norm(z)
            return z

        def norm_relu(z):
            return F.relu(norm(z).to(self.dtype))

        def stages(z, n):
            for _ in range(n):
                z = norm_relu(next(convs)(z))
            return z

        skips = []
        for level, (n, _) in enumerate(_VNET_LEVELS):
            if level:
                x = norm_relu(next(convs)(x))
            x = stages(x, n)
            skips.append(x)
        if dropping:
            x = drop(x, 0.5, channel=True)
        for (n, _), skip in zip(_VNET_LEVELS[-2::-1], skips[-2::-1]):
            x = stages(norm_relu(next(ups)(x)) + skip, n)
        if dropping:
            x = drop(x, 0.5, channel=True)
        return next(convs)(x).float()


class VoxRex(nn.Module):
    """Pre-activation residual block (IN + ReLU + bias-free 3x3x3, twice)."""

    def __init__(self, features, dtype, generator=None):
        super().__init__()
        self.conv3 = nn.ModuleList(
            _conv3(features, features, bias=False, dtype=dtype,
                   generator=generator) for _ in range(2))

    def forward(self, x):
        h = x
        for conv in self.conv3:
            h = conv(F.relu(instance_norm(h)))
        return h + x


class VoxResNet(nn.Module):
    flax_key = staticmethod(zoo_key)

    def __init__(self, num_classes: int = 2, feature_chns: int = 64,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        fc = feature_chns
        kw = dict(dtype=dtype, generator=generator)
        self.conv3 = nn.ModuleList(
            [_conv3(in_ch, fc, **kw)]
            + [_conv3(c, fc, bias=False, **kw)
               for c in (2 * fc, fc, 2 * fc, fc)]
            + [_conv3(fc, num_classes, _one(), **kw)])
        self.vox_rex = nn.ModuleList(VoxRex(fc, dtype, generator)
                                     for _ in range(6))

    def forward(self, x, train: bool = False, rngs=None):
        stem, p1, p2, q1, q2, head = self.conv3
        rex = self.vox_rex
        x0 = maxpool3d(stem(x))
        x2 = rex[1](rex[0](x0))
        x2_pool = maxpool3d(x2)
        x4 = maxpool3d(rex[3](rex[2](x2_pool)))
        x6 = rex[5](rex[4](x4))

        def preact(z, c1, c2):
            z = c1(F.relu(instance_norm(z)))
            return c2(F.relu(instance_norm(z)))

        u1 = preact(torch.cat([x2_pool, upsample3d(x6, 2, True)], -1), p1, p2)
        u2 = preact(torch.cat([x0, upsample3d(u1, 2, True)], -1), q1, q2)
        return head(upsample3d(u2, 2, True)).float()


def net_factory_3d(net_type: str = "unet_3D", class_num: int = 2,
                   dtype=torch.bfloat16, generator=None, **kwargs):
    """unet_3D, attention_unet, voxresnet (64 features) or vnet (BatchNorm,
    dropout), on the CPU (net_factory_3d.py:7-20)."""
    classes = {"unet_3D": UNet3D, "attention_unet": AttentionUNet3D,
               "voxresnet": VoxResNet, "vnet": VNet}
    try:
        cls = classes[net_type]
    except KeyError:
        raise KeyError(f"unknown 3D net_type {net_type!r}; available: "
                       f"{sorted(classes)}") from None
    model = cls(num_classes=class_num, dtype=dtype, generator=generator,
                **kwargs)
    model.rebuild = functools.partial(net_factory_3d, net_type, class_num,
                                      dtype, **kwargs)
    return model
