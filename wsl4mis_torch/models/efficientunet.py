"""EfficientNet-UNet, ``efficient_unet`` in the factory (port of
``wsl4mis_tpu/models/efficientunet.py``), NHWC.

An EfficientNet-B0..B7 encoder (compound scaling: ``round_filters`` /
``round_repeats``; MBConv blocks with expansion, depthwise conv,
squeeze-excite 0.25 and projection; swish; stochastic depth ramped
linearly to the model's drop-connect rate over the blocks) with feature
taps at strides 2 / 4 / 8 / 16 / 32, and a U-Net decoder of nearest x2
upsampling DecoderBlocks (3x3 conv + BN + ReLU twice, optional scSE
attention) over (256, 128, 64, 32, 16) channels, then a 1x1 classifier.

Numerics follow the JAX package: "SAME" padding as XLA's (a stride-2
window on an even size pads more on the high side: ``layers.same_pads``
with an explicit pad); BatchNorm is flax's with momentum 0.99 (torch's
0.01) and eps 1e-3, statistics and output in f32, swish / ReLU in f32
before the cast to the compute dtype; the squeeze-excite and scSE means
reduce in f32 and round to the compute dtype. Depthwise kernels are
flax's (k, k, 1, C), run as ``groups=C`` convs. Convolutions are cuDNN's
(1x1: matmuls), as they are XLA's in the JAX package; flax's default init
(lecun normal, zero bias).

Drop-connect masks come from rngs["dropout"], one per sample of each
residual block with a non-zero rate, in block order, or are given as
``drop_masks``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.params import zoo_key
from .layers import BatchNorm, Conv, drop_path, upsample_nearest
from .unet import _gen

# (width_coefficient, depth_coefficient, drop_connect_rate)
SCALING = {
    "efficientnet-b0": (1.0, 1.0, 0.2),
    "efficientnet-b1": (1.0, 1.1, 0.2),
    "efficientnet-b2": (1.1, 1.2, 0.3),
    "efficientnet-b3": (1.2, 1.4, 0.3),
    "efficientnet-b4": (1.4, 1.8, 0.4),
    "efficientnet-b5": (1.6, 2.2, 0.4),
    "efficientnet-b6": (1.8, 2.6, 0.5),
    "efficientnet-b7": (2.0, 3.1, 0.5),
}

# (expand_ratio, kernel, stride, in_filters, out_filters, repeats)
BASE_BLOCKS = (
    (1, 3, 1, 32, 16, 1),
    (6, 3, 2, 16, 24, 2),
    (6, 5, 2, 24, 40, 2),
    (6, 3, 2, 40, 80, 3),
    (6, 5, 1, 80, 112, 3),
    (6, 5, 2, 112, 192, 4),
    (6, 3, 1, 192, 320, 1),
)
TAP_GROUPS = (1, 2, 4, 6)  # the stride 4 / 8 / 16 / 32 taps follow these


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _bn(ch):
    return BatchNorm(ch, momentum=0.99, epsilon=1e-3)


def _mean_hw(x):
    return x.float().mean((1, 2), keepdim=True).to(x.dtype)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, expand_ratio: int, kernel: int,
                 stride: int, out_filters: int, drop_rate: float, dtype,
                 generator=None, se_ratio: float = 0.25):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.residual = stride == 1 and in_ch == out_filters
        ch = in_ch * expand_ratio
        se_ch = max(1, int(in_ch * se_ratio))

        def conv(c, o, k=1, s=1, bias=False, groups=1):
            return Conv(c, o, (k, k), s, bias=bias, dtype=dtype,
                        generator=generator, groups=groups, init="lecun")

        convs = [conv(in_ch, ch)] if expand_ratio != 1 else []
        convs += [conv(ch, ch, kernel, stride, groups=ch),
                  conv(ch, se_ch, bias=True), conv(se_ch, ch, bias=True),
                  conv(ch, out_filters)]
        self.conv = nn.ModuleList(convs)
        self.batch_norm = nn.ModuleList(
            _bn(c) for c in ([ch] if expand_ratio != 1 else [])
            + [ch, out_filters])

    def forward(self, x, train: bool, generator=None, keep=None):
        convs, bns = list(self.conv), list(self.batch_norm)
        h = x
        if len(convs) == 5:  # expansion
            h = F.silu(bns.pop(0)(convs.pop(0)(h), train)).to(self.dtype)
        dw, se_reduce, se_expand, project = convs
        h = F.silu(bns[0](dw(h), train)).to(self.dtype)
        s = F.silu(se_reduce(_mean_hw(h)))
        h = h * torch.sigmoid(se_expand(s))
        h = bns[1](project(h), train).to(self.dtype)
        if self.residual:
            if train and self.drop_rate > 0:
                h = drop_path(h, self.drop_rate, generator, keep)
            h = h + x
        return h


class EfficientNetEncoder(nn.Module):
    """[x, stem, s4, s8, s16, s32] feature taps; ``channels`` lists their
    widths (x's included)."""

    def __init__(self, model_name: str = "efficientnet-b3", in_ch: int = 1,
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.dtype = dtype
        width, depth, drop_connect = SCALING[model_name]
        stem = round_filters(32, width)
        self.conv = nn.ModuleList([Conv(in_ch, stem, (3, 3), 2, dtype=dtype,
                                        generator=generator, init="lecun")])
        self.batch_norm = nn.ModuleList([_bn(stem)])
        repeats = [round_repeats(r, depth) for *_, r in BASE_BLOCKS]
        total = sum(repeats)
        blocks, self.taps = [], []
        self.channels = [in_ch, stem]
        ch = stem
        for gi, (e, k, s, _fin, fout, _r) in enumerate(BASE_BLOCKS):
            out = round_filters(fout, width)
            for j in range(repeats[gi]):
                rate = drop_connect * len(blocks) / total
                blocks.append(MBConv(ch, e, k, s if j == 0 else 1, out, rate,
                                     dtype, generator))
                ch = out
            if gi in TAP_GROUPS:
                self.taps.append(len(blocks) - 1)
                self.channels.append(ch)
        self.mbconv = nn.ModuleList(blocks)

    def forward(self, x, train: bool, generator=None, drop_masks=None):
        masks = None if drop_masks is None else iter(drop_masks)
        feats = [x]
        h = F.silu(self.batch_norm[0](self.conv[0](x), train)).to(self.dtype)
        feats.append(h)
        for i, block in enumerate(self.mbconv):
            keep = None
            if masks is not None and train and block.residual \
                    and block.drop_rate > 0:
                keep = next(masks)
            h = block(h, train, generator, keep)
            if i in self.taps:
                feats.append(h)
        return feats


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_channels: int,
                 attention: str | None, dtype, generator=None):
        super().__init__()
        self.dtype = dtype
        self.attention = attention
        self.skip = skip_ch > 0

        def conv(c, o, k=1, bias=True):
            return Conv(c, o, (k, k), bias=bias, dtype=dtype,
                        generator=generator, init="lecun")

        def scse(c):
            return [conv(c, max(1, c // 16)), conv(max(1, c // 16), c),
                    conv(c, 1)] if attention == "scse" else []

        cat = in_ch + skip_ch
        convs = [conv(cat, out_channels, 3, False),
                 conv(out_channels, out_channels, 3, False)]
        convs = (scse(cat) + convs) if self.skip else (convs
                                                       + scse(out_channels))
        self.conv = nn.ModuleList(convs)
        self.batch_norm = nn.ModuleList(_bn(out_channels) for _ in range(2))

    def _attend(self, x, convs):
        if self.attention != "scse":
            return x
        reduce, expand, spatial = convs
        s = torch.sigmoid(expand(F.relu(reduce(_mean_hw(x)))))
        return x * s + x * torch.sigmoid(spatial(x))

    def forward(self, x, skip, train: bool):
        x = upsample_nearest(x, 2)
        convs = list(self.conv)
        n_att = len(convs) - 2
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
            x = self._attend(x, convs[:n_att])
            convs = convs[n_att:]
        for conv, bn in zip(convs[:2], self.batch_norm):
            x = F.relu(bn(conv(x), train)).to(self.dtype)
        if skip is None:
            x = self._attend(x, convs[2:])
        return x


class EffiUNet(nn.Module):
    flax_key = staticmethod(zoo_key)

    def __init__(self, num_classes: int = 4,
                 encoder_name: str = "efficientnet-b3",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 attention: str | None = None, dtype=torch.bfloat16,
                 in_ch: int = 1, generator=None):
        super().__init__()
        self.dtype = dtype
        enc = EfficientNetEncoder(encoder_name, in_ch, dtype, generator)
        self.efficient_net_encoder = nn.ModuleList([enc])
        skips = enc.channels[1:-1][::-1]  # s16, s8, s4, stem
        blocks, ch = [], enc.channels[-1]
        for i, out in enumerate(decoder_channels):
            skip = skips[i] if i < len(skips) else 0
            blocks.append(DecoderBlock(ch, skip, out, attention, dtype,
                                       generator))
            ch = out
        self.decoder_block = nn.ModuleList(blocks)
        self.conv = nn.ModuleList([Conv(ch, num_classes, (1, 1), bias=True,
                                        dtype=dtype, generator=generator,
                                        init="lecun")])

    def forward(self, x, train: bool = False, rngs=None, drop_masks=None):
        """drop_masks: optional (N,1,1,1) bool keep masks of the residual
        blocks that drop, in block order, in place of the draws from
        rngs["dropout"]."""
        feats = self.efficient_net_encoder[0](
            x.to(self.dtype), train, _gen(rngs, "dropout"), drop_masks)
        feats = feats[1:][::-1]
        h, skips = feats[0], feats[1:]
        for i, block in enumerate(self.decoder_block):
            h = block(h, skips[i] if i < len(skips) else None, train)
        return self.conv[0](h).float()
