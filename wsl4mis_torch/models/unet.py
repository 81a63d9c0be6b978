"""2D U-Net and UNet_CCT (port of ``wsl4mis_tpu/models/unet.py``), NHWC.

* ConvBlock = conv3x3 -> BN -> LeakyReLU(0.01) -> dropout -> conv3x3 ->
  BN -> LeakyReLU. Encoder channels (16, 32, 64, 128, 256) with dropout
  (0.05, 0.1, 0.2, 0.3, 0.5) and 2x2 max-pool downsampling
  (``ops.maxpool``, on the NHWC tensor as it is); the decoder
  upsamples with a 2x2 stride-2 transposed conv, concatenates the skip
  and runs a dropout-free ConvBlock; a 3x3 head gives the logits.
* Every 3x3 conv (19 in a UNet) goes through ``ops.conv3x3``; in train
  mode a ConvBlock's convs are ``conv3x3_stats`` feeding FusedBatchNorm
  their output moments, so BN takes no separate statistics pass.
* The transposed conv is one matmul plus a pixel interleave, in the form
  of the JAX package's ``_MatmulConvTranspose``: output sub-pixel (a, b)
  takes tap K[1-a, 1-b] (lax.conv_transpose's mirrored kernel).
* Parameters are f32 in the flax layout (conv kernels HWIO (3,3,C,O),
  transposed-conv kernels (2,2,C,O)); compute runs in ``dtype`` and the
  logits come out f32. Initialization matches torch's defaults:
  U(+-1/sqrt(fan_in)) for weight and bias, with fan_in = O*4 for the
  transposed conv (torch reads it from weight dim 1).

Random draws (dropout masks, UNet_CCT channel-dropout masks) come from
the generators in ``rngs`` ({"dropout", "feature_perturb"}); UNetCCT also
takes the channel masks directly, so tests can inject them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import conv3x3, conv3x3_stats
from ..ops.maxpool import max_pool_2x2
from .norm import FusedBatchNorm

DEFAULT_FEATURES = (16, 32, 64, 128, 256)
DEFAULT_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


def _uniform(shape, bound, generator):
    return nn.Parameter(
        torch.empty(shape).uniform_(-bound, bound, generator=generator))


class Conv3x3(nn.Module):
    """3x3 SAME conv; kernel (3,3,C,O) and bias (O,) in f32."""

    def __init__(self, in_ch: int, out_ch: int, dtype, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * 9)
        self.dtype = dtype
        self.kernel = _uniform((3, 3, in_ch, out_ch), bound, generator)
        self.bias = _uniform((out_ch,), bound, generator)

    def forward(self, x, stats: bool = False):
        x = x.to(self.dtype).contiguous()
        k = self.kernel.to(self.dtype)
        b = self.bias.to(self.dtype)
        return conv3x3_stats(x, k, b) if stats else conv3x3(x, k, b)


class ConvTranspose2x2(nn.Module):
    """2x2 stride-2 transposed conv as one matmul + pixel interleave."""

    def __init__(self, in_ch: int, out_ch: int, dtype, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(out_ch * 2 * 2)
        self.dtype = dtype
        self.kernel = _uniform((2, 2, in_ch, out_ch), bound, generator)
        self.bias = _uniform((out_ch,), bound, generator)

    def forward(self, x):
        n, h, w, c = x.shape
        o = self.kernel.shape[3]
        km = (self.kernel.flip(0, 1).to(self.dtype)
              .permute(2, 0, 1, 3).reshape(c, 4 * o))
        # compute-dtype operands, f32 accumulation and bias, one rounding
        y = torch.matmul(x.to(self.dtype).float(), km.float())
        y = (y + self.bias.repeat(4)).to(self.dtype)  # (N,H,W,(a,b,o))
        y = y.view(n, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, 2 * h, 2 * w, o)


def channel_dropout(x, keep, rate: float = 0.5):
    """torch F.dropout2d with a given (N,1,1,C) keep mask."""
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).to(x.dtype)


def channel_dropout_mask(x, generator=None, rate: float = 0.5):
    """(N,1,1,C) bool keep mask, P(keep) = 1 - rate."""
    shape = (x.shape[0], 1, 1, x.shape[-1])
    u = torch.rand(shape, generator=generator, device=x.device)
    return u < (1.0 - rate)


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dropout_p: float, dtype,
                 generator=None):
        super().__init__()
        self.dropout_p = dropout_p
        self.dtype = dtype
        self.conv1 = Conv3x3(in_ch, out_ch, dtype, generator)
        self.bn1 = FusedBatchNorm(out_ch)
        self.conv2 = Conv3x3(out_ch, out_ch, dtype, generator)
        self.bn2 = FusedBatchNorm(out_ch)

    def _conv_bn(self, conv, bn, x, train):
        if train:
            y, s1, s2 = conv(x, stats=True)
            y = bn(y, train=True, moments=(s1, s2))
        else:
            y = bn(conv(x), train=False)
        return F.leaky_relu(y, 0.01)

    def forward(self, x, train: bool, generator=None):
        x = self._conv_bn(self.conv1, self.bn1, x, train)
        if self.dropout_p > 0 and train:
            keep = 1.0 - self.dropout_p
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = x * (mask.to(self.dtype) * (1.0 / keep))
        return self._conv_bn(self.conv2, self.bn2, x, train)


class Encoder(nn.Module):
    def __init__(self, in_ch: int, features: Sequence[int],
                 dropout: Sequence[float], dtype, generator=None):
        super().__init__()
        chans = [in_ch, *features]
        self.blocks = nn.ModuleList(
            ConvBlock(chans[i], features[i], dropout[i], dtype, generator)
            for i in range(len(features))
        )

    def forward(self, x, train: bool, generator=None):
        feats = []
        for i, block in enumerate(self.blocks):
            if i > 0:
                x = max_pool_2x2(x)
            x = block(x, train, generator)
            feats.append(x)
        return feats


class UpBlock(nn.Module):
    """Transposed-conv upsample of the deep path, concat skip, ConvBlock."""

    def __init__(self, deep_ch: int, skip_ch: int, out_ch: int, dtype,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.up = ConvTranspose2x2(deep_ch, skip_ch, dtype, generator)
        self.block = ConvBlock(2 * skip_ch, out_ch, 0.0, dtype, generator)

    def forward(self, x_deep, x_skip, train: bool):
        x = torch.cat([x_skip.to(self.dtype), self.up(x_deep)], dim=-1)
        return self.block(x, train)


class Decoder(nn.Module):
    def __init__(self, features: Sequence[int], num_classes: int, dtype,
                 generator=None):
        super().__init__()
        f = features
        self.ups = nn.ModuleList(
            UpBlock(f[i + 1], f[i], f[i], dtype, generator)
            for i in (3, 2, 1, 0)
        )
        self.head = Conv3x3(f[0], num_classes, dtype, generator)

    def forward(self, feats, train: bool):
        x = feats[-1]
        for up, skip in zip(self.ups, feats[-2::-1]):
            x = up(x, skip, train)
        return self.head(x).float()


def _gen(rngs, name):
    return None if rngs is None else rngs.get(name)


class UNet(nn.Module):
    def __init__(self, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        self.encoder = Encoder(in_ch, features, dropout, dtype, generator)
        self.decoder = Decoder(features, num_classes, dtype, generator)

    def forward(self, x, train: bool = False, rngs=None):
        feats = self.encoder(x, train, _gen(rngs, "dropout"))
        return self.decoder(feats, train)


class UNetCCT(nn.Module):
    """DMPLS's dual-branch net: main decoder + a decoder fed
    channel-dropped encoder features (train mode only)."""

    def __init__(self, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        self.encoder = Encoder(in_ch, features, dropout, dtype, generator)
        self.main_decoder = Decoder(features, num_classes, dtype, generator)
        self.aux_decoder1 = Decoder(features, num_classes, dtype, generator)

    def forward(self, x, train: bool = False, rngs=None, channel_masks=None):
        """channel_masks: optional list of (N,1,1,C) bool keep masks, one
        per encoder feature, in place of draws from
        rngs["feature_perturb"]."""
        feats = self.encoder(x, train, _gen(rngs, "dropout"))
        main = self.main_decoder(feats, train)
        if train:
            if channel_masks is None:
                gen = _gen(rngs, "feature_perturb")
                channel_masks = [channel_dropout_mask(f, gen) for f in feats]
            feats = [channel_dropout(f, m)
                     for f, m in zip(feats, channel_masks)]
        return main, self.aux_decoder1(feats, train)
