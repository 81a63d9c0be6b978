"""PNet2D, the DeepIGeoS P-Net (port of ``wsl4mis_tpu/models/pnet.py``),
NHWC.

Five PNetBlocks at dilations 1, 2, 4, 8, 16 (each two dilated 3x3 convs,
every one followed by BatchNorm and LeakyReLU(0.01)) at 64 filters, the
five outputs concatenated, a 1x1 fusion (two 1x1 convs with LeakyReLU),
and the output block: Dropout2d(0.3) -> 1x1 -> LeakyReLU -> Dropout2d(0.3)
-> 1x1 logits (the dropouts in train mode only).

The dilated convs are ``F.conv2d(dilation=d, padding=d)`` and the 1x1
convs matmuls (``layers.Conv``), cuDNN's and cuBLAS's as they are XLA's in
the JAX package; every conv has a bias and torch's default init, U(+-1 /
sqrt(fan in)). BatchNorm is flax's ``nn.BatchNorm(dtype=float32)``
(momentum 0.9, eps 1e-5): statistics and output in f32, the LeakyReLU in
f32, then the cast to the compute dtype.

The output block's channel-dropout masks come from rngs["feature_perturb"]
(the first, then the second), or are given as ``channel_masks``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.params import zoo_key
from .layers import BatchNorm, Conv, Dropout
from .unet import _gen


class PNetBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, dilation: int, dtype,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.dilated_conv = nn.ModuleList(
            Conv(c, features, (3, 3), bias=True, padding=dilation,
                 dtype=dtype, generator=generator, dilation=dilation,
                 init="torch")
            for c in (in_ch, features))
        self.batch_norm = nn.ModuleList(BatchNorm(features) for _ in range(2))

    def forward(self, x, train: bool):
        for conv, bn in zip(self.dilated_conv, self.batch_norm):
            x = F.leaky_relu(bn(conv(x), train), 0.01).to(self.dtype)
        return x


class PNet2D(nn.Module):
    flax_key = staticmethod(zoo_key)

    def __init__(self, num_classes: int = 4, num_filters: int = 64,
                 ratios: Sequence[int] = (1, 2, 4, 8, 16),
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        self.dtype = dtype
        nf = num_filters
        chans = [in_ch] + [nf] * (len(ratios) - 1)
        self.pnet_block = nn.ModuleList(
            PNetBlock(c, nf, r, dtype, generator)
            for c, r in zip(chans, ratios))
        widths = (nf * len(ratios), nf * 5, nf * 2, nf, num_classes)
        self.torch_conv = nn.ModuleList(
            Conv(c, o, (1, 1), bias=True, dtype=dtype, generator=generator,
                 init="torch")
            for c, o in zip(widths[:-1], widths[1:]))

    def _act(self, x):
        return F.leaky_relu(x, 0.01).to(self.dtype)

    def forward(self, x, train: bool = False, rngs=None, channel_masks=None):
        """channel_masks: optional two (N,1,1,C) bool keep masks in place of
        the draws from rngs["feature_perturb"]."""
        feats = []
        h = x
        for block in self.pnet_block:
            h = block(h, train)
            feats.append(h)
        h = torch.cat(feats, dim=-1)
        fuse1, fuse2, out1, logits = self.torch_conv
        h = self._act(fuse2(self._act(fuse1(h))))
        if train:
            drop = Dropout(_gen(rngs, "feature_perturb"), channel_masks)
            h = drop(self._act(out1(drop(h, 0.3, channel=True))), 0.3,
                     channel=True)
        else:
            h = self._act(out1(h))
        return logits(h).float()
