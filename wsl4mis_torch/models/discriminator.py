"""FCDiscriminator for adversarial semi-supervised training (port of
``wsl4mis_tpu/models/discriminator.py``; reference
networks/discriminator.py:58-101), NHWC; and FC3DDiscriminator, its 3D
counterpart (NDHWC).

Two 4x4 stride-2 pad-1 stems, on the softmax map and on the image, summed;
4x4 s2 convs to 2 ndf and 4 ndf, each followed by LeakyReLU(0.2) and, in
train mode only, channel dropout 0.5; a 4x4 s2 conv to 8 ndf and
LeakyReLU(0.2); an average pool with window and stride min(7, H) (7 at
256x256), VALID; flatten in (h, w, c) order; a 2-way dense head.

The convolutions are ``F.conv2d`` on channels-last views (the JAX package
runs them as XLA convolutions, not in a TPU kernel). Parameters are f32 in
the flax layout (conv kernels HWIO (4,4,C,O), dense kernel (in, 2)) with
torch-default init U(+-1/sqrt(fan_in)), fan_in = C*16 for a conv; compute
runs in ``dtype`` and the logits come out f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.params import zoo_key
from .layers import Conv, Dropout
from .unet import _gen, _uniform, channel_dropout, channel_dropout_mask


class Conv4x4s2(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * 16)
        self.dtype = dtype
        self.kernel = _uniform((4, 4, in_ch, out_ch), bound, generator)
        self.bias = _uniform((out_ch,), bound, generator)

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.kernel.to(self.dtype).permute(3, 2, 0, 1),
                     self.bias.to(self.dtype), stride=2, padding=1)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, dtype,
                 generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.dtype = dtype
        self.kernel = _uniform((in_features, out_features), bound, generator)
        self.bias = _uniform((out_features,), bound, generator)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(),
                        self.bias.to(self.dtype))


def _pool_window(h: int) -> int:
    return min(7, h)  # 7x7 at the reference 256x256 input


class FCDiscriminator(nn.Module):
    def __init__(self, num_classes: int = 4, patch_size=(256, 256),
                 ndf: int = 64, dtype=torch.bfloat16, generator=None):
        super().__init__()
        chans = ((num_classes, ndf), (1, ndf), (ndf, 2 * ndf),
                 (2 * ndf, 4 * ndf), (4 * ndf, 8 * ndf))
        self.convs = nn.ModuleList(Conv4x4s2(c, o, dtype, generator)
                                   for c, o in chans)
        h, w = (s // 16 for s in patch_size)  # four pad-1 stride-2 convs
        k = _pool_window(h)
        self.dense = Dense((h // k) * (w // k) * 8 * ndf, 2, dtype,
                           generator)

    def forward(self, seg_map, image, train: bool = False, generator=None,
                channel_masks=None):
        """seg_map (B,H,W,C) softmax, image (B,H,W,1) -> (B,2) f32 logits.
        In train mode the two channel dropouts draw their (B,1,1,C) keep
        masks from `generator`, or take `channel_masks`."""
        x = self.convs[0](seg_map) + self.convs[1](image)
        for i, conv in enumerate(self.convs[2:4]):
            x = F.leaky_relu(conv(x), 0.2)
            if train:
                keep = (channel_dropout_mask(x, generator)
                        if channel_masks is None else channel_masks[i])
                x = channel_dropout(x, keep)
        x = F.leaky_relu(self.convs[4](x), 0.2)
        k = _pool_window(x.shape[1])
        x = F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride=k)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense(x).float()


class FC3DDiscriminator(nn.Module):
    """The 3D volume discriminator (reference networks/discriminator.py:
    6-55), NDHWC: 4x4x4 stride-2 pad-1 stems on the segmentation map and
    on the image, summed; convs to 2, 4 and 8 ndf; LeakyReLU(0.2) after
    each, channel dropout 0.5 after the first three in train mode (masks
    from rngs["feature_perturb"] or ``channel_masks``); an average pool
    with window and stride min(6, D) (6 at the reference 96^3); a 2-way
    dense head, f32 logits. Convolutions are cuDNN's ``F.conv3d``
    (``layers.Conv``), torch-default init; submodules named after flax's
    kinds (``conv.k``, ``dense.0``)."""

    flax_key = staticmethod(zoo_key)

    def __init__(self, num_classes: int = 2, ndf: int = 64,
                 patch_size=(96, 96, 96), dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        chans = ((num_classes, ndf), (1, ndf), (ndf, 2 * ndf),
                 (2 * ndf, 4 * ndf), (4 * ndf, 8 * ndf))
        self.conv = nn.ModuleList(
            Conv(c, o, (4, 4, 4), 2, bias=True, padding=1, dtype=dtype,
                 generator=generator, init="torch") for c, o in chans)
        d, h, w = (s // 16 for s in patch_size)  # four stride-2 convs
        k = min(6, d)
        self.dense = nn.ModuleList([Dense(
            (d // k) * (h // k) * (w // k) * 8 * ndf, 2, dtype, generator)])

    def forward(self, seg_map, image, train: bool = False, rngs=None,
                channel_masks=None):
        """seg_map (B,D,H,W,C), image (B,D,H,W,1) -> (B,2) f32 logits;
        channel_masks: three (B,1,1,1,C) keep masks in place of the
        draws."""
        drop = Dropout(_gen(rngs, "feature_perturb"), channel_masks)

        def act(z, dropped):
            z = F.leaky_relu(z, 0.2)
            return drop(z, 0.5, channel=True) if dropped and train else z

        x = act(self.conv[0](seg_map) + self.conv[1](image), True)
        x = act(self.conv[2](x), True)
        x = act(self.conv[3](x), True)
        x = act(self.conv[4](x), False)
        k = min(6, x.shape[1])
        x = F.avg_pool3d(x.permute(0, 4, 1, 2, 3), k, stride=k)
        x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        return self.dense[0](x).float()
