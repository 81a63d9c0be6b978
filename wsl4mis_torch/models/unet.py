"""The 2D U-Net family (port of ``wsl4mis_tpu/models/unet.py``), NHWC:
UNet, UNet_CCT, UNet_CCT_3H, UNet_DS and UNet_URDS.

* ConvBlock = conv3x3 -> BN -> LeakyReLU(0.01) -> dropout -> conv3x3 ->
  BN -> LeakyReLU. Encoder channels (16, 32, 64, 128, 256) with dropout
  (0.05, 0.1, 0.2, 0.3, 0.5) and 2x2 max-pool downsampling
  (``ops.maxpool``, on the NHWC tensor as it is); the decoder
  upsamples with a 2x2 stride-2 transposed conv, concatenates the skip
  and runs a dropout-free ConvBlock; a 3x3 head gives the logits.
* Every 3x3 conv (19 in a UNet) goes through ``ops.conv3x3``. A
  ConvBlock layer's conv -> BN -> LeakyReLU (-> dropout) runs fused
  (``ops.bn_act``: kernels on a card, their plain versions on the CPU);
  in train mode its conv hands BN its output moments, so BN takes no
  separate statistics pass.
* The transposed conv is one matmul plus a pixel interleave, in the form
  of the JAX package's ``_MatmulConvTranspose``: output sub-pixel (a, b)
  takes tap K[1-a, 1-b] (lax.conv_transpose's mirrored kernel).
* Parameters are f32 in the flax layout (conv kernels HWIO (3,3,C,O),
  transposed-conv kernels (2,2,C,O)); compute runs in ``dtype`` and the
  logits come out f32. Initialization matches torch's defaults:
  U(+-1/sqrt(fan_in)) for weight and bias, with fan_in = O*4 for the
  transposed conv (torch reads it from weight dim 1).

* UNet_DS (and UNet_URDS) decode with a 3x3 head at every scale; the
  coarse heads' logits are repeated up to the input size (nearest, source
  index i // f as ``jax.image.resize``'s) and then cast to f32; the four
  outputs come as (dp0, dp1, dp2, dp3), full scale first. The heads are
  ``Conv3x3``s, so they run the conv kernels as the decoder's head does.
* UNet_URDS perturbs the decoder's features before the coarse heads in
  train mode: channel dropout at 1/8, feature dropout at 1/4, feature
  noise at 1/2 (unet.py:797-808).
* UNet_CCT_3H adds a third decoder, ``aux_decoder2``, fed the feature
  noise of each encoder feature (the JAX package's reading of the
  reference, whose forward reuses aux_decoder1 there).

Random draws (dropout masks, channel-dropout masks, feature noise, the
feature-dropout cut) come from the generators in ``rngs`` ({"dropout",
"feature_perturb"}); the models also take the perturbations' draws
directly, so tests can inject them. A per-sample draw is made at the
global batch's shape and cut to the rank's rows (``parallel.local_rows``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .. import parallel
from ..ops import bn_act
from ..ops.conv3x3 import conv3x3
from ..ops.maxpool import max_pool_2x2
from .layers import upsample_nearest
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

    def operands(self, x):
        """x (contiguous), the kernel and the bias in the compute dtype."""
        return (x.to(self.dtype).contiguous(), self.kernel.to(self.dtype),
                self.bias.to(self.dtype))

    def forward(self, x, bn=None, train: bool = False, u=None,
                keep: float = 1.0):
        """The conv; given bn (a ConvBlock's), the fused layer conv -> BN ->
        LeakyReLU(0.01) (-> dropout from u), so that a forward hook sees
        the layer's output under this module's name."""
        if bn is None:
            return conv3x3(*self.operands(x))
        return bn_act.conv_bn_act(*self.operands(x), bn, train, u, keep)


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
    """(N,1,...,1,C) bool keep mask, P(keep) = 1 - rate (the rank's rows
    of the global batch's draw)."""
    shape = ((parallel.global_batch(x.shape[0]),) + (1,) * (x.ndim - 2)
             + (x.shape[-1],))
    u = torch.rand(shape, generator=generator, device=x.device)
    return parallel.local_rows(u) < (1.0 - rate)


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

    def forward(self, x, train: bool, generator=None):
        u = None  # the dropout's uniform draw, after the first layer
        if self.dropout_p > 0 and train:
            shape = (parallel.global_batch(x.shape[0]), *x.shape[1:3],
                     self.bn1.scale.shape[0])
            u = parallel.local_rows(torch.rand(
                shape, generator=generator, device=x.device))
        x = self.conv1(x, self.bn1, train, u, 1.0 - self.dropout_p)
        return self.conv2(x, self.bn2, train)


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


def feature_noise_draw(x, generator=None, uniform_range: float = 0.3):
    """U(-r, r) noise of shape x.shape[1:] in f32 (one draw for the
    batch)."""
    u = torch.rand(x.shape[1:], generator=generator, device=x.device)
    return u * (2 * uniform_range) - uniform_range


def feature_noise(x, noise):
    """x * noise + x in x's dtype, the noise (x.shape[1:]) shared across
    the batch (unet.py:816-821)."""
    return x * noise.to(x.dtype)[None] + x


def feature_dropout(x, cut):
    """Zero the positions whose channel mean reaches cut * (the sample's
    largest channel mean); cut is one scalar in [0.7, 0.9) for the batch
    (unet.py:824-830). The mean reduces in f32 and rounds to x's dtype."""
    attention = x.float().mean(-1, keepdim=True).to(x.dtype)
    max_val = attention.flatten(1).amax(1)
    thresh = max_val.float() * cut
    mask = (attention.float() < thresh[:, None, None, None]).to(x.dtype)
    return x * mask


class DecoderDS(nn.Module):
    """Decoder with a 3x3 head at every scale (DecoderDS / DecoderURDS:
    the perturbations, if any, are the caller's)."""

    def __init__(self, features: Sequence[int], num_classes: int, dtype,
                 generator=None):
        super().__init__()
        f = features
        self.ups = nn.ModuleList(
            UpBlock(f[i + 1], f[i], f[i], dtype, generator)
            for i in (3, 2, 1, 0)
        )
        self.heads = nn.ModuleList(
            Conv3x3(f[i], num_classes, dtype, generator) for i in (3, 2, 1, 0)
        )

    def forward(self, feats, train: bool, perturb=(None, None, None)):
        """(dp0, dp1, dp2, dp3); perturb[i] (or None) maps the decoder
        feature before the head at scale 1/2^(3-i)."""
        x = feats[-1]
        outs = []
        for i, (up, skip, head) in enumerate(zip(self.ups, feats[-2::-1],
                                                 self.heads)):
            x = up(x, skip, train)
            if i < 3:
                z = x if perturb[i] is None else perturb[i](x)
                outs.append(upsample_nearest(head(z), 2 ** (3 - i)).float())
            else:
                outs.append(head(x).float())
        return tuple(outs[::-1])


class UNetDS(nn.Module):
    flax_decoder = "DecoderDS_0"  # its decoder's flax scope (utils.params)

    def __init__(self, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        self.encoder = Encoder(in_ch, features, dropout, dtype, generator)
        self.decoder = DecoderDS(features, num_classes, dtype, generator)

    def forward(self, x, train: bool = False, rngs=None):
        feats = self.encoder(x, train, _gen(rngs, "dropout"))
        return self.decoder(feats, train)


class UNetURDS(UNetDS):
    """UNet_DS with URDS's train-mode perturbations before the coarse
    heads, drawn from rngs["feature_perturb"] in the JAX package's key
    order (k3, k2, k1): the channel-dropout mask, the feature-dropout cut,
    the feature noise."""

    flax_decoder = "DecoderURDS_0"

    def forward(self, x, train: bool = False, rngs=None, draws=None):
        """draws: optional {"channel_mask" (N,1,1,C) bool, "cut" (), "noise"
        (H/2, W/2, C)} in place of the draws."""
        feats = self.encoder(x, train, _gen(rngs, "dropout"))
        if not train:
            return self.decoder(feats, train)
        draws = dict(draws or {})
        gen = _gen(rngs, "feature_perturb")

        def dropout(z):
            if "channel_mask" not in draws:
                draws["channel_mask"] = channel_dropout_mask(z, gen)
            return channel_dropout(z, draws["channel_mask"])

        def cut(z):
            if "cut" not in draws:
                draws["cut"] = 0.7 + 0.2 * torch.rand(
                    (), generator=gen, device=z.device)
            return feature_dropout(z, draws["cut"])

        def noise(z):
            if "noise" not in draws:
                draws["noise"] = feature_noise_draw(z, gen)
            return feature_noise(z, draws["noise"])

        return self.decoder(feats, train, (dropout, cut, noise))


class UNetCCT3H(nn.Module):
    """Three decoders: the main one, aux_decoder1 on channel-dropped
    encoder features and aux_decoder2 on feature-noised ones (train mode;
    eval feeds all three the features as they are)."""

    def __init__(self, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT,
                 dtype=torch.bfloat16, in_ch: int = 1, generator=None):
        super().__init__()
        self.encoder = Encoder(in_ch, features, dropout, dtype, generator)
        self.main_decoder = Decoder(features, num_classes, dtype, generator)
        self.aux_decoder1 = Decoder(features, num_classes, dtype, generator)
        self.aux_decoder2 = Decoder(features, num_classes, dtype, generator)

    def forward(self, x, train: bool = False, rngs=None, channel_masks=None,
                noises=None):
        """channel_masks / noises: optional per-feature keep masks (N,1,1,C)
        and noise tensors (H,W,C) in place of the draws (masks first, then
        noises, from rngs["feature_perturb"])."""
        feats = self.encoder(x, train, _gen(rngs, "dropout"))
        main = self.main_decoder(feats, train)
        feats1 = feats2 = feats
        if train:
            gen = _gen(rngs, "feature_perturb")
            if channel_masks is None:
                channel_masks = [channel_dropout_mask(f, gen) for f in feats]
            if noises is None:
                noises = [feature_noise_draw(f, gen) for f in feats]
            feats1 = [channel_dropout(f, m)
                      for f, m in zip(feats, channel_masks)]
            feats2 = [feature_noise(f, n) for f, n in zip(feats, noises)]
        return (main, self.aux_decoder1(feats1, train),
                self.aux_decoder2(feats2, train))
