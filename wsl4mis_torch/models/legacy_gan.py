"""Legacy GAN building blocks (port of ``wsl4mis_tpu/models/legacy_gan.py``,
the reference's networks_other.py), NHWC, f32 by default:

* ``select_initializer``: the init schemes normal / xavier / kaiming /
  orthogonal, as functions that fill a flax-layout kernel;
* ``get_schedule``: the 'lambda' and 'step' learning-rate policies as
  plain functions of the step;
* ``gan_loss``: MSE against 1 / 0 (lsgan) or BCE with logits;
* ``ResnetGenerator`` (c7s1-64, two stride-2 downs, residual blocks, two
  ups, c7s1-out + tanh), ``UnetGenerator`` (recursive skip-connected
  encoder / decoder) and ``NLayerDiscriminator`` (PatchGAN), with
  affine-free instance norm, "SAME" padding as XLA's (``layers.Conv``),
  transposed convs as flax's (``layers.ConvTranspose``) and N(0, 0.02)
  kernels, zero biases.

Each model holds its submodules in lists named after flax's module kinds
in flax's call order (``utils.params.zoo_key`` maps a flax tree onto it).
ResnetGenerator's dropout masks come from rngs["dropout"], or are given
as ``drop_masks``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.params import zoo_key
from .layers import Conv, ConvTranspose, Dropout, instance_norm
from .unet import _gen


def select_initializer(init_type: str = "normal"):
    """networks_other.init_weights' schemes: a function (kernel, generator
    =None) that fills a (*k, in, out) kernel in place and returns it."""
    def fans(t):
        rf = math.prod(t.shape[:-2])
        return t.shape[-2] * rf, t.shape[-1] * rf

    def normal(t, generator=None):
        return t.normal_(0.0, 0.02, generator=generator)

    def xavier(t, generator=None):
        fan_in, fan_out = fans(t)
        return t.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                         generator=generator)

    def kaiming(t, generator=None):
        return t.normal_(0.0, math.sqrt(2.0 / fans(t)[0]),
                         generator=generator)

    def orthogonal(t, generator=None):
        with torch.no_grad():
            m = torch.empty(math.prod(t.shape[:-1]), t.shape[-1])
            nn.init.orthogonal_(m, 1.0, generator=generator)
            return t.copy_(m.view(t.shape))

    schemes = {"normal": normal, "xavier": xavier, "kaiming": kaiming,
               "orthogonal": orthogonal}
    try:
        return schemes[init_type]
    except KeyError:
        raise ValueError(f"unknown init method {init_type!r}") from None


def get_schedule(policy: str, base_lr: float, *, niter: int = 100,
                 niter_decay: int = 100, lr_decay_iters: int = 50):
    """networks_other.get_scheduler's policies as functions of the step:
    'lambda' holds base_lr for `niter` steps, then decays linearly to 0
    over `niter_decay`; 'step' multiplies by 0.1 every lr_decay_iters."""
    if policy == "lambda":
        def sched(count):
            frac = min(max((count - niter + 1) / float(niter_decay + 1),
                           0.0), 1.0)
            return base_lr * (1.0 - frac)

        return sched
    if policy == "step":
        return lambda count: base_lr * 0.1 ** (count // lr_decay_iters)
    raise ValueError(f"unknown lr policy {policy!r}")


def gan_loss(logits, target_is_real: bool, use_lsgan: bool = True):
    """GANLoss: MSE against 1 / 0 (lsgan) or BCE with logits, the mean."""
    target = torch.full_like(logits, 1.0 if target_is_real else 0.0)
    if use_lsgan:
        return ((logits - target) ** 2).mean()
    return F.binary_cross_entropy_with_logits(logits, target)


def _conv(c, o, kernel=3, stride=1, dtype=torch.float32, generator=None):
    return Conv(c, o, (kernel, kernel), stride, bias=True, dtype=dtype,
                generator=generator, init="normal")


def _conv_t(c, o, kernel, dtype=torch.float32, generator=None):
    return ConvTranspose(c, o, (kernel, kernel), 2, dtype=dtype,
                         generator=generator, init="normal")


class ResnetBlock(nn.Module):
    def __init__(self, features, dtype=torch.float32, generator=None):
        super().__init__()
        self.conv = nn.ModuleList(_conv(features, features, 3, 1, dtype,
                                        generator) for _ in range(2))

    def forward(self, x, train: bool, drop=None):
        h = F.relu(instance_norm(self.conv[0](x)))
        if train:
            h = drop(h, 0.5)
        return x + instance_norm(self.conv[1](h))


class ResnetGenerator(nn.Module):
    flax_key = staticmethod(zoo_key)

    def __init__(self, out_channels: int = 1, ngf: int = 64,
                 n_blocks: int = 9, dtype=torch.float32, in_ch: int = 1,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv = nn.ModuleList([
            _conv(in_ch, ngf, 7, 1, **kw), _conv(ngf, 2 * ngf, 3, 2, **kw),
            _conv(2 * ngf, 4 * ngf, 3, 2, **kw),
            _conv(ngf, out_channels, 7, 1, **kw)])
        self.resnet_block = nn.ModuleList(
            ResnetBlock(4 * ngf, dtype, generator) for _ in range(n_blocks))
        self.conv_transpose = nn.ModuleList([
            _conv_t(4 * ngf, 2 * ngf, 3, **kw), _conv_t(2 * ngf, ngf, 3, **kw)])

    def forward(self, x, train: bool = False, rngs=None, drop_masks=None):
        """drop_masks: optional element keep masks, one a residual block,
        in place of the draws from rngs["dropout"]."""
        drop = Dropout(_gen(rngs, "dropout"), drop_masks)
        h = x
        for conv in self.conv[:3]:
            h = F.relu(instance_norm(conv(h)))
        for block in self.resnet_block:
            h = block(h, train, drop)
        for up in self.conv_transpose:
            h = F.relu(instance_norm(up(h)))
        return torch.tanh(self.conv[3](h))


class _UnetLevel(nn.Module):
    """Down (LeakyReLU 0.2, 4x4 stride-2 conv, IN), the inner levels, up
    (ReLU, 4x4 stride-2 transposed conv, IN), concat with the input."""

    def __init__(self, in_ch, outer, inner, depth, innermost=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv = nn.ModuleList([_conv(in_ch, inner, 4, 2, **kw)])
        leaf = innermost or depth <= 1
        self.unet_level = nn.ModuleList(
            [] if leaf else
            [_UnetLevel(inner, inner, min(inner * 2, 512), depth - 1,
                        depth - 1 <= 1, **kw)])
        self.conv_transpose = nn.ModuleList(
            [_conv_t(inner if leaf else 2 * inner, outer, 4, **kw)])

    def forward(self, x):
        mid = instance_norm(self.conv[0](F.leaky_relu(x, 0.2)))
        for level in self.unet_level:
            mid = level(mid)
        up = instance_norm(self.conv_transpose[0](F.relu(mid)))
        return torch.cat([x, up], dim=-1)


class UnetGenerator(nn.Module):
    flax_key = staticmethod(zoo_key)

    def __init__(self, out_channels: int = 1, num_downs: int = 7,
                 ngf: int = 64, dtype=torch.float32, in_ch: int = 1,
                 generator=None):
        super().__init__()
        self.unet_level = nn.ModuleList([_UnetLevel(
            in_ch, ngf, ngf * 2, num_downs - 1, dtype=dtype,
            generator=generator)])
        self.conv = nn.ModuleList([_conv(in_ch + ngf, out_channels, 3, 1,
                                         dtype, generator)])

    def forward(self, x, train: bool = False):
        return torch.tanh(self.conv[0](self.unet_level[0](x)))


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (networks_other.py:481-529)."""

    flax_key = staticmethod(zoo_key)

    def __init__(self, ndf: int = 64, n_layers: int = 3,
                 dtype=torch.float32, in_ch: int = 1, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        convs = [_conv(in_ch, ndf, 4, 2, **kw)]
        mult = 1
        for _ in range(1, n_layers):
            prev, mult = mult, min(mult * 2, 8)
            convs.append(_conv(ndf * prev, ndf * mult, 4, 2, **kw))
        prev, mult = mult, min(mult * 2, 8)
        convs += [_conv(ndf * prev, ndf * mult, 4, 1, **kw),
                  _conv(ndf * mult, 1, 4, 1, **kw)]
        self.conv = nn.ModuleList(convs)

    def forward(self, x):
        h = F.leaky_relu(self.conv[0](x), 0.2)
        for conv in self.conv[1:-1]:
            h = F.leaky_relu(instance_norm(conv(h)), 0.2)
        return self.conv[-1](h)
