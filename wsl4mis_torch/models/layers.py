"""flax-style layers shared by the port's models (ScribbleVC, PNet2D,
EfficientNet-UNet, the 3D nets, the legacy GAN), channels-last.

* ``Conv``: flax ``nn.Conv`` over (N, *spatial, C): kernel (*k, C/groups,
  O) f32 in flax's layout, optional bias, "SAME" / "VALID" / integer
  padding, stride, dilation and groups, compute in ``dtype``. "SAME" pads
  as XLA does: the low side takes the smaller half, so a stride-2 window
  on an even size pads asymmetrically (``same_pads``). A 1x1 conv without
  groups is a matmul over the channels.
* ``ConvTranspose``: flax ``nn.ConvTranspose`` ("SAME", no kernel flip:
  ``lax.conv_transpose`` with ``transpose_kernel=False``).
* ``BatchNorm``: flax ``nn.BatchNorm(dtype=float32)``: statistics in f32
  (one-pass variance), output in f32; the caller casts, after its
  activation where the JAX module does so.
* ``GroupNorm``: flax ``nn.GroupNorm(dtype=float32)`` (eps 1e-6, one-pass
  variance, per-channel scale and bias), output in f32.
* ``instance_norm``, ``interp_axis`` (1D linear interpolation, weights in
  the input's dtype), ``upsample_nearest`` (integer factor, source index
  i // f), ``drop_path`` (stochastic depth), ``Dropout`` (element or
  channel dropout draws in forward order, or given masks).

Kernel initializers (``INITS``) draw as the JAX package's modules do:
"kaiming_fan_out" (ScribbleVC), "lecun" (flax's default, truncated
normal), "kaiming" (fan-in normal, the 3D nets), "torch" (U(+-1/sqrt(fan
in)) for kernel and bias, torch's Conv2d default), "normal" (N(0, 0.02),
the legacy GAN). Biases are zero except under "torch".
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from .norm import FusedBatchNorm

_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _kaiming_fan_out(t, fan_in, fan_out, gen):
    return t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)


def _kaiming(t, fan_in, fan_out, gen):
    return t.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)


def _lecun(t, fan_in, fan_out, gen):
    std = math.sqrt(1.0 / fan_in) / _TRUNC
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=gen)


def _torch_uniform(t, fan_in, fan_out, gen):
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=gen)


def _normal(t, fan_in, fan_out, gen):
    return t.normal_(0.0, 0.02, generator=gen)


INITS = {"kaiming_fan_out": _kaiming_fan_out, "kaiming": _kaiming,
         "lecun": _lecun, "torch": _torch_uniform, "normal": _normal}


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of flax / XLA "SAME" for a window of (dilated)
    size k at stride s: the low side gets the smaller half."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _to_channels_first(x):
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


def _to_channels_last(y):
    return y.permute(0, *range(2, y.ndim), 1)


class Conv(nn.Module):
    """flax nn.Conv over channels-last input; see the module docstring."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(3, 3), stride=1,
                 bias: bool = False, padding="SAME", dtype=torch.bfloat16,
                 generator=None, *, dilation: int = 1, groups: int = 1,
                 init: str = "kaiming_fan_out"):
        super().__init__()
        kernel = tuple(kernel)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.dtype = dtype
        rf = math.prod(kernel)
        shape = (*kernel, in_ch // groups, out_ch)
        self.kernel = nn.Parameter(INITS[init](
            torch.empty(shape), in_ch // groups * rf, out_ch * rf, generator))
        self.bias = None
        if bias:
            b = torch.zeros(out_ch)
            if init == "torch":
                _torch_uniform(b, in_ch // groups * rf, 0, generator)
            self.bias = nn.Parameter(b)

    def _pads(self, spatial, kernel):
        d, s = self.dilation, self.stride
        if self.padding == "SAME":
            return [same_pads(n, (k - 1) * d + 1, s)
                    for n, k in zip(spatial, kernel)]
        p = 0 if self.padding == "VALID" else int(self.padding)
        return [(p, p)] * len(kernel)

    def forward(self, x):
        x = x.to(self.dtype)
        k = self.kernel.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        kernel = k.shape[:-2]
        s = self.stride
        pads = self._pads(x.shape[1:-1], kernel)
        if (all(kk == 1 for kk in kernel) and self.groups == 1
                and not any(lo or hi for lo, hi in pads)):
            if s > 1:
                x = x[(slice(None),) + (slice(None, None, s),) * len(kernel)]
            return F.linear(x, k.reshape(k.shape[-2:]).t(), b)
        pad = [lo for lo, _ in pads]
        if any(lo != hi for lo, hi in pads):
            flat = [p for lo, hi in reversed(pads) for p in (lo, hi)]
            x = F.pad(x, [0, 0] + flat)
            pad = 0
        w = k.permute(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
        y = _CONV[len(kernel)](_to_channels_first(x), w, b, stride=s,
                               padding=pad, dilation=self.dilation,
                               groups=self.groups)
        return _to_channels_last(y)


def conv_transpose_pads(k: int, s: int) -> tuple[int, int]:
    """lax.conv_transpose's "SAME" padding of the stride-dilated input."""
    pad_len = k + s - 2
    lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    return lo, pad_len - lo


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose(padding="SAME") over channels-last input:
    the input dilated by the stride, padded (conv_transpose_pads) and
    correlated with the kernel (*k, C, O) as it is, not flipped."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(2, 2), stride=2,
                 bias: bool = True, dtype=torch.bfloat16, generator=None, *,
                 init: str = "lecun"):
        super().__init__()
        kernel = tuple(kernel)
        self.stride = stride
        self.dtype = dtype
        rf = math.prod(kernel)
        self.kernel = nn.Parameter(INITS[init](
            torch.empty((*kernel, in_ch, out_ch)), in_ch * rf, out_ch * rf,
            generator))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        k = self.kernel.to(self.dtype)
        nd = k.ndim - 2
        s = self.stride
        # torch's transposed conv correlates the dilated input, padded by
        # k - 1 a side, with the flipped kernel: flip it back, then crop
        # to lax's padding
        w = k.flip(tuple(range(nd))).permute(nd, nd + 1, *range(nd))
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = _CONV_T[nd](_to_channels_first(x.to(self.dtype)), w, b, stride=s)
        index = [slice(None), slice(None)]
        for kk in k.shape[:nd]:
            lo, hi = conv_transpose_pads(kk, s)
            index.append(slice(kk - 1 - lo, y.shape[len(index)] - (kk - 1 - hi)))
        return _to_channels_last(y[tuple(index)])


class BatchNorm(FusedBatchNorm):
    """flax nn.BatchNorm(dtype=float32): statistics of x in f32 (one-pass
    variance, as flax's), output (x - mean) * scale / sqrt(var + eps) +
    bias in f32; the caller casts."""

    def forward(self, x, train: bool):
        xf = x.float()
        moments = None
        if train:
            dims = tuple(range(x.ndim - 1))
            moments = (xf.sum(dims), (xf * xf).sum(dims))
        mean, var = self.statistics(xf.numel() // xf.shape[-1], train,
                                    moments)
        return (xf - mean) * (self.scale * torch.rsqrt(var + self.epsilon)) \
            + self.bias


class GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups, dtype=float32) over channels-last x:
    per sample and group of channels, the mean and one-pass variance
    (E[x^2] - E[x]^2, floored at 0) of x in f32 over the spatial dims and
    the group's channels; output (x - mean) * (rsqrt(var + eps) * scale)
    + bias in f32, as flax orders it; the caller casts."""

    def __init__(self, features: int, num_groups: int = 32,
                 epsilon: float = 1e-6):
        super().__init__()
        if features % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{features} channels")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        g = xf.reshape(*x.shape[:-1], self.num_groups, -1)
        dims = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
        mean = g.mean(dims, keepdim=True)
        var = ((g * g).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
        size = x.shape[-1] // self.num_groups
        mean = mean.flatten(-2).repeat_interleave(size, -1)
        var = var.flatten(-2).repeat_interleave(size, -1)
        return (xf - mean) * (torch.rsqrt(var + self.epsilon)
                              * self.scale) + self.bias


def instance_norm(x, eps: float = 1e-5):
    """torch InstanceNorm (affine=False) over the spatial dims of a
    channels-last x: f32 statistics (biased variance), x's dtype out."""
    dims = tuple(range(1, x.ndim - 1))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class _LinearInterp(torch.autograd.Function):
    """x[lo] * (1 - w) + x[hi] * w along `axis`. The backward is a product
    with the (out, in) interpolation matrix, two nonzeros a row, and not
    index_select's index_add, whose atomics sum in no fixed order on the
    card: the gradient is a function of its inputs."""

    @staticmethod
    def forward(ctx, x, axis, lo, hi, w):
        ctx.save_for_backward(lo, hi, w)
        ctx.axis, ctx.shape = axis, x.shape
        shape = [1] * x.ndim
        shape[axis] = w.shape[0]
        wv = w.view(shape)
        return (x.index_select(axis, lo) * (1 - wv)
                + x.index_select(axis, hi) * wv)

    @staticmethod
    def backward(ctx, g):
        lo, hi, w = ctx.saved_tensors
        axis, shape = ctx.axis, ctx.shape
        cols = torch.arange(shape[axis], device=g.device)
        m = ((1 - w)[:, None] * (cols == lo[:, None])
             + w[:, None] * (cols == hi[:, None]))  # (out, in)
        pre = math.prod(shape[:axis])
        gx = torch.matmul(m.t(), g.reshape(pre, w.shape[0], -1))
        return gx.reshape(shape), None, None, None, None


def interp_axis(x, axis: int, out_size: int, align_corners: bool):
    """1D linear interpolation along one axis, the weights in x's dtype
    (the port's copy of ``wsl4mis_tpu/models/nets3d._interp_axis``), with
    a deterministic backward (``_LinearInterp``)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if align_corners and out_size > 1:
        src = pos * ((in_size - 1) / (out_size - 1))
    else:
        src = (pos + 0.5) * (in_size / out_size) - 0.5
    src = src.clamp(0, in_size - 1)
    lo = src.floor()
    w = (src - lo).to(x.dtype)
    lo = lo.long()
    hi = (lo + 1).clamp(max=in_size - 1)
    return _LinearInterp.apply(x, axis % x.ndim, lo, hi, w)


def upsample_nearest(z, factor: int):
    """NHWC nearest upsampling by an integer factor (source index i // f,
    as ``jax.image.resize``'s)."""
    if factor == 1:
        return z
    return z.repeat_interleave(factor, 1).repeat_interleave(factor, 2)


class Dropout:
    """Dropout draws in forward order: each call takes the next of the
    given keep masks, else draws one from the generator (element-wise, or
    one per sample and channel: shape (N, 1, ..., 1, C); the rank's rows of
    the global batch's draw); kept values are scaled by 1 / (1 - rate)."""

    def __init__(self, generator=None, masks=None):
        self.generator = generator
        self.masks = None if masks is None else iter(masks)

    def __call__(self, x, rate: float, channel: bool = False):
        if self.masks is not None:
            keep = next(self.masks)
        else:
            rows = parallel.global_batch(x.shape[0])
            shape = ((rows,) + (1,) * (x.ndim - 2) + (x.shape[-1],)
                     if channel else (rows, *x.shape[1:]))
            keep = parallel.local_rows(torch.rand(
                shape, generator=self.generator,
                device=x.device)) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device)
                           ).to(x.dtype)


def drop_path_keep(rows: int, ndim: int, rate: float, generator, device):
    """drop_path's draw for a (rows, ...) input of `ndim` dims: (rows, 1,
    ..., 1) bool, of the global batch, cut to the rank's rows."""
    shape = (parallel.global_batch(rows),) + (1,) * (ndim - 1)
    return parallel.local_rows(torch.rand(
        shape, generator=generator, device=device)) < 1.0 - rate


def drop_path(x, rate: float, generator=None, keep=None):
    """Stochastic depth: each sample's residual branch kept with
    probability 1 - rate (and scaled by 1 / (1 - rate)) or zeroed. `keep`
    (B, 1, ..., 1) bool replaces the draw from `generator`
    (drop_path_keep)."""
    if rate == 0.0:
        return x
    if keep is None:
        keep = drop_path_keep(x.shape[0], x.ndim, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device)
                       ).to(x.dtype)
