"""Plain layers of the U-Net family, channels-last (N, H, W, C), and the
precision the reference computes in.

Conventions (the port's parameter layout, which the benchmark's weights
follow): a 3x3 kernel is (3, 3, C, O), a 2x2 transposed-conv kernel (2,
2, C, O) with output sub-pixel (a, b) taking tap K[1-a, 1-b] (lax's
conv_transpose); BatchNorm keeps f32 running statistics with momentum 0.9
(new = 0.9 old + 0.1 batch) and the biased batch variance, eps 1e-5.
Departures from the WSL4MIS PyTorch code (torch.nn.BatchNorm2d keeps the
unbiased running variance): the stored variance is the biased one, as
the port's (and its JAX package's) flax BatchNorm keeps it; the batch's
normalisation is the same.

Precision: ``Precision("float32")`` runs every conv and matmul in f32 with
TF32 off. The controls are the reference a step lower: "tf32" (TF32 on
for convs and matmuls) below float32, and "fp8" below bfloat16: every
conv's and transposed conv's inputs, weights and output, and the
gradient flowing back through each, rounded to float8 e4m3 with a
per-tensor scale (amax to 448), accumulation in f32: the bf16 program's
arithmetic (bf16 operands and stored conv outputs, f32 accumulation) a
step down.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _round_fp8(t):
    scale = FP8_MAX / t.detach().abs().amax().float().clamp(min=1e-30)
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale
            ).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


class Precision:
    """The arithmetic of the reference's convs and matmuls; use as a
    context, which sets the TF32 switches and puts them back."""

    NAMES = ("float32", "tf32", "fp8")

    def __init__(self, name: str = "float32"):
        if name not in self.NAMES:
            raise ValueError(f"precision {name!r} not in {self.NAMES}")
        self.name = name
        self._saved = None

    def operand(self, t):
        return _Fp8.apply(t) if self.name == "fp8" else t

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False


def conv3x3(x, kernel, bias, prec: Precision):
    """SAME 3x3 conv: x (N,H,W,C), kernel (3,3,C,O), bias (O,)."""
    y = F.conv2d(prec.operand(x).permute(0, 3, 1, 2),
                 prec.operand(kernel).permute(3, 2, 0, 1), bias, padding=1)
    return prec.operand(y.permute(0, 2, 3, 1))


def conv_transpose2x2(x, kernel, bias, prec: Precision):
    """Stride-2 2x2 transposed conv: out[n, 2i+a, 2j+b, o] = bias[o] +
    sum_c x[n,i,j,c] K[1-a, 1-b, c, o]."""
    n, h, w, _ = x.shape
    o = kernel.shape[3]
    taps = prec.operand(kernel).flip(0, 1)  # taps[a, b] = K[1-a, 1-b]
    y = torch.einsum("nhwc,abco->nhawbo", prec.operand(x), taps)
    return prec.operand(y.reshape(n, 2 * h, 2 * w, o) + bias)


def batch_norm(y, scale, bias, mean, var, train: bool, momentum=0.9,
               eps=1e-5, update: bool = True):
    """Normalise by the batch's statistics (train; the running ones folded
    in place unless `update` is False) or by the running ones."""
    if train:
        m = y.mean((0, 1, 2))
        v = y.var((0, 1, 2), unbiased=False)
        if update:
            with torch.no_grad():
                mean.mul_(momentum).add_((1 - momentum) * m)
                var.mul_(momentum).add_((1 - momentum) * v)
    else:
        m, v = mean, var
    return (y - m) * torch.rsqrt(v + eps) * scale + bias


def leaky_relu(x):
    return F.leaky_relu(x, 0.01)


def max_pool2x2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def cross_entropy(logits, labels, ignore_index=None):
    """Mean negative log-likelihood over the pixels not ignored (0 where
    all are)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    keep = (labels != ignore_index) if ignore_index is not None \
        else torch.ones_like(labels, dtype=torch.bool)
    safe = torch.where(keep, labels, 0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * keep).sum() / keep.sum().clamp(min=1)
