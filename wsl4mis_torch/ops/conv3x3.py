"""3x3 SAME stride-1 convolution, NHWC x HWIO, with a BN-moment variant.

Port of the function of ``wsl4mis_tpu/ops/pallas/banded_conv_pallas.py``
(``banded_conv3x3_pallas`` and ``banded_conv3x3_pallas_stats`` with their
custom VJPs, :609-686), not of its TPU band layout. Kernels live in
``csrc/conv3x3.cu``: bf16 on the tensor cores (mma.sync implicit GEMMs),
f32 on the CUDA cores (SIMT FMA; see the source's note for why).

* ``conv3x3_fwd``: y = conv(x, w) + b, f32 accumulate, one rounding to
  the input dtype. It is also the input gradient: dx = conv(g, rot(w))
  with ``rot(w) = w.flip(0, 1).transpose(2, 3)`` and no bias.
* ``conv3x3_fwd_stats``: the same y plus per-channel f32 sums of y and
  y*y over the rounded stored values (the moments FusedBatchNorm takes).
* ``conv3x3_wgrad``: dK[dy,dx,c,o] = sum_{n,h,w} x_pad[n,h+dy,w+dx,c] *
  g[n,h,w,o] in f32.

``conv3x3`` and ``conv3x3_stats`` are ``torch.autograd.Function``s over
them. The bias gradient is a torch reduction of g in f32, as the JAX
package leaves it to XLA. A CUDA tensor goes to the kernels (or the
wrapper raises); a CPU tensor goes to the plain PyTorch versions beside
them. ``launches`` counts kernel launches by name.

C interface (``_build.LIBRARIES["conv3x3"]``): the kernels write
per-block f32 partials that the wrapper folds with a torch sum, sized by
``conv3x3_stats_rows(N, H, W, O, dtype)`` (moments: (rows, 2, O)) and
``conv3x3_wgrad_splits(N, H, W, C, O, dtype)`` (dK: (splits, 3, 3, C, O));
both depend on the dtype, since the bf16 and f32 kernels tile differently.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

launches = {"conv3x3_fwd": 0, "conv3x3_fwd_stats": 0, "conv3x3_wgrad": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---- plain PyTorch versions ------------------------------------------------


def conv3x3_plain(x, w, b=None):
    """conv(x, w) + b in f32 on an NCHW view, rounded once to x.dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1)
    if b is not None:
        y = y + b.float()[:, None, None]
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_stats_plain(x, w, b=None):
    """(y, sum y, sum y*y): moments in f32 over the rounded y."""
    y = conv3x3_plain(x, w, b)
    yf = y.float()
    return y, yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))


def conv3x3_wgrad_plain(x, g):
    """dK (3, 3, C, O) f32 of conv(x, K) for output cotangent g."""
    h, w = g.shape[1], g.shape[2]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float()
    return torch.stack([
        torch.stack([
            torch.einsum("nhwc,nhwo->co", xp[:, dy:dy + h, dx:dx + w], gf)
            for dx in range(3)
        ])
        for dy in range(3)
    ])


# ---- kernel wrappers -------------------------------------------------------


def _check(x, w, b, what):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{what}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "are not NHWC x (3, 3, C, O)")
    for t in (x, w) + ((b,) if b is not None else ()):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{what}: all operands must share x's dtype "
                            "and device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if b is not None and tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"{what}: bias {tuple(b.shape)} != ({w.shape[3]},)")


def _fwd_kernel(x, w, b, stats):
    what = "conv3x3_fwd_stats" if stats else "conv3x3_fwd"
    _check(x, w, b, what)
    n, h, wd, c = x.shape
    o = w.shape[3]
    y = torch.empty((n, h, wd, o), dtype=x.dtype, device=x.device)
    lib = _build.lib("conv3x3")
    bp = b.data_ptr() if b is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if stats:
            part = torch.empty((lib.conv3x3_stats_rows(
                n, h, wd, o, _DTYPE_CODE[x.dtype]), 2, o),
                               dtype=torch.float32, device=x.device)
            err = lib.conv3x3_fwd_stats(
                x.data_ptr(), w.data_ptr(), bp, y.data_ptr(), part.data_ptr(),
                n, h, wd, c, o, _DTYPE_CODE[x.dtype], stream)
        else:
            err = lib.conv3x3_fwd(
                x.data_ptr(), w.data_ptr(), bp, y.data_ptr(),
                n, h, wd, c, o, _DTYPE_CODE[x.dtype], stream)
    _build.check("conv3x3", what, err)
    launches[what] += 1
    if stats:
        s = part.sum(0)  # fold the per-block partials (deterministic)
        return y, s[0], s[1]
    return y


def _wgrad_kernel(x, g):
    if x.dtype not in _DTYPE_CODE or g.dtype != x.dtype:
        raise TypeError("conv3x3_wgrad: x and g must both be float32 or "
                        "bfloat16")
    if x.ndim != 4 or g.ndim != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} disagree")
    if g.device != x.device or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("conv3x3_wgrad: x and g must be contiguous and on "
                         "one device")
    n, h, wd, c = x.shape
    o = g.shape[3]
    lib = _build.lib("conv3x3")
    code = _DTYPE_CODE[x.dtype]
    part = torch.empty((lib.conv3x3_wgrad_splits(n, h, wd, c, o, code), 3,
                        3, c, o), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_wgrad(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), n, h, wd, c, o,
            code, torch.cuda.current_stream().cuda_stream)
    _build.check("conv3x3", "conv3x3_wgrad", err)
    launches["conv3x3_wgrad"] += 1
    return part.sum(0)  # fold the pixel-range splits (deterministic)


def _route(t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no conv3x3 implementation for device {t.device}")


def conv3x3_fwd(x, w, b=None):
    """Forward only (no autograd): the kernel for CUDA, plain on CPU."""
    return _fwd_kernel(x, w, b, False) if _route(x) else conv3x3_plain(x, w, b)


def conv3x3_fwd_stats(x, w, b=None):
    if _route(x):
        return _fwd_kernel(x, w, b, True)
    return conv3x3_stats_plain(x, w, b)


def conv3x3_wgrad(x, g):
    return _wgrad_kernel(x, g) if _route(x) else conv3x3_wgrad_plain(x, g)


# ---- autograd --------------------------------------------------------------


def _conv_bwd(ctx, x, w, g):
    """(dx, dw, db) for y = conv(x, w) + b; mirrors _conv_bwd_core
    (banded_conv_pallas.py:629-643). dx is skipped where x needs none
    (the stem)."""
    g = g.contiguous()
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
        w_rot = w.flip(0, 1).transpose(2, 3).to(g.dtype).contiguous()
        dx = conv3x3_fwd(g, w_rot).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = conv3x3_wgrad(x, g.to(x.dtype)).to(w.dtype)
    if ctx.needs_input_grad[2]:
        db = g.float().sum((0, 1, 2)).to(ctx.bias_dtype)
    return dx, dw, db


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = b.dtype
        return conv3x3_fwd(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        return _conv_bwd(ctx, x, w, gy)


class _Conv3x3Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y, s1, s2 = conv3x3_fwd_stats(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.bias_dtype = b.dtype
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w, y = ctx.saved_tensors
        # d s1/dy = 1, d s2/dy = 2y per channel, folded into the output
        # cotangent (banded_conv_pallas.py:675-683)
        g32 = gy.float() + gs1 + 2.0 * y.float() * gs2
        return _conv_bwd(ctx, x, w, g32.to(gy.dtype))


def conv3x3(x, w, b):
    """y = conv(x, w) + b. x (N,H,W,C), w (3,3,C,O), b (O,), one dtype."""
    return _Conv3x3.apply(x, w, b)


def conv3x3_stats(x, w, b):
    """(y, s1, s2) with s1[o] = sum y[..., o], s2[o] = sum y[..., o]^2 in
    f32 over the rounded y; differentiable in all three outputs."""
    return _Conv3x3Stats.apply(x, w, b)
