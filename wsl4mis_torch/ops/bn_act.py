"""The U-Net ConvBlock's conv -> BatchNorm -> LeakyReLU(0.01) (-> dropout),
fused: one forward kernel after the conv, two backward kernels before the
conv's own.

No Pallas kernel is ported here: the JAX package leaves BN, the activation
and the dropout to XLA's fusion. Kernels live in ``csrc/bn_act.cu`` (its
note says what bounds them and how the passes are cut):

* ``bn_act_fwd``: the activation from the conv output y and the per-channel
  moments (train mode; the running statistics folded in unless frozen) or
  the running statistics (eval mode), the dropout applied from its uniform
  draw u, with the keep mask saved; bit-equal to the eager chain
  (``models.norm.FusedBatchNorm`` then ``F.leaky_relu`` then the dropout).
* ``bn_act_sums``: backward pass 1, the per-channel sums of g' and g' y (g'
  the cotangent at the BN output) in f32, and from them the BN scale's and
  shift's gradients and the moments' cotangents gs1, gs2.
* ``bn_act_bwd``: backward pass 2, the conv-output cotangent
  ``round(f32(round(g' mul)) + gs1 + 2 f32(y) gs2)`` (the fold
  ``conv3x3._Conv3x3Stats.backward`` makes) and its sum, the conv's bias
  gradient.

``conv_bn_act`` runs every ConvBlock layer: the ``torch.autograd.Function``
over the conv kernels and these, whose backward hands ``conv3x3._conv_bwd``
the cotangent and the bias gradient, in train mode and in eval mode (the
running statistics are constants there: gs1 = gs2 = 0); the forward alone
in eval mode without autograd. Under a process group the moments and gs1,
gs2 are summed over the ranks between the passes (``parallel.global_sums``),
as the eager chain's autograd summed them. A CUDA tensor goes to the kernels
(or the wrapper raises); a CPU tensor goes to the plain PyTorch versions
beside them, the same arithmetic: the forward the eager chain's op for op,
the backward's per-channel sums in f32, where the eager chain's autograd
rounded them to bf16 (so the two backwards agree to rounding, not to the
bit). ``launches`` counts kernel launches by name.
"""

from __future__ import annotations

import functools
import struct

import torch
import torch.nn.functional as F

from .. import parallel
from . import _build, conv3x3

launches = {"bn_act_fwd": 0, "bn_act_sums": 0, "bn_act_bwd": 0}

SLOPE = 0.01  # LeakyReLU's negative slope
MAX_C = 512  # channels a kernel launch takes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _f32(v: float) -> float:
    """v rounded to float32 (a host scalar as a CUDA kernel of PyTorch's
    takes it)."""
    return struct.unpack("f", struct.pack("f", v))[0]


@functools.lru_cache(maxsize=None)
def _dropout_scale(keep: float, dtype) -> float:
    """1/keep as ``mask.to(dtype) * (1.0 / keep)`` makes it: rounded to
    dtype."""
    return torch.tensor(1.0 / keep).to(dtype).item()


def _inv(n: int) -> float:
    """float32(1 / n): PyTorch's CUDA ``t / n`` multiplies by it."""
    return _f32(1.0 / _f32(n))


# ---- plain PyTorch versions ------------------------------------------------


def bn_act_fwd_plain(y, moments, scale, shift, mean, var, u=None, *, n=None,
                     keep=1.0, update=False, momentum=0.9, eps=1e-5,
                     factors=True):
    """(out, mask, fac): the eager chain op for op. moments (s1, s2) in
    train mode (None: eval, the running statistics mean and var), over n
    values a channel; update folds the batch into mean and var in place. u:
    the dropout's uniform draw (y's shape, f32) or None; mask the bool keep
    mask. fac (5, C) f32, for a backward (None unless factors): the mean,
    the unclamped variance, rsqrt(var + eps), mul and add."""
    if moments is not None:
        s1, s2 = moments
        bm, bm2 = s1 / n, s2 / n
        vun = bm2 - bm * bm
        bv = torch.clamp(vun, min=0.0)
        if update:
            mean.copy_(momentum * mean + (1 - momentum) * bm)
            var.copy_(momentum * var + (1 - momentum) * bv)
    else:
        bm, bv = mean, var
        vun = bv
    r = torch.rsqrt(bv + eps)
    mul = scale * r
    add = shift - bm * mul
    out = F.leaky_relu(y * mul.to(y.dtype) + add.to(y.dtype), SLOPE)
    mask = None
    if u is not None:
        mask = u < keep
        out = out * (mask.to(y.dtype) * (1.0 / keep))
    fac = torch.stack([bm, vun, r, mul, add]) if factors else None
    return out, mask, fac


def act_grad_plain(g, y, mask, fac, keep):
    """g' (the cotangent at the BN output), y's dtype: the dropout's and the
    LeakyReLU's backward on z = y * mul + add recomputed."""
    dt = y.dtype
    z = y * fac[3].to(dt) + fac[4].to(dt)
    if mask is not None:
        g = g * (mask.to(dt) * (1.0 / keep))
    return torch.ops.aten.leaky_relu_backward(g, z, SLOPE, False)


def bn_act_sums_plain(g, y, mask, fac, scale, *, n, keep=1.0):
    """(4, C) f32: the scale's and the shift's gradients and the cotangents
    of the moments s1, s2, from the f32 sums of g' and g' y."""
    gp = act_grad_plain(g, y, mask, fac, keep).float()
    dims = tuple(range(y.ndim - 1))
    g1 = gp.sum(dims)
    g2 = (gp * y.float()).sum(dims)
    bm, vun, r, mul = fac[0], fac[1], fac[2], fac[3]
    gmul = g2 - g1 * bm
    gvar = -0.5 * (gmul * scale) * (r * r * r)
    gvar = torch.where(vun >= 0, gvar, torch.zeros_like(gvar))
    gmean = -(g1 * mul) - 2.0 * gvar * bm
    inv_n = _inv(n)
    return torch.stack([gmul * r, g1, gmean * inv_n, gvar * inv_n])


def bn_act_bwd_plain(g, y, mask, fac, gs1, gs2, *, keep=1.0):
    """(the conv-output cotangent, its sum: the conv's bias gradient), both
    in y's dtype; gs1, gs2 the moments' cotangents (summed over the ranks)."""
    dt = y.dtype
    gy = act_grad_plain(g, y, mask, fac, keep) * fac[3].to(dt)
    gout = (gy.float() + gs1 + 2.0 * y.float() * gs2).to(dt)
    return gout, gout.float().sum(tuple(range(y.ndim - 1))).to(dt)


# ---- kernel wrappers -------------------------------------------------------


def _check_fac(what, fac, c):
    """fac: bn_act_fwd's on the card, whose storage holds the backward's
    two tickets after the (5, C) values."""
    if (tuple(fac.shape) != (5, c) or fac.dtype != torch.float32
            or fac.storage_offset() != 0 or not fac.is_contiguous()
            or fac.untyped_storage().nbytes() < 4 * (5 * c + 2)):
        raise ValueError(f"{what}: fac must be bn_act_fwd's (its storage "
                         "holds the backward's tickets)")


def _check(what, x, *vectors, full=()):
    """x (..., C) in f32 or bf16; vectors (C,) f32; full: tensors of x's
    shape (any dtype), 16-byte aligned as x; all on x's device and
    contiguous."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    c = x.shape[-1]
    if not 1 <= c <= MAX_C:
        raise ValueError(f"{what}: {c} channels (the kernels take 1 to "
                         f"{MAX_C})")
    if x.numel() // c >= 2 ** 31:
        raise ValueError(f"{what}: {x.numel() // c} pixels exceed int32")
    for t in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{what}: per-channel operands must be ({c},) "
                             "float32")
    for t in full:
        if t.shape != x.shape:
            raise ValueError(f"{what}: {tuple(t.shape)} is not x's "
                             f"{tuple(x.shape)}")
    for t in (x, *vectors, *full):
        if t.device != x.device:
            raise TypeError(f"{what}: all operands must be on x's device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, *full)):
        raise ValueError(f"{what}: x-shaped operands must be 16-byte "
                         "aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_kernel(y, moments, scale, shift, mean, var, u, n, keep, update,
                momentum, eps, factors):
    train = moments is not None
    vectors = (scale, shift, mean, var) + (tuple(moments) if train else ())
    _check("bn_act_fwd", y, *vectors, full=() if u is None else (u,))
    if u is not None and (u.dtype != torch.float32 or not train):
        raise ValueError("bn_act_fwd: the dropout's draw must be float32, "
                         "in train mode")
    c = y.shape[-1]
    out = torch.empty_like(y)
    mask = (None if u is None else
            torch.empty(y.shape, dtype=torch.bool, device=y.device))
    fac = None
    if factors or train:  # the values, then the backward's two tickets
        fac = torch.empty(5 * c + 2, dtype=torch.float32,
                          device=y.device)[:5 * c].view(5, c)
    s1, s2 = moments if train else (None, None)
    lib = _build.lib("bn_act")
    with _build.on_device(y):
        err = lib.bn_act_fwd(
            y.data_ptr(), _ptr(s1), _ptr(s2), scale.data_ptr(),
            shift.data_ptr(), mean.data_ptr(), var.data_ptr(), _ptr(u),
            out.data_ptr(), _ptr(mask), _ptr(fac), y.numel() // c, c,
            _inv(n) if train else 0.0, _f32(eps), _f32(momentum),
            _f32(1 - momentum), _f32(keep), _dropout_scale(keep, y.dtype),
            int(train), int(update), _DTYPE_CODE[y.dtype], _build.stream(y))
    _build.check("bn_act", "bn_act_fwd", err)
    launches["bn_act_fwd"] += 1
    return out, mask, fac


def _partials(lib, y, rows_of):
    c = y.shape[-1]
    rows = lib.bn_act_blocks(y.numel() // c, c, _DTYPE_CODE[y.dtype])
    return torch.empty((rows, rows_of, c), dtype=torch.float32,
                       device=y.device)


def _sums_kernel(g, y, mask, fac, scale, n, keep):
    _check("bn_act_sums", y, scale,
           full=(g,) if mask is None else (g, mask))
    if g.dtype != y.dtype:
        raise TypeError("bn_act_sums: g must share y's dtype")
    c = y.shape[-1]
    _check_fac("bn_act_sums", fac, c)
    lib = _build.lib("bn_act")
    out = torch.empty((4, c), dtype=torch.float32, device=y.device)
    with _build.on_device(y):
        part = _partials(lib, y, 2)
        err = lib.bn_act_sums(
            g.data_ptr(), y.data_ptr(), _ptr(mask), fac.data_ptr(),
            scale.data_ptr(), part.data_ptr(), out.data_ptr(),
            y.numel() // c, c, _inv(n), _dropout_scale(keep, y.dtype),
            _DTYPE_CODE[y.dtype], _build.stream(y))
    _build.check("bn_act", "bn_act_sums", err)
    launches["bn_act_sums"] += 1
    return out


def _bwd_kernel(g, y, mask, fac, gs1, gs2, keep):
    _check("bn_act_bwd", y, gs1, gs2,
           full=(g,) if mask is None else (g, mask))
    if g.dtype != y.dtype:
        raise TypeError("bn_act_bwd: g must share y's dtype")
    c = y.shape[-1]
    _check_fac("bn_act_bwd", fac, c)
    lib = _build.lib("bn_act")
    gout = torch.empty_like(y)
    db = torch.empty((c,), dtype=y.dtype, device=y.device)
    with _build.on_device(y):
        part = _partials(lib, y, 1)
        err = lib.bn_act_bwd(
            g.data_ptr(), y.data_ptr(), _ptr(mask), fac.data_ptr(),
            gs1.data_ptr(), gs2.data_ptr(), gout.data_ptr(), part.data_ptr(),
            db.data_ptr(), y.numel() // c, c,
            _dropout_scale(keep, y.dtype), _DTYPE_CODE[y.dtype],
            _build.stream(y))
    _build.check("bn_act", "bn_act_bwd", err)
    launches["bn_act_bwd"] += 1
    return gout, db


def _route(t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no bn_act implementation for device {t.device}")


def bn_act_fwd(y, moments, scale, shift, mean, var, u=None, *, n=None,
               keep=1.0, update=False, momentum=0.9, eps=1e-5, factors=True):
    """(out, mask, fac) as ``bn_act_fwd_plain``: the kernel for CUDA, plain
    on CPU. fac is made in train mode whatever factors says."""
    if _route(y):
        return _fwd_kernel(y, moments, scale, shift, mean, var, u, n, keep,
                           update, momentum, eps, factors)
    return bn_act_fwd_plain(y, moments, scale, shift, mean, var, u, n=n,
                            keep=keep, update=update, momentum=momentum,
                            eps=eps, factors=factors or moments is not None)


def bn_act_sums(g, y, mask, fac, scale, *, n, keep=1.0):
    if _route(y):
        return _sums_kernel(g, y, mask, fac, scale, n, keep)
    return bn_act_sums_plain(g, y, mask, fac, scale, n=n, keep=keep)


def bn_act_bwd(g, y, mask, fac, gs1, gs2, *, keep=1.0):
    if _route(y):
        return _bwd_kernel(g, y, mask, fac, gs1, gs2, keep)
    return bn_act_bwd_plain(g, y, mask, fac, gs1, gs2, keep=keep)


# ---- autograd --------------------------------------------------------------


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _ConvBnAct(torch.autograd.Function):
    """conv3x3 (+ b) -> BN -> LeakyReLU (-> dropout). bn: the layer's
    ``FusedBatchNorm`` (its buffers updated in place in train mode)."""

    @staticmethod
    def forward(ctx, x, w, b, scale, shift, u, bn, keep, train):
        if train:
            y, s1, s2 = conv3x3.conv3x3_fwd_stats(x, w, b)
            n = parallel.global_batch(y.numel() // y.shape[-1])
            moments = parallel.global_sums(s1, s2)
        else:
            y, n, moments = conv3x3.conv3x3_fwd(x, w, b), 1, None
        out, mask, fac = bn_act_fwd(
            y, moments, scale, shift, bn.mean, bn.var, u, n=n, keep=keep,
            update=train and bn.updating(), momentum=bn.momentum,
            eps=bn.epsilon)
        ctx.save_for_backward(x, w, y, mask, fac, scale)
        ctx.n, ctx.keep, ctx.train, ctx.bias_dtype = n, keep, train, b.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, y, mask, fac, scale = ctx.saved_tensors
        g = _aligned(g)
        sums = bn_act_sums(g, y, mask, fac, scale, n=ctx.n, keep=ctx.keep)
        if ctx.train:
            gs1, gs2 = parallel.global_sums(sums[2], sums[3])
        else:  # the running statistics are constants
            gs1 = gs2 = torch.zeros_like(sums[2])
        gy, db = bn_act_bwd(g, y, mask, fac, gs1, gs2, keep=ctx.keep)
        dx, dw, db = conv3x3._conv_bwd(ctx, x, w, gy, db)
        return dx, dw, db, sums[0], sums[1], None, None, None, None


def conv_bn_act(x, w, b, bn, train: bool, u=None, keep: float = 1.0):
    """LeakyReLU(BN(conv3x3(x, w) + b), 0.01), then the dropout where u (the
    uniform draw, f32 of the output's shape) is given: kept where
    u < keep, scaled by 1/keep. x (N,H,W,C), w (3,3,C,O), b (O,) in the
    compute dtype; bn a ``FusedBatchNorm`` of O channels. Differentiable in
    x, w, b and the BN scale and bias. Train mode: the batch's statistics,
    folded into the running ones unless ``bn.updating()`` is False. Eval
    mode: the running statistics; without autograd the forward kernel
    alone."""
    if train or torch.is_grad_enabled():
        u = None if u is None else _aligned(u)
        return _ConvBnAct.apply(x, w, b, bn.scale, bn.bias, u, bn, keep,
                                train)
    y = conv3x3.conv3x3_fwd(x, w, b)
    return bn_act_fwd(y, None, bn.scale, bn.bias, bn.mean, bn.var,
                      eps=bn.epsilon, factors=False)[0]
