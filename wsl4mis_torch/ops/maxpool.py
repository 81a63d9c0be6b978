"""2x2 stride-2 max pool on NHWC with a first-max backward (kernel + plain).

Port of the function of ``wsl4mis_tpu/ops/pallas/maxpool_pallas.py``
(``max_pool_2x2_pallas``: ``_fwd_kernel``, ``_bwd_kernel``) and of
``wsl4mis_tpu/ops/maxpool.py`` (its plain formulation). Kernels live in
``csrc/maxpool.cu``:

* ``maxpool_fwd``: y[n,i,j,c] = max over the window's four taps.
* ``maxpool_bwd``: dx takes g at each window's first maximum in the
  row-major tap order (0,0), (0,1), (1,0), (1,1), and 0 at the other
  three taps. Activation maps tie often (exact zeros, bf16 rounding), so
  the tie rule decides where gradients go.

A NaN tap makes the window's y NaN (``torch.maximum`` and the kernel's
comparison both propagate it). In the backward no tap of such a window
equals its max, so g falls through to tap (1,1); the kernel and the plain
version agree on that, and nothing else is promised there.

``max_pool_2x2`` is the ``torch.autograd.Function`` over them. A CUDA
tensor goes to the kernels (or the wrapper raises); a CPU tensor goes to
the plain PyTorch versions beside them, which are four strided taps and
comparisons and lean on no library pooling call. ``launches`` counts
kernel launches by name.
"""

from __future__ import annotations

import torch

from . import _build

launches = {"maxpool_fwd": 0, "maxpool_bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---- plain PyTorch versions ------------------------------------------------


def _taps(x):
    """The four window taps, each (N, H/2, W/2, C), in row-major order."""
    return (x[:, 0::2, 0::2], x[:, 0::2, 1::2],
            x[:, 1::2, 0::2], x[:, 1::2, 1::2])


def _check_even(x, what):
    if x.ndim != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{what}: x {tuple(x.shape)} is not (N, H, W, C) "
                         "with even H and W")


def max_pool_2x2_fwd_plain(x):
    _check_even(x, "maxpool_fwd")
    t00, t01, t10, t11 = _taps(x)
    return torch.maximum(torch.maximum(t00, t01),
                         torch.maximum(t10, t11)).contiguous()


def max_pool_2x2_bwd_plain(x, g):
    """dx (N,H,W,C) in g's dtype: g at each window's first max, else 0."""
    _check_even(x, "maxpool_bwd")
    t00, t01, t10, t11 = _taps(x)
    y = torch.maximum(torch.maximum(t00, t01), torch.maximum(t10, t11))
    m00 = t00 == y
    m01 = (t01 == y) & ~m00
    m10 = (t10 == y) & ~(m00 | m01)
    m11 = ~(m00 | m01 | m10)
    dx = torch.empty(x.shape, dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for tap, mask in zip(_taps(dx), (m00, m01, m10, m11)):
        tap.copy_(torch.where(mask, g, zero))
    return dx


# ---- kernel wrappers -------------------------------------------------------


def _check(x, g, what):
    _check_even(x, what)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    tensors = (x,) if g is None else (x, g)
    if g is not None:
        n, h, w, c = x.shape
        if tuple(g.shape) != (n, h // 2, w // 2, c):
            raise ValueError(f"{what}: g {tuple(g.shape)} is not the pooled "
                             f"shape of x {tuple(x.shape)}")
        if g.dtype != x.dtype or g.device != x.device:
            raise TypeError(f"{what}: g must share x's dtype and device")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             "16-byte aligned")


def _fwd_kernel(x):
    _check(x, None, "maxpool_fwd")
    n, h, w, c = x.shape
    y = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    lib = _build.lib("maxpool")
    with _build.on_device(x):
        err = lib.maxpool_fwd(x.data_ptr(), y.data_ptr(), n, h, w, c,
                              _DTYPE_CODE[x.dtype], _build.stream(x))
    _build.check("maxpool", "maxpool_fwd", err)
    launches["maxpool_fwd"] += 1
    return y


def _bwd_kernel(x, g):
    _check(x, g, "maxpool_bwd")
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    lib = _build.lib("maxpool")
    with _build.on_device(x):
        err = lib.maxpool_bwd(x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, h,
                              w, c, _DTYPE_CODE[x.dtype], _build.stream(x))
    _build.check("maxpool", "maxpool_bwd", err)
    launches["maxpool_bwd"] += 1
    return dx


def _route(t):
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no max_pool_2x2 implementation for device {t.device}")


def max_pool_2x2_fwd(x):
    """Forward only (no autograd): the kernel for CUDA, plain on CPU."""
    return _fwd_kernel(x) if _route(x) else max_pool_2x2_fwd_plain(x)


def max_pool_2x2_bwd(x, g):
    return _bwd_kernel(x, g) if _route(x) else max_pool_2x2_bwd_plain(x, g)


# ---- autograd --------------------------------------------------------------


class _MaxPool2x2(torch.autograd.Function):
    """plain=True takes the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, plain):
        ctx.save_for_backward(x)
        ctx.plain = plain
        return (max_pool_2x2_fwd_plain if plain else max_pool_2x2_fwd)(x)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        bwd = max_pool_2x2_bwd_plain if ctx.plain else max_pool_2x2_bwd
        return bwd(x, gy.to(x.dtype).contiguous()), None


def max_pool_2x2(x):
    """(N, H, W, C) -> (N, H/2, W/2, C); H and W must be even."""
    return _MaxPool2x2.apply(x, False)


def max_pool_2x2_plain(x):
    """The plain version of ``max_pool_2x2`` on any device, differentiable
    with the same first-max backward."""
    return _MaxPool2x2.apply(x, True)
