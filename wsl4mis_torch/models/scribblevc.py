"""ScribbleVC: a CNN + Transformer (Conformer) hybrid with a class-
representation memory (port of ``wsl4mis_tpu/models/scribblevc.py``), NHWC.

* A 12-stage Conformer trunk: a bottleneck CNN stream and a ViT token
  stream coupled every stage by FCUDown / FCUUp bridges; stages 5 and 9
  halve the grid and double the channels (256 -> 512 -> 1024 at the
  published widths: base 64, channel_ratio 4, embed 384, 6 heads, patch
  16, so 257 tokens at 256x256).
* Encoder taps after the stem blocks and stages 4 / 8 / 12 feed a U-Net
  decoder with bilinear (align_corners) x2 upsampling; the final token
  grid feeds a skip-free upsampling decoder.
* Two multi-label classification heads: a 3x3 conv + mean over the grid on
  the CNN stream, LayerNorm + dense on the cls token.
* The class-representation memory (``class_memory_update``): EMA class
  prototypes of the deepest CNN and token features, kept only where the
  head classifies a prototype as its own class, injected into the features
  in train mode (a full batch, ``use_class_rep``) and in eval mode.

Numerics follow the JAX package: every BatchNorm computes its statistics
and its output in f32 (eps 1e-6 in the Conformer, 1e-5 in the decoder;
flax momentum 0.9, biased running variance) and the output is cast to the
compute dtype only after the ReLU / LeakyReLU; LayerNorm (eps 1e-6) runs
in f32 and then casts; the attention logits are f32 from compute-dtype q, k,
the softmax is f32 cast to the compute dtype, attn * v runs in the compute
dtype; GELU is the tanh approximation (flax's default); SAME padding at
stride 2 pads (0, 1), for the stride-2 3x3 convs and the stem's 3x3
max pools (padded with -inf); the bilinear weights are formed in the
input's dtype.

The convolutions, dense layers and attention products are ``F.conv2d`` /
``F.linear`` / ``torch.matmul`` (the JAX package runs them as XLA ops, in
no TPU kernel); a 1x1 conv is a matmul over the channels. Parameters are
f32 in the flax layout (conv kernels HWIO, dense kernels (in, out)) and
names, so ``utils.params`` maps a flax tree onto them by renaming; the init
draws as flax's does (kaiming fan-out normal for convs, truncated normal
0.02 for dense kernels and the cls token, zero biases).

``remat=True`` checkpoints each Conformer stage 2-12 (flax's ``nn.remat``
of the JAX model): a train-mode forward under autograd keeps only the
stages' inputs and recomputes each stage's activations in the backward
(``torch.utils.checkpoint``, non-reentrant). The recompute leaves the BN
running statistics alone (``norm.statistics_frozen``), and the stage's
drop-path masks are drawn before it and passed in, in the order the plain
forward draws them, so the results are bit-equal to ``remat=False``.

The memory is not module state: ``forward`` takes it as a dict of f32
tensors ``{"hist_conv" (ncls, H', W', C), "hist_tran" (ncls, T, E),
"initialized" ()}`` (``init_memory``) and, in train mode, updates those
tensors in place (detached) after using them; the caller keeps the dict
(a method keeps it in ``state.extra["class_memory"]``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import parallel
from ..utils.params import scribblevc_key
from .norm import statistics_frozen
from .layers import (
    BatchNorm,
    Conv,
    drop_path,
    drop_path_keep,
    interp_axis,
    same_pads,
    upsample_nearest,
)

_TRUNC_STD = 0.02 / 0.87962566103423978  # flax truncated_normal(0.02)


def _trunc_normal(shape, generator):
    return nn.Parameter(nn.init.trunc_normal_(
        torch.empty(shape), std=_TRUNC_STD, a=-2 * _TRUNC_STD,
        b=2 * _TRUNC_STD, generator=generator))


def upsample2d(x, factor: int, method: str = "bilinear_ac"):
    """NHWC x factor upsampling: "bilinear_ac" (align_corners) or
    "nearest" (each pixel repeated factor x factor times)."""
    if method == "nearest":
        return upsample_nearest(x, factor)
    for axis in (1, 2):
        x = interp_axis(x, axis, x.shape[axis] * factor, True)
    return x


def _max_pool_same(x):
    """NHWC 3x3 stride-2 max pool, SAME padding with -inf."""
    (ht, hb), (wl, wr) = (same_pads(n, 3, 2) for n in x.shape[1:3])
    x = F.pad(x, (0, 0, wl, wr, ht, hb), value=-math.inf)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """flax nn.Dense: kernel (in, out) f32, truncated-normal 0.02 init."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _trunc_normal((in_features, out_features), generator)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(), b)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(epsilon=1e-6, dtype=float32): f32 out."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, self.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, dtype, generator):
        super().__init__()
        self.dense0 = Dense(dim, hidden, dtype=dtype, generator=generator)
        self.dense1 = Dense(hidden, out, dtype=dtype, generator=generator)

    def forward(self, x):
        return self.dense1(_gelu(self.dense0(x)))


class TokenAttention(nn.Module):
    """Multi-head self-attention: qkv dense (with bias), f32 logits of the
    compute-dtype q, k, f32 softmax cast to the compute dtype, attn * v in
    the compute dtype, output dense."""

    def __init__(self, dim: int, num_heads: int, dtype, generator):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.dense0 = Dense(dim, 3 * dim, dtype=dtype, generator=generator)
        self.dense1 = Dense(dim, dim, dtype=dtype, generator=generator)

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.dense0(x).view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * d ** -0.5
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.dense1(out)


class TransBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, drop_path_rate: float,
                 dtype, generator, mlp_ratio: float = 4.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.dtype = dtype
        self.norm0 = LayerNorm(dim)
        self.attn = TokenAttention(dim, num_heads, dtype, generator)
        self.norm1 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype, generator)

    def draw_keep(self, rows: int, generator, device):
        """The (attention, MLP) drop-path masks of a train-mode forward of
        `rows` samples, drawn in the forward's order; None at rate 0."""
        if self.drop_path_rate == 0.0:
            return None
        return tuple(drop_path_keep(rows, 3, self.drop_path_rate, generator,
                                    device) for _ in range(2))

    def forward(self, x, train: bool, generator=None, keep=None):
        """`keep`: draw_keep's masks in place of the draws."""
        rate = self.drop_path_rate if train else 0.0
        keep_attn, keep_mlp = (None, None) if keep is None else keep
        y = self.attn(self.norm0(x).to(self.dtype))
        x = x + drop_path(y, rate, generator, keep_attn)
        y = self.mlp(self.norm1(x).to(self.dtype))
        return x + drop_path(y, rate, generator, keep_mlp)


class BottleneckConvBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck, the med = outplanes / 4
    features optionally fused with a token map after the first 1x1, and a
    1x1 (stride) projection of the residual when res_conv."""

    def __init__(self, in_ch: int, outplanes: int, stride: int = 1,
                 res_conv: bool = False, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        med = outplanes // 4
        self.dtype = dtype
        self.res_conv = res_conv
        self.conv0 = Conv(in_ch, med, (1, 1), dtype=dtype, generator=generator)
        self.bn0 = BatchNorm(med, epsilon=1e-6)
        self.conv1 = Conv(med, med, (3, 3), stride, dtype=dtype,
                          generator=generator)
        self.bn1 = BatchNorm(med, epsilon=1e-6)
        self.conv2 = Conv(med, outplanes, (1, 1), dtype=dtype,
                          generator=generator)
        self.bn2 = BatchNorm(outplanes, epsilon=1e-6)
        if res_conv:
            self.conv3 = Conv(in_ch, outplanes, (1, 1), stride, dtype=dtype,
                              generator=generator)
            self.bn3 = BatchNorm(outplanes, epsilon=1e-6)

    def forward(self, x, x_t=None, *, train: bool, return_x2: bool = True):
        dt = self.dtype
        h = F.relu(self.bn0(self.conv0(x), train)).to(dt)
        if x_t is not None:
            h = h + x_t
        x2 = F.relu(self.bn1(self.conv1(h), train)).to(dt)
        h = self.bn2(self.conv2(x2), train).to(dt)
        residual = x
        if self.res_conv:
            residual = self.bn3(self.conv3(x), train).to(dt)
        out = F.relu(h + residual).to(dt)
        return (out, x2) if return_x2 else out


class FCUDown(nn.Module):
    """CNN map -> tokens: 1x1 projection, dw_stride average pool, LN, GELU,
    the cls token prepended."""

    def __init__(self, in_ch: int, embed_dim: int, dw_stride: int, dtype,
                 generator):
        super().__init__()
        self.dw_stride = dw_stride
        self.dtype = dtype
        self.conv0 = Conv(in_ch, embed_dim, (1, 1), dtype=dtype,
                          generator=generator)
        self.norm0 = LayerNorm(embed_dim)

    def forward(self, x, x_t):
        s = self.dw_stride
        h = self.conv0(x)
        b, hh, ww, c = h.shape
        if s > 1:
            h = h.view(b, hh // s, s, ww // s, s, c).mean((2, 4))
        h = _gelu(self.norm0(h.reshape(b, -1, c)).to(self.dtype))
        return torch.cat([x_t[:, :1], h], dim=1)


class FCUUp(nn.Module):
    """Tokens -> CNN map: 1x1 projection, BN, ReLU, nearest x up_stride."""

    def __init__(self, embed_dim: int, outplanes: int, up_stride: int, dtype,
                 generator):
        super().__init__()
        self.up_stride = up_stride
        self.dtype = dtype
        self.conv0 = Conv(embed_dim, outplanes, (1, 1), dtype=dtype,
                          generator=generator)
        self.bn0 = BatchNorm(outplanes, epsilon=1e-6)

    def forward(self, x_t, hw, train: bool):
        b, _, c = x_t.shape
        grid = x_t[:, 1:].reshape(b, *hw, c)
        grid = F.relu(self.bn0(self.conv0(grid), train)).to(self.dtype)
        return upsample2d(grid, self.up_stride, "nearest")


class ConvTransBlock(nn.Module):
    """One Conformer stage: CNN block, FCUDown, transformer block, FCUUp,
    fusion block."""

    def __init__(self, in_ch: int, outplanes: int, res_conv: bool,
                 stride: int, dw_stride: int, embed_dim: int, num_heads: int,
                 drop_path_rate: float, last_fusion: bool, dtype, generator):
        super().__init__()
        self.dw_stride = dw_stride
        med = outplanes // 4
        self.cnn_block = BottleneckConvBlock(in_ch, outplanes, stride,
                                             res_conv, dtype, generator)
        self.fcu_down = FCUDown(med, embed_dim, dw_stride, dtype, generator)
        self.trans_block = TransBlock(embed_dim, num_heads, drop_path_rate,
                                      dtype, generator)
        self.fcu_up = FCUUp(embed_dim, med, dw_stride, dtype, generator)
        self.fusion_block = BottleneckConvBlock(outplanes, outplanes, 1,
                                                last_fusion, dtype, generator)

    def forward(self, x, x_t, train: bool, generator=None, keep=None):
        x, x2 = self.cnn_block(x, train=train)
        hw = (x2.shape[1] // self.dw_stride, x2.shape[2] // self.dw_stride)
        x_st = self.fcu_down(x2, x_t)
        x_t = self.trans_block(x_st + x_t, train, generator, keep)
        x_t_r = self.fcu_up(x_t, hw, train)
        x = self.fusion_block(x, x_t_r, train=train, return_x2=False)
        return x, x_t


class UNetUpBilinear(nn.Module):
    """1x1 conv of the deep map, bilinear (align_corners) x2, concat the
    skip first, then twice 3x3 conv -> BN (eps 1e-5) -> LeakyReLU(0.01)."""

    def __init__(self, deep_ch: int, skip_ch: int, skip_features: int,
                 out_features: int, dtype, generator):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv(deep_ch, skip_features, (1, 1), bias=True,
                          dtype=dtype, generator=generator)
        self.conv1 = Conv(skip_ch + skip_features, out_features, bias=True,
                          dtype=dtype, generator=generator)
        self.bn0 = BatchNorm(out_features)
        self.conv2 = Conv(out_features, out_features, bias=True, dtype=dtype,
                          generator=generator)
        self.bn1 = BatchNorm(out_features)

    def forward(self, deep, skip, train: bool):
        h = upsample2d(self.conv0(deep), 2, "bilinear_ac")
        h = torch.cat([skip, h], dim=-1)
        h = F.leaky_relu(self.bn0(self.conv1(h), train), 0.01).to(self.dtype)
        return F.leaky_relu(self.bn1(self.conv2(h), train), 0.01).to(
            self.dtype)


def class_memory_update(hf, tf, conv_cls, tran_cls, hist_conv, hist_tran,
                        initialized, hist_weight, conv_head_fn,
                        trans_head_fn):
    """The train-mode memory step (the port of the JAX function of the same
    name; the reference's scribbleVC_ACDC.py:670-739).

    hf (B, H, W, C) trunk features and tf (B, T, E) normed tokens, f32;
    conv_cls / tran_cls (B, ncls) logits; hist_conv (ncls, H, W, C) and
    hist_tran (ncls, T, E) the stored prototypes; initialized a () tensor
    (0 before the first update); conv_head_fn / trans_head_fn apply the
    classification heads to (ncls, H, W, C) maps / (ncls, E) cls tokens.

    Returns (dh, t_rep, new_hist_conv, new_hist_tran): the feature and
    token injections and the new prototypes (detached). In the gradient,
    only the old history term is detached: the fresh (1 - w) * rep_masked
    term reaches dh and t_rep, so the injections backpropagate into this
    step's features and logits. The heads' outputs on the prototypes feed
    argmax tests only and run without a gradient. Under a process group the
    batch means are the global batch's (``parallel.global_sum``), so every
    rank takes the same gate decisions and keeps the same prototypes.
    """
    b = hf.shape[0]
    ncls = conv_cls.shape[1]
    hw0 = hist_weight
    init = initialized > 0
    classes = torch.arange(ncls, device=hf.device)

    def is_class_max(logits):
        return (logits.argmax(1) == classes).float()

    rep = parallel.global_sum(torch.einsum("bi,bhwc->ihwc", conv_cls, hf)) \
        / parallel.global_batch(b)
    with torch.no_grad():
        ema = torch.where(init, hw0 * hist_conv + (1 - hw0) * rep, rep)
        is_max = is_class_max(conv_head_fn(ema))
    rep_masked = is_max[:, None, None, None] * rep
    w_vec = torch.where(is_max == 0, 1.0, hw0)[:, None, None, None]
    new_hist = torch.where(init, w_vec * hist_conv.detach()
                           + (1 - w_vec) * rep_masked, rep_masked)
    conv_prob = torch.sigmoid(conv_cls)
    ok = ((conv_prob < 0.5) | (is_max > 0)).all(1, keepdim=True).float()
    weight = torch.where(conv_prob < 0.5, 0.0, conv_prob) * ok
    dh = torch.einsum("ab,bhwc->ahwc", weight, new_hist)

    trep = parallel.global_sum(torch.einsum("bi,bjk->ijk", tran_cls, tf)) \
        / parallel.global_batch(b)
    with torch.no_grad():
        tema = torch.where(init, hw0 * hist_tran + (1 - hw0) * trep, trep)
        t_is_max = is_class_max(trans_head_fn(tema[:, 0]))
    trep_masked = t_is_max[:, None, None] * trep
    t_w = torch.where(t_is_max == 0, 1.0, hw0)[:, None, None]
    new_t_hist = torch.where(init, t_w * hist_tran.detach()
                             + (1 - t_w) * trep_masked, trep_masked)
    # the token injection's all-classes check reads the *conv* head's
    # probabilities, as the reference does (scribbleVC_ACDC.py:736)
    t_ok = ((conv_prob < 0.5) | (t_is_max > 0)).all(1, keepdim=True).float()
    tran_prob = torch.sigmoid(tran_cls)
    t_weight = torch.where(tran_prob < 0.5, 0.0, tran_prob) * t_ok
    t_rep = torch.einsum("ab,bjk->ajk", t_weight, new_t_hist)
    return dh, t_rep, new_hist.detach(), new_t_hist.detach()


def _ceil_half(n: int) -> int:
    return -(-n // 2)


def _remat_contexts():
    """checkpoint's (forward, recompute) contexts: the recompute keeps no
    BN statistics."""
    return contextlib.nullcontext(), statistics_frozen()


class ScribbleVC(nn.Module):
    """The ACDC ScribbleVC net. ``patch_size`` is the transformer's patch
    (16: a 4x4 patch embedding on the stem's quarter-size map); the input is
    (B, H, W, 1). ``batch_size``: the train batch at which the memory is
    updated (None: never), the global batch under a process group.
    ``remat``: checkpoint stages 2-12 (the module docstring)."""

    flax_key = staticmethod(scribblevc_key)  # the flax tree's renaming

    def __init__(self, num_classes: int = 4, batch_size: int | None = None,
                 base_channel: int = 64, channel_ratio: int = 4,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 16, drop_path_rate: float = 0.1,
                 hist_weight: float = 0.5, dtype=torch.bfloat16,
                 in_ch: int = 1, generator=None, remat: bool = False):
        super().__init__()
        g = generator
        self.remat = remat
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.hist_weight = hist_weight
        self.dtype = dtype
        c1 = base_channel * channel_ratio
        c2, c3 = 2 * c1, 4 * c1
        dw = patch_size // 4
        self.dw = dw
        ncls = num_classes - 1
        dpr = [drop_path_rate * i / (depth - 1) for i in range(depth)]

        self.cls_token = _trunc_normal((1, 1, embed_dim), g)
        self.conv_1 = BottleneckConvBlock(in_ch, c1 // 4, 1, True, dtype, g)
        self.conv_2 = BottleneckConvBlock(c1 // 4, c1 // 2, 1, True, dtype, g)
        self.conv_3 = BottleneckConvBlock(c1 // 2, c1, 1, True, dtype, g)
        self.patch_embed = Conv(c1, embed_dim, (dw, dw), dw, bias=True,
                                padding="VALID", dtype=dtype, generator=g)
        self.trans_1 = TransBlock(embed_dim, num_heads, dpr[0], dtype, g)
        third = depth // 3
        planes_in = c1
        for i in range(2, depth + 1):
            if i <= third:
                planes, res_conv, stride, dws = c1, False, 1, dw
            elif i <= 2 * third:
                first = i == third + 1
                planes, res_conv, stride, dws = c2, first, 1 + first, dw // 2
            else:
                first = i == 2 * third + 1
                planes, res_conv, stride, dws = c3, first, 1 + first, dw // 4
            self.add_module(f"conv_trans_{i}", ConvTransBlock(
                planes_in, planes, res_conv, stride, dws, embed_dim,
                num_heads, dpr[i - 1], i == depth, dtype, g))
            planes_in = planes
        self.conv_cls_conv = Conv(planes_in, ncls, (3, 3), dtype=dtype,
                                  generator=g)
        self.trans_norm = LayerNorm(embed_dim)
        self.trans_cls_head = Dense(embed_dim, ncls, dtype=dtype, generator=g)
        self.ups = nn.ModuleList([
            UNetUpBilinear(c3, c2, c2, c2, dtype, g),
            UNetUpBilinear(c2, c1, c1, c1, dtype, g),
            UNetUpBilinear(c1, c1 // 2, c1 // 2, c1 // 2, dtype, g),
            UNetUpBilinear(c1 // 2, c1 // 4, c1 // 4, c1 // 4, dtype, g),
        ])
        self.seg_head = Conv(c1 // 4, num_classes, (3, 3), bias=True,
                             dtype=dtype, generator=g)
        tchans = (256, 128, 64, 32)
        self.trans_up = nn.ModuleList(
            Conv(cin, cout, (1, 1), bias=True, dtype=dtype, generator=g)
            for cin, cout in zip((embed_dim,) + tchans[:-1], tchans))
        self.trans_head = Conv(tchans[-1], num_classes, (3, 3), bias=True,
                               dtype=dtype, generator=g)

    def init_memory(self, image_size, device=None) -> dict:
        """A zero memory for (H, W) inputs: hist_conv (ncls, H', W', C) of
        the last stage's map, hist_tran (ncls, 1 + tokens, E), initialized
        0; f32 on `device`."""
        h, w = (_ceil_half(_ceil_half(n)) for n in image_size)  # stem pools
        tokens = 1 + (h // self.dw) * (w // self.dw)
        h, w = (_ceil_half(_ceil_half(n)) for n in (h, w))  # stages 5, 9
        ncls = self.num_classes - 1
        c = self.conv_cls_conv.kernel.shape[2]
        return {
            "hist_conv": torch.zeros((ncls, h, w, c), device=device),
            "hist_tran": torch.zeros((ncls, tokens, self.embed_dim),
                                     device=device),
            "initialized": torch.zeros((), device=device),
        }

    def _conv_head(self, z):
        return self.conv_cls_conv(z).float().mean((1, 2))

    def _trans_head(self, z):
        return self.trans_cls_head(z).float()

    def forward(self, x, train: bool = False, memory: dict | None = None,
                use_class_rep: bool = False, rngs=None):
        """x (B,H,W,1) -> (seg_conv, seg_trans, (conv_cls, tran_cls)):
        (B,H,W,C) f32 logits of both decoders and (B, C-1) f32 logits of
        both classification heads. With use_class_rep and a memory: in
        train mode at B == batch_size the memory step runs and its tensors
        are updated in place; in eval mode the stored memory is injected.
        Drop-path draws from rngs["dropout"]."""
        dt = self.dtype
        b = x.shape[0]
        gen = None if rngs is None else rngs.get("dropout")
        feats = []
        h = self.conv_1(x.to(dt), train=train, return_x2=False)
        feats.append(h)
        h = self.conv_2(_max_pool_same(h), train=train, return_x2=False)
        feats.append(h)
        h = self.conv_3(_max_pool_same(h), train=train, return_x2=False)

        t = self.patch_embed(h)
        _, gh, gw, e = t.shape
        t = torch.cat([self.cls_token.to(dt).expand(b, 1, e),
                       t.reshape(b, gh * gw, e)], dim=1)
        t = self.trans_1(t, train, gen)
        remat = self.remat and train and torch.is_grad_enabled()
        for i in range(2, self.depth + 1):
            stage = getattr(self, f"conv_trans_{i}")
            if remat:
                keep = stage.trans_block.draw_keep(b, gen, t.device)
                h, t = checkpoint(stage, h, t, train, None, keep,
                                  use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=_remat_contexts)
            else:
                h, t = stage(h, t, train, gen)
            if i % 4 == 0:
                feats.append(h)

        x_patch = t[:, 1:].reshape(b, gh, gw, e)
        conv_cls = self._conv_head(h)
        t_normed = self.trans_norm(t).to(dt)
        tran_cls = self._trans_head(t_normed[:, 0])

        if use_class_rep and memory is not None and (
                not train or parallel.global_batch(b) == self.batch_size):
            if train:
                dh, t_rep, new_hist, new_t_hist = class_memory_update(
                    h.float(), t_normed.float(), conv_cls, tran_cls,
                    memory["hist_conv"], memory["hist_tran"],
                    memory["initialized"], self.hist_weight,
                    self._conv_head, self._trans_head)
                with torch.no_grad():
                    memory["hist_conv"].copy_(new_hist)
                    memory["hist_tran"].copy_(new_t_hist)
                    memory["initialized"].fill_(1.0)
            else:
                weight = torch.sigmoid(conv_cls)
                weight = torch.where(weight < 0.5, 0.0, weight)
                dh = torch.einsum("ab,bhwc->ahwc", weight,
                                  memory["hist_conv"])
                t_weight = torch.sigmoid(tran_cls)
                t_weight = torch.where(t_weight < 0.5, 0.0, t_weight)
                t_rep = torch.einsum("ab,bjk->ajk", t_weight,
                                     memory["hist_tran"])
            h = h + dh.to(dt)
            feats[-1] = h
            x_patch = x_patch + t_rep[:, 1:].reshape(b, gh, gw, e).to(dt)

        d = feats[4]
        for up, skip in zip(self.ups, feats[3::-1]):
            d = up(d, skip, train)
        seg_conv = self.seg_head(d).float()
        z = x_patch
        for conv in self.trans_up:
            z = upsample2d(conv(z), 2, "bilinear_ac")
        seg_trans = self.trans_head(z).float()
        return seg_conv, seg_trans, (conv_cls, tran_cls)
