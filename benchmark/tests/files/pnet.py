"""Plain reference of DeepIGeoS's P-Net (WSL4MIS ``code/networks/pnet.py``
``PNet2D``), in the port's parameter names, and its work counts: five
blocks of two dilated 3x3 convs (dilations 1, 2, 4, 8, 16), each followed
by BN and LeakyReLU, the five outputs concatenated, two 1x1 fusion convs,
and the output block (channel dropout 0.3 from gens["feature_perturb"],
1x1, LeakyReLU, channel dropout 0.3, 1x1 logits). A test adds it as a
configuration of another architecture, with files only."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from harness import work as W
from reference import layers as L
from reference.layers import Precision

RATIOS = (1, 2, 4, 8, 16)
DROP = 0.3


def _convs(config: dict) -> list:
    nf, (h, w) = config["num_filters"], config["patch_size"]
    chans = [config["in_chns"]] + [nf] * (len(RATIOS) - 1)
    out = []
    for b, c in enumerate(chans):
        out += [(f"block{b}.conv0", c, nf, h, w, True, b > 0),
                (f"block{b}.conv1", nf, nf, h, w, True, True)]
    return out


def _pointwise(config: dict) -> list:
    nf = config["num_filters"]
    widths = (nf * len(RATIOS), nf * 5, nf * 2, nf, config["class_num"])
    return list(zip(widths[:-1], widths[1:]))


def leaves(config: dict) -> list:
    out = []
    for i, (_, c, o, _, _, _, _) in enumerate(_convs(config)):
        b, j = divmod(i, 2)
        bound = 1.0 / math.sqrt(9 * c)
        pre = f"pnet_block.{b}."
        out += [(f"{pre}dilated_conv.{j}.kernel", (3, 3, c, o),
                 ("uniform", bound), "param"),
                (f"{pre}dilated_conv.{j}.bias", (o,), ("uniform", bound),
                 "param"),
                (f"{pre}batch_norm.{j}.scale", (o,), ("ones",), "param"),
                (f"{pre}batch_norm.{j}.bias", (o,), ("zeros",), "param"),
                (f"{pre}batch_norm.{j}.mean", (o,), ("zeros",), "buffer"),
                (f"{pre}batch_norm.{j}.var", (o,), ("ones",), "buffer")]
    for k, (c, o) in enumerate(_pointwise(config)):
        bound = 1.0 / math.sqrt(c)
        out += [(f"torch_conv.{k}.kernel", (1, 1, c, o), ("uniform", bound),
                 "param"),
                (f"torch_conv.{k}.bias", (o,), ("uniform", bound), "param")]
    return out


def forward(P, x, config, train, gens=None, prec=Precision()):
    h, feats = x, []
    for b, d in enumerate(RATIOS):
        for j in range(2):
            pre = f"pnet_block.{b}."
            k = prec.operand(P[f"{pre}dilated_conv.{j}.kernel"])
            h = prec.operand(F.conv2d(
                prec.operand(h).permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                P[f"{pre}dilated_conv.{j}.bias"], padding=d, dilation=d
            ).permute(0, 2, 3, 1))
            bn = f"{pre}batch_norm.{j}."
            h = L.leaky_relu(L.batch_norm(h, P[bn + "scale"], P[bn + "bias"],
                                          P[bn + "mean"], P[bn + "var"],
                                          train))
        feats.append(h)

    def pw(k, h):
        return prec.operand(prec.operand(h) @ prec.operand(
            P[f"torch_conv.{k}.kernel"][0, 0]) + P[f"torch_conv.{k}.bias"])

    def drop(h):
        keep = torch.rand((h.shape[0], 1, 1, h.shape[-1]),
                          generator=gens["feature_perturb"],
                          device=h.device) < 1.0 - DROP
        return torch.where(keep, h / (1.0 - DROP),
                           torch.zeros((), device=h.device))

    h = L.leaky_relu(pw(1, L.leaky_relu(pw(0, torch.cat(feats, -1)))))
    if train:
        h = drop(L.leaky_relu(pw(2, drop(h))))
    else:
        h = L.leaky_relu(pw(2, h))
    return pw(3, h)


def forward_flops(config: dict) -> float:
    h, w = config["patch_size"]
    return (sum(W.conv_flops(c, o, hh, ww)
                for _, c, o, hh, ww, _, _ in _convs(config))
            + sum(2.0 * c * o * h * w for c, o in _pointwise(config)))


def backward_flops(config: dict) -> float:
    return 2.0 * forward_flops(config) - W.conv_flops(*_convs(config)[0][1:5])


def conv_launches(config: dict, batch: int, dtype: str, train: bool) -> list:
    return W.conv3x3_launches(_convs(config), batch, dtype, train)
