"""Plain reference of WSL4MIS ``code/networks/unet.py``: the Encoder, the
Decoder and their ConvBlock, functional over a dict of tensors named as
the port names its parameters and BN statistics.

ConvBlock = conv3x3 -> BN -> LeakyReLU(0.01) -> dropout -> conv3x3 -> BN ->
LeakyReLU; the encoder's blocks at feature_chns with dropout p, 2x2 max
pool between them; each decoder level upsamples the deeper feature with
a 2x2 stride-2 transposed conv, concatenates [skip, up] and runs a
ConvBlock without dropout; a 3x3 head gives the logits. Initialisation is
torch's default: U(+-1/sqrt(fan_in)) for weights and biases, fan_in =
9*C for a 3x3 conv and 4*O for a transposed conv (torch reads it from
the weight's dim 1); BN scale 1, bias 0, running mean 0, variance 1.
"""

from __future__ import annotations

import math

import torch

from . import layers as L


def _block_leaves(pre: str, cin: int, cout: int) -> list:
    out = []
    for i, c in ((1, cin), (2, cout)):
        bound = 1.0 / math.sqrt(9 * c)
        out += [(f"{pre}conv{i}.kernel", (3, 3, c, cout),
                 ("uniform", bound), "param"),
                (f"{pre}conv{i}.bias", (cout,), ("uniform", bound), "param"),
                (f"{pre}bn{i}.scale", (cout,), ("ones",), "param"),
                (f"{pre}bn{i}.bias", (cout,), ("zeros",), "param"),
                (f"{pre}bn{i}.mean", (cout,), ("zeros",), "buffer"),
                (f"{pre}bn{i}.var", (cout,), ("ones",), "buffer")]
    return out


def encoder_leaves(config: dict, pre: str = "encoder.") -> list:
    f = config["feature_chns"]
    chans = [config["in_chns"], *f]
    out = []
    for i in range(len(f)):
        out += _block_leaves(f"{pre}blocks.{i}.", chans[i], f[i])
    return out


def decoder_leaves(config: dict, pre: str) -> list:
    f = config["feature_chns"]
    out = []
    for j, i in enumerate(range(len(f) - 2, -1, -1)):
        bound = 1.0 / math.sqrt(4 * f[i])
        out += [(f"{pre}ups.{j}.up.kernel", (2, 2, f[i + 1], f[i]),
                 ("uniform", bound), "param"),
                (f"{pre}ups.{j}.up.bias", (f[i],), ("uniform", bound),
                 "param")]
        out += _block_leaves(f"{pre}ups.{j}.block.", 2 * f[i], f[i])
    bound = 1.0 / math.sqrt(9 * f[0])
    out += [(f"{pre}head.kernel", (3, 3, f[0], config["class_num"]),
             ("uniform", bound), "param"),
            (f"{pre}head.bias", (config["class_num"],), ("uniform", bound),
             "param")]
    return out


def conv_block(P, pre, x, train, prec, dropout_p=0.0, gen=None,
               update=True):
    def conv_bn(i, x):
        x = L.conv3x3(x, P[f"{pre}conv{i}.kernel"], P[f"{pre}conv{i}.bias"],
                      prec)
        x = L.batch_norm(x, P[f"{pre}bn{i}.scale"], P[f"{pre}bn{i}.bias"],
                         P[f"{pre}bn{i}.mean"], P[f"{pre}bn{i}.var"], train,
                         update=update)
        return L.leaky_relu(x)

    x = conv_bn(1, x)
    if train and dropout_p > 0:
        keep = 1.0 - dropout_p
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        x = x * mask * (1.0 / keep)
    return conv_bn(2, x)


def encode(P, x, config, train, prec, gen=None, update=True,
           pre="encoder."):
    """The encoder's features, shallow to deep; x (N,H,W,in_chns)."""
    feats = []
    for i, p in enumerate(config["dropout"]):
        if i > 0:
            x = L.max_pool2x2(x)
        x = conv_block(P, f"{pre}blocks.{i}.", x, train, prec, p, gen,
                       update)
        feats.append(x)
    return feats


def decode(P, pre, feats, train, prec, update=True):
    """Logits (N,H,W,classes) of the decoder whose leaves start `pre`."""
    x = feats[-1]
    levels = range(len(feats) - 2, -1, -1)
    for j, i in enumerate(levels):
        up = L.conv_transpose2x2(x, P[f"{pre}ups.{j}.up.kernel"],
                                 P[f"{pre}ups.{j}.up.bias"], prec)
        x = conv_block(P, f"{pre}ups.{j}.block.",
                       torch.cat([feats[i], up], dim=-1), train, prec,
                       update=update)
    return L.conv3x3(x, P[f"{pre}head.kernel"], P[f"{pre}head.bias"], prec)


def stats_pass(P, x, config, forward_leaves_decoders, prec):
    """Set every BN layer's running statistics to those of batch x (a
    forward in train mode without dropout, momentum 0): gives an
    untrained network the normalisation a trained one carries."""
    with torch.no_grad():
        saved = {k: v.clone() for k, v in P.items()
                 if k.endswith((".mean", ".var"))}
        feats = encode(P, x, {**config, "dropout": [0.0] *
                              len(config["dropout"])}, True, prec)
        for pre in forward_leaves_decoders:
            decode(P, pre, feats, True, prec)
        # one update with momentum 0.9 moved 0.1 of the way: solve for
        # the batch's statistics
        for k, old in saved.items():
            P[k].copy_((P[k] - 0.9 * old) / 0.1)
