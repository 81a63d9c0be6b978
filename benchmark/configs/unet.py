"""Plain reference of the ``unet`` configuration: WSL4MIS ``UNet`` (one
encoder, one decoder; see ``reference/unet.py``), and its work counts
(``harness/work``)."""

from __future__ import annotations

from harness import work as W
from reference import unet as U
from reference.layers import Precision

DECODERS = ("decoder.",)


def leaves(config: dict) -> list:
    """(name, shape, init, "param" | "buffer") in the port's names."""
    return U.encoder_leaves(config) + U.decoder_leaves(config, DECODERS[0])


def forward(P, x, config, train, gens=None, prec=Precision()):
    """Logits (N,H,W,class_num) of x (N,H,W,in_chns); in train mode BN
    takes the batch's statistics (folded into P's running ones) and the
    dropout masks come from gens["dropout"]."""
    gen = None if gens is None else gens["dropout"]
    feats = U.encode(P, x, config, train, prec, gen)
    return U.decode(P, DECODERS[0], feats, train, prec)


def stats_pass(P, x, config, prec=Precision()):
    U.stats_pass(P, x, config, DECODERS, prec)


def forward_flops(config: dict) -> float:
    return W.unet_forward_flops(config, len(DECODERS))


def backward_flops(config: dict) -> float:
    return W.unet_backward_flops(config, len(DECODERS))


def conv_launches(config: dict, batch: int, dtype: str, train: bool) -> list:
    return W.conv3x3_launches(W.unet_convs(config, len(DECODERS)), batch,
                              dtype, train)
