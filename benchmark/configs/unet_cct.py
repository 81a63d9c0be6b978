"""Plain reference of the ``unet_cct`` configuration: WSL4MIS ``UNet_CCT``,
the UNet encoder with a main decoder and an auxiliary decoder fed the
encoder's features through channel dropout at 0.5 (F.dropout2d: a
(N,1,1,C) keep mask drawn from gens["feature_perturb"] for each feature,
shallow to deep, after the main decoder ran; kept channels scaled by 2),
and its work counts (``harness/work``: both decoders).
"""

from __future__ import annotations

import torch

from harness import work as W
from reference import unet as U
from reference.layers import Precision

DECODERS = ("main_decoder.", "aux_decoder1.")


def leaves(config: dict) -> list:
    return (U.encoder_leaves(config)
            + U.decoder_leaves(config, DECODERS[0])
            + U.decoder_leaves(config, DECODERS[1]))


def forward(P, x, config, train, gens=None, prec=Precision()):
    """(main logits, auxiliary logits); the auxiliary decoder sees the
    features as they are in eval mode."""
    feats = U.encode(P, x, config, train, prec,
                     None if gens is None else gens["dropout"])
    main = U.decode(P, DECODERS[0], feats, train, prec)
    if train:
        rate = config["aux_channel_dropout"]
        aux_feats = []
        for f in feats:
            keep = torch.rand((f.shape[0], 1, 1, f.shape[-1]),
                              generator=gens["feature_perturb"],
                              device=f.device) < (1.0 - rate)
            aux_feats.append(torch.where(keep, f / (1.0 - rate),
                                         torch.zeros((), device=f.device)))
        feats = aux_feats
    return main, U.decode(P, DECODERS[1], feats, train, prec)


def stats_pass(P, x, config, prec=Precision()):
    U.stats_pass(P, x, config, DECODERS, prec)


def forward_flops(config: dict) -> float:
    return W.unet_forward_flops(config, len(DECODERS))


def backward_flops(config: dict) -> float:
    return W.unet_backward_flops(config, len(DECODERS))


def conv_launches(config: dict, batch: int, dtype: str, train: bool) -> list:
    return W.conv3x3_launches(W.unet_convs(config, len(DECODERS)), batch,
                              dtype, train)
