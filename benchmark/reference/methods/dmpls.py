"""DMPLS (WSL4MIS train_weakly_supervised_segmentation_pCE_ours_proposed,
on UNet_CCT): beta = rand() + 1e-10 from gens["method"];

    loss_ce  = 0.5 * (CE4(main) + CE4(aux))
    pseudo   = argmax(beta * p_main + (1 - beta) * p_aux), both detached
    loss_pse = 0.5 * (pDice(p_main, pseudo) + pDice(p_aux, pseudo))
    loss     = loss_ce + 0.5 * loss_pse

pDice: the multi-class soft Dice (smooth 1e-5, mean over classes) of the
probabilities and the one-hot target, both masked where the target is the
ignore class 4.
"""

from __future__ import annotations

import torch

from reference import layers as L

OPTIMIZER = "sgd"  # optimizers/sgd.py


def pdice(probs, target, classes, ignore=4, smooth=1e-5):
    mask = (target != ignore).float()[..., None]
    onehot = (target[..., None] == torch.arange(
        classes, device=target.device)).float()
    p, t = probs * mask, onehot * mask
    axes = (0, 1, 2)
    inter = (p * t).sum(axes)
    dice = 1.0 - (2.0 * inter + smooth) / (
        (p * p).sum(axes) + (t * t).sum(axes) + smooth)
    return dice.mean()


def loss(model, P, x, labels, config, gens, prec):
    beta = torch.rand((), generator=gens["method"], device=x.device) + 1e-10
    main, aux = model.forward(P, x, config, True, gens, prec)
    p1, p2 = torch.softmax(main, -1), torch.softmax(aux, -1)
    loss_ce = 0.5 * (L.cross_entropy(main, labels, 4)
                     + L.cross_entropy(aux, labels, 4))
    pseudo = (beta * p1.detach() + (1.0 - beta) * p2.detach()).argmax(-1)
    c = config["class_num"]
    loss_pse = 0.5 * (pdice(p1, pseudo, c) + pdice(p2, pseudo, c))
    return loss_ce + 0.5 * loss_pse


def work(net, config, batch, dtype):
    """(operations, 3x3 conv launches) of a step: one forward and backward
    of each slice of the batch."""
    return (batch * (net.forward_flops(config) + net.backward_flops(config)),
            net.conv_launches(config, batch, dtype, True))
