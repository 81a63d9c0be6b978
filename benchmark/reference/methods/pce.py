"""Partial cross-entropy (WSL4MIS train_weakly_supervised_pCE_2D.py):
CrossEntropyLoss(ignore_index=4) of the logits against the scribbles."""

from __future__ import annotations

from reference import layers as L

OPTIMIZER = "sgd"  # optimizers/sgd.py


def loss(model, P, x, labels, config, gens, prec):
    logits = model.forward(P, x, config, True, gens, prec)
    return L.cross_entropy(logits, labels, ignore_index=4)


def work(net, config, batch, dtype):
    """(operations, 3x3 conv launches) of a step: one forward and backward
    of each slice of the batch."""
    return (batch * (net.forward_flops(config) + net.backward_flops(config)),
            net.conv_launches(config, batch, dtype, True))
