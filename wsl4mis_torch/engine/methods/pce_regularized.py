"""pCE + regularizer family (port of
``wsl4mis_tpu/engine/methods/pce_regularized.py``): one step for five
methods that add a regularizer on the softmax output to the partial
cross-entropy on scribbles.

    pce_tv                  CE + 1e-2 * tv_loss(probs[..., 1:])
    pce_entropy_mini        CE + 0.1  * entropy_loss(probs, C)
    pce_gatedcrf            CE + 0.1  * gated_crf_loss(probs, x), radius 5,
                            kernels [{weight 1, xy 6, rgb 0.1}]
    pce_mumford_shah        CE + 1e-6 * mumford_shah_loss(x, probs)
    pce_intensity_variance  CE + w * (inter - intra), w = consistency *
                            sigmoid_rampup(step // 150, consistency_rampup)

x is the augmented input image (B,H,W,1). inter / intra are statistics of
img * probs with torch.std (unbiased), per sample, then averaged over the
(global) batch.
"""

from __future__ import annotations

import torch

from ... import parallel
from ...ops import losses
from ...ops.gated_crf import gated_crf_loss
from ..config import TrainConfig
from .common import (
    MethodBundle,
    make_model_and_state,
    prep_batch,
    sigmoid_rampup,
    stage_dataset,
    standard_data,
    train_vis,
)

METHODS = ("pce_tv", "pce_entropy_mini", "pce_gatedcrf", "pce_mumford_shah",
           "pce_intensity_variance")


def _intra_class_variance(probs, img):
    """std over the pixels of img * prob per (sample, class), then mean."""
    prod = img * probs  # (B,H,W,C)
    return parallel.global_mean(torch.std(prod.flatten(1, 2), dim=1).mean())


def _inter_class_variance(probs, img):
    """Pixel mean per (sample, class), std over the classes, then mean."""
    return parallel.global_mean(
        torch.std((img * probs).mean(dim=(1, 2)), dim=1).mean())


def make_step(cfg: TrainConfig):
    method = cfg.method
    if method not in METHODS:
        raise ValueError(f"unhandled method {method}")
    num_classes = cfg.num_classes
    augment = cfg.aug_mode != "host"

    def step_fn(state, batch, rngs, aux=None):
        x, labels = prep_batch(rngs["aug"], batch, aux, augment=augment)
        outputs = state.model(x, train=True, rngs=rngs)
        probs = torch.softmax(outputs, dim=-1)
        loss_ce = losses.cross_entropy(outputs, labels, ignore_index=4)
        if method == "pce_tv":
            reg = losses.tv_loss(probs[..., 1:])
            loss = loss_ce + 1e-2 * reg
        elif method == "pce_entropy_mini":
            reg = losses.entropy_loss(probs, num_classes)
            loss = loss_ce + 0.1 * reg
        elif method == "pce_gatedcrf":
            reg = gated_crf_loss(probs, x)
            loss = loss_ce + 0.1 * reg
        elif method == "pce_mumford_shah":
            reg = losses.mumford_shah_loss(x, probs)
            loss = loss_ce + 1e-6 * reg
        else:  # pce_intensity_variance
            reg = (_inter_class_variance(probs, x)
                   - _intra_class_variance(probs, x))
            weight = cfg.consistency * sigmoid_rampup(
                state.step_tensor() // 150, cfg.consistency_rampup)
            loss = loss_ce + weight * reg
        state.minimize(loss)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "loss_reg": reg.detach(),
            "vis": train_vis(x, outputs, labels),
        }

    return step_fn


def build(cfg: TrainConfig) -> MethodBundle:
    model, state = make_model_and_state(cfg)
    train, val, it, spe = standard_data(cfg)
    return MethodBundle(model=model, state=state, step_fn=make_step(cfg),
                        aux=stage_dataset(cfg, train), data_iter=it,
                        val_volumes=val, steps_per_epoch=spe)
