"""DMPLS, dynamically mixed pseudo-label supervision (port of
``wsl4mis_tpu/engine/methods/dmpls.py``), on UNet_CCT:

    loss_ce  = 0.5 * (CE4(main) + CE4(aux))
    pseudo   = argmax(beta * p1.detach() + (1 - beta) * p2.detach())
    loss_pse = 0.5 * (pDice(p1, pseudo) + pDice(p2, pseudo))
    loss     = loss_ce + 0.5 * loss_pse

beta ~ U(0, 1) + 1e-10 is drawn per step from rngs["method"]; a caller may
pass `beta` (and the aux branch's `channel_masks`) instead.
"""

from __future__ import annotations

import torch

from ...ops import losses
from ..config import TrainConfig
from .common import (
    MethodBundle,
    make_model_and_state,
    prep_batch,
    stage_dataset,
    standard_data,
    train_vis,
)


def make_step(cfg: TrainConfig):
    num_classes = cfg.num_classes
    augment = cfg.aug_mode != "host"

    def step_fn(state, batch, rngs, aux=None, beta=None, channel_masks=None):
        x, labels = prep_batch(rngs["aug"], batch, aux, augment=augment)
        if beta is None:
            beta = torch.rand((), generator=rngs["method"],
                              device=x.device) + 1e-10
        out_main, out_aux = state.model(x, train=True, rngs=rngs,
                                        channel_masks=channel_masks)
        p1 = torch.softmax(out_main, dim=-1)
        p2 = torch.softmax(out_aux, dim=-1)
        loss_ce = 0.5 * (
            losses.cross_entropy(out_main, labels, ignore_index=4)
            + losses.cross_entropy(out_aux, labels, ignore_index=4)
        )
        mixed = beta * p1.detach() + (1.0 - beta) * p2.detach()
        pseudo = mixed.argmax(-1)
        loss_pse = 0.5 * (losses.pdice_loss(p1, pseudo, num_classes)
                          + losses.pdice_loss(p2, pseudo, num_classes))
        loss = loss_ce + 0.5 * loss_pse
        state.minimize(loss)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "loss_pse_sup": loss_pse.detach(),
            "vis": train_vis(x, out_main, labels),
        }

    return step_fn


def build(cfg: TrainConfig) -> MethodBundle:
    model, state = make_model_and_state(cfg, model_name="unet_cct")
    train, val, it, spe = standard_data(cfg)
    return MethodBundle(model=model, state=state, step_fn=make_step(cfg),
                        aux=stage_dataset(cfg, train), data_iter=it,
                        val_volumes=val, steps_per_epoch=spe)
