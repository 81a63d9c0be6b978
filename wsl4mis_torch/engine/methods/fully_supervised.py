"""Fully-supervised baseline (port of
``wsl4mis_tpu/engine/methods/fully_supervised.py``): loss = 0.5 * (CE(ignore
4) + Dice) on the configured supervision, SGD with poly decay."""

from __future__ import annotations

from ..config import TrainConfig
from .common import (
    MethodBundle,
    make_model_and_state,
    prep_batch,
    stage_dataset,
    standard_data,
    supervised_ce_dice,
    train_vis,
)


def make_step(cfg: TrainConfig):
    num_classes = cfg.num_classes
    augment = cfg.aug_mode != "host"

    def step_fn(state, batch, rngs, aux=None):
        x, labels = prep_batch(rngs["aug"], batch, aux, augment=augment)
        outputs = state.model(x, train=True, rngs=rngs)
        loss, loss_ce, loss_dice = supervised_ce_dice(outputs, labels,
                                                      num_classes)
        state.minimize(loss)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "loss_dice": loss_dice.detach(),
            "vis": train_vis(x, outputs, labels),
        }

    return step_fn


def build(cfg: TrainConfig) -> MethodBundle:
    model, state = make_model_and_state(cfg)
    train, val, it, spe = standard_data(cfg)
    return MethodBundle(model=model, state=state, step_fn=make_step(cfg),
                        aux=stage_dataset(cfg, train), data_iter=it,
                        val_volumes=val, steps_per_epoch=spe)
