"""Partial cross-entropy on scribbles (port of
``wsl4mis_tpu/engine/methods/pce.py``): loss = CE(ignore 4)."""

from __future__ import annotations

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
    augment = cfg.aug_mode != "host"

    def step_fn(state, batch, rngs, aux=None):
        x, labels = prep_batch(rngs["aug"], batch, aux, augment=augment)
        outputs = state.model(x, train=True, rngs=rngs)
        loss = losses.cross_entropy(outputs, labels, ignore_index=4)
        state.minimize(loss)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss.detach(),
            "vis": train_vis(x, outputs, labels),
        }

    return step_fn


def build(cfg: TrainConfig) -> MethodBundle:
    model, state = make_model_and_state(cfg)
    train, val, it, spe = standard_data(cfg)
    return MethodBundle(model=model, state=state, step_fn=make_step(cfg),
                        aux=stage_dataset(cfg, train), data_iter=it,
                        val_volumes=val, steps_per_epoch=spe)
