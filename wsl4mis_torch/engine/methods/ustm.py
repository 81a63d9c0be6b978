"""USTM: uncertainty-aware self-ensembling and transformation-consistent
mean teacher on scribbles (port of ``wsl4mis_tpu/engine/methods/ustm.py``).

    x_rot    = rot90(x, k) in the (H, W) plane, k ~ U{0..3} per step
    ema_out  = teacher(x_rot + noise); uncertainty from T = 8 noisy teacher
               passes of x_rot (mean_teacher.mc_uncertainty)
    loss     = CE(ignore 4) + w * masked MSE(rot90(student(x), k), ema_out)

with the mask of uamt (mean_teacher.certain_mask), w = sigmoid_rampup(step
// 1000, 60) on the step before the update, and an EMA teacher (alpha 0.99)
updated after each SGD step. The rotation, the noises and the teacher's
dropout draw from rngs["method"] (the rotation from a host generator with
that generator's seed, so no draw waits for the device); a caller may pass
`rot_times`, `noise` and `mc_noise` instead.
"""

from __future__ import annotations

import torch

from ...ops import losses
from ..config import TrainConfig
from ..state import ema_copy, ema_update
from .common import (
    MethodBundle,
    index_batches,
    make_model_and_state,
    prep_batch,
    sigmoid_rampup,
    stage_dataset,
    standard_data,
    train_vis,
)
from .mean_teacher import (
    EmaTeacher,
    certain_mask,
    clamped_noise,
    masked_mse,
    mc_uncertainty,
    teacher_forward,
)


def make_step(cfg: TrainConfig):
    augment = cfg.aug_mode != "host"
    teacher_of = EmaTeacher()

    def step_fn(state, batch, rngs, aux=None, rot_times=None, noise=None,
                mc_noise=None):
        x, labels = prep_batch(rngs["aug"], batch, aux, augment=augment)
        gen = rngs["method"]
        if rot_times is None:
            host = torch.Generator().manual_seed(gen.initial_seed())
            rot_times = int(torch.randint(0, 4, (), generator=host))
        x_rot = torch.rot90(x, rot_times, dims=(1, 2))
        teacher = teacher_of(state)
        if noise is None:
            noise = clamped_noise(gen, x_rot.shape)
        ema_out = teacher_forward(teacher, x_rot + noise, gen)
        mask = certain_mask(mc_uncertainty(teacher, x_rot, gen, mc_noise),
                            state.step, cfg.max_iterations)
        weight = sigmoid_rampup(state.step // 1000, 60.0)

        outputs = state.model(x, train=True, rngs=rngs)
        loss_ce = losses.cross_entropy(outputs, labels, ignore_index=4)
        dist = losses.softmax_mse_loss(
            torch.rot90(outputs, rot_times, dims=(1, 2)), ema_out)
        consistency = masked_mse(mask, dist)
        loss = loss_ce + weight * consistency
        state.minimize(loss)
        ema_update(state.extra["ema_params"], state.model, 0.99, state.step)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "consistency_loss": consistency.detach(),
            "vis": train_vis(x, outputs, labels),
        }

    return step_fn


def make_bundle(cfg: TrainConfig, train, val) -> MethodBundle:
    """The method on a given slice dataset, staged on the device."""
    model, state = make_model_and_state(cfg)
    state.extra = {"ema_params": ema_copy(model)}
    return MethodBundle(model=model, state=state, step_fn=make_step(cfg),
                        aux=stage_dataset(cfg, train),
                        data_iter=index_batches(cfg, train), val_volumes=val,
                        steps_per_epoch=len(train) // cfg.batch_size)


def build(cfg: TrainConfig) -> MethodBundle:
    train, val, _, _ = standard_data(cfg)
    return make_bundle(cfg, train, val)
