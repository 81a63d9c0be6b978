"""Semi-supervised family (port of
``wsl4mis_tpu/engine/methods/mean_teacher.py``): four methods on the
labeled + unlabeled two-stream batch [labeled_bs labeled; the rest
unlabeled], dense labels on the labeled part only.

    partially_supervised  loss = sup = 0.5 * (CE + Dice) on the labeled part
    entropy_minimization  sup + w * entropy_loss(softmax(student(unlab)))
    mean_teacher          sup + w * mean((softmax(student(unlab))
                                - softmax(teacher(unlab + noise)))^2)
    uamt                  sup + w * masked MSE, the mask keeping the pixels
                          whose MC predictive entropy of the teacher (T = 8
                          noisy passes) is under (0.75 + 0.25 *
                          rampup(step, max_iterations)) * ln 2

w = consistency * sigmoid_rampup(step // 300, consistency_rampup) on the
step before the update; noise = clip(0.1 N(0, 1), -0.2, 0.2). The teacher
of mean_teacher and uamt is the student's network over EMA parameters
(state.extra["ema_params"]), run in train mode without gradients and
updated after each SGD step (state.ema_update, alpha = cfg.ema_decay).

The noises and teacher dropout draw from rngs["method"]; a caller may pass
the noises instead (`noise`, `mc_noise`).
"""

from __future__ import annotations

import copy
import math

import torch

from ...models.norm import FusedBatchNorm
from ...ops import losses
from ..config import TrainConfig
from ..state import ema_copy, ema_update
from .common import (
    MethodBundle,
    make_model_and_state,
    paired_data,
    prep_batch,
    resolve_labeled_bs,
    semi_datasets,
    sigmoid_rampup,
    stage_dataset,
    train_vis,
)

METHODS = ("mean_teacher", "uamt", "entropy_minimization",
           "partially_supervised")
TEACHER_METHODS = ("mean_teacher", "uamt")


def clamped_noise(generator, shape) -> torch.Tensor:
    """torch.clamp(randn * 0.1, -0.2, 0.2) (train_mean_teacher_2D.py:147-
    149), on the generator's device."""
    return torch.randn(shape, generator=generator,
                       device=generator.device).mul_(0.1).clamp_(-0.2, 0.2)


class EmaTeacher:
    """The student's network over the EMA parameters
    state.extra["ema_params"]: a copy of state.model whose parameters are
    those very tensors, so that the in-place EMA update is what it computes
    with, and whose BN layers keep no running statistics (a train-mode
    forward does not read them; the JAX package discards the teacher's
    update of the student's). Made at the first call, and again if the
    state's EMA tensors are replaced."""

    def __init__(self):
        self._ema = self._net = None

    def __call__(self, state) -> torch.nn.Module:
        ema = state.extra["ema_params"]
        if ema is not self._ema:
            net = copy.deepcopy(state.model).requires_grad_(False)
            for name, p in net.named_parameters():
                p.data, p.grad = ema[name], None
            for m in net.modules():
                if isinstance(m, FusedBatchNorm):
                    m.update_stats = False
            self._ema, self._net = ema, net
        return self._net


@torch.no_grad()
def teacher_forward(teacher, x, generator):
    """The teacher in train mode (dropout on, batch statistics), without
    gradients: the reference's ema_model.train() under no_grad."""
    return teacher(x, train=True, rngs={"dropout": generator})


@torch.no_grad()
def mc_uncertainty(teacher, x, generator, noises=None, T=8):
    """Predictive entropy (B,H,W,1) of the teacher over T noisy passes,
    run as T // 2 passes of the doubled batch [x; x] (BN's batch statistics
    span both copies): preds = (acc[:B] + acc[B:]) / T, entropy with
    log(p + 1e-6). `noises`: the passes' (2B,H,W,1) noises."""
    tiled = torch.cat([x, x])
    if noises is None:
        noises = [clamped_noise(generator, tiled.shape)
                  for _ in range(T // 2)]
    acc = sum(torch.softmax(teacher_forward(teacher, tiled + n, generator),
                            dim=-1) for n in noises)
    b = x.shape[0]
    preds = (acc[:b] + acc[b:]) / T
    return -torch.sum(preds * torch.log(preds + 1e-6), dim=-1, keepdim=True)


def certain_mask(uncertainty, step: int, max_iterations: int):
    """1 where the uncertainty is under (0.75 + 0.25 * rampup(step,
    max_iterations)) * ln 2, else 0 (f32)."""
    thresh = (0.75 + 0.25 * sigmoid_rampup(step, max_iterations)) * \
        math.log(2.0)
    return (uncertainty < thresh).float()


def masked_mse(mask, dist):
    """sum(mask * dist) / (2 sum(mask) + 1e-16)."""
    return torch.sum(mask * dist) / (2 * torch.sum(mask) + 1e-16)


def make_step(cfg: TrainConfig):
    method = cfg.method
    if method not in METHODS:
        raise ValueError(f"unhandled method {method}")
    num_classes = cfg.num_classes
    labeled_bs = resolve_labeled_bs(cfg)
    teacher_of = EmaTeacher()

    def step_fn(state, batch, rngs, aux=None, noise=None, mc_noise=None):
        # the reference always augments here, aug_mode notwithstanding
        x, labels = prep_batch(rngs["aug"], batch, aux)
        x_lab, y_lab = x[:labeled_bs], labels[:labeled_bs]
        x_unlab = x[labeled_bs:]
        out_lab = state.model(x_lab, train=True, rngs=rngs)
        loss_ce = losses.cross_entropy(out_lab, y_lab)
        loss_dice = losses.dice_loss(torch.softmax(out_lab, dim=-1), y_lab,
                                     num_classes)
        supervised = 0.5 * (loss_ce + loss_dice)
        if method == "partially_supervised":
            loss = supervised
            consistency = torch.zeros((), device=x.device)
        else:
            out_unlab = state.model(x_unlab, train=True, rngs=rngs)
            probs_unlab = torch.softmax(out_unlab, dim=-1)
            if method == "entropy_minimization":
                consistency = losses.entropy_loss(probs_unlab, num_classes)
            else:
                teacher = teacher_of(state)
                gen = rngs["method"]
                if noise is None:
                    noise = clamped_noise(gen, x_unlab.shape)
                ema_out = teacher_forward(teacher, x_unlab + noise, gen)
                if method == "mean_teacher":
                    consistency = torch.mean(
                        (probs_unlab - torch.softmax(ema_out, dim=-1)) ** 2)
                else:  # uamt
                    dist = losses.softmax_mse_loss(out_unlab, ema_out)
                    unc = mc_uncertainty(teacher, x_unlab, gen, mc_noise)
                    consistency = masked_mse(
                        certain_mask(unc, state.step, cfg.max_iterations),
                        dist)
            weight = cfg.consistency * sigmoid_rampup(
                state.step // 300, cfg.consistency_rampup)
            loss = supervised + weight * consistency
        state.minimize(loss)
        if method in TEACHER_METHODS:
            ema_update(state.extra["ema_params"], state.model, cfg.ema_decay,
                       state.step)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "loss_dice": loss_dice.detach(),
            "consistency_loss": consistency.detach(),
            "vis": train_vis(x_lab, out_lab, y_lab),
        }

    return step_fn


def make_bundle(cfg: TrainConfig, labeled, unlabeled, val) -> MethodBundle:
    """The method on given labeled / unlabeled slice datasets: the stack
    [labeled; unlabeled] staged on the device, paired index batches."""
    model, state = make_model_and_state(cfg)
    if cfg.method in TEACHER_METHODS:
        state.extra = {"ema_params": ema_copy(model)}
    stack, it, spe = paired_data(cfg, labeled, unlabeled)
    return MethodBundle(model=model, state=state, step_fn=make_step(cfg),
                        aux=stage_dataset(cfg, stack), data_iter=it,
                        val_volumes=val, steps_per_epoch=spe)


def build(cfg: TrainConfig) -> MethodBundle:
    return make_bundle(cfg, *semi_datasets(cfg))
