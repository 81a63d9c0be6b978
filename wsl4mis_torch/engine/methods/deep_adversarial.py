"""Deep adversarial network (DAN) semi-supervised training (port of
``wsl4mis_tpu/engine/methods/deep_adversarial.py``; reference
train_deep_adversarial_network_2D.py:100-180). Both phases run in one step:

  G-step: sup = 0.5 * (CE + Dice) on the labeled part, plus w * CE(D(
          softmax(student(unlab)), unlab image), "labeled") with D in eval
          mode and no gradient into D's parameters; w = consistency *
          sigmoid_rampup(step // 150, consistency_rampup) on the step before
          the update; SGD on the segmenter.
  D-step: the updated segmenter re-run in eval mode (no gradient) on both
          parts; D in train mode (channel dropout) learns labeled (1) from
          unlabeled (0) predictions with CE, one reference Adam update.

The discriminator's parameters and Adam state live in state.extra
({"disc_params", "disc_opt_state"}; the discriminator module computes with
those very tensors). Its channel-dropout masks draw from
rngs["feature_perturb"]; a caller may pass `channel_masks` instead.
"""

from __future__ import annotations

import torch

from ...models.discriminator import FCDiscriminator
from ...ops import losses
from ...utils.device import resolve_device
from ..config import TrainConfig
from ..optim import adam_init, reference_adam
from .common import (
    MethodBundle,
    compute_dtype,
    make_model_and_state,
    paired_data,
    prep_batch,
    resolve_labeled_bs,
    semi_datasets,
    sigmoid_rampup,
    stage_dataset,
    train_vis,
)


def make_discriminator(cfg: TrainConfig):
    """(FCDiscriminator drawn from cfg.seed + 1 on cfg.device, its extra:
    {"disc_params": the module's parameter tensors, "disc_opt_state"})."""
    gen = torch.Generator().manual_seed(cfg.seed + 1)
    disc = FCDiscriminator(cfg.num_classes, cfg.patch_size,
                           dtype=compute_dtype(cfg), generator=gen)
    disc.to(resolve_device(cfg.device))
    return disc, discriminator_extra(disc)


def discriminator_extra(disc: FCDiscriminator) -> dict:
    """{"disc_params": views of disc's parameters, "disc_opt_state": a
    fresh reference Adam state}."""
    params = {k: p.detach() for k, p in disc.named_parameters()}
    return {"disc_params": params, "disc_opt_state": adam_init(params)}


def make_step(cfg: TrainConfig, disc: FCDiscriminator):
    num_classes = cfg.num_classes
    labeled_bs = resolve_labeled_bs(cfg)
    names, disc_params = zip(*disc.named_parameters())
    disc.requires_grad_(False)

    def step_fn(state, batch, rngs, aux=None, channel_masks=None):
        x, labels = prep_batch(rngs["aug"], batch, aux)
        x_lab, y_lab = x[:labeled_bs], labels[:labeled_bs]
        x_unlab = x[labeled_bs:]

        # G-step
        out_lab = state.model(x_lab, train=True, rngs=rngs)
        out_unlab = state.model(x_unlab, train=True, rngs=rngs)
        loss_ce = losses.cross_entropy(out_lab, y_lab)
        loss_dice = losses.dice_loss(torch.softmax(out_lab, dim=-1), y_lab,
                                     num_classes)
        supervised = 0.5 * (loss_ce + loss_dice)
        d_out = disc(torch.softmax(out_unlab, dim=-1), x_unlab, train=False)
        adversarial = losses.cross_entropy(d_out, torch.ones(
            d_out.shape[0], dtype=torch.int64, device=x.device))
        weight = cfg.consistency * sigmoid_rampup(
            state.step // 150, cfg.consistency_rampup)
        loss = supervised + weight * adversarial
        state.minimize(loss)

        # D-step
        with torch.no_grad():
            out_lab_eval = state.model(x_lab, train=False)
            out_unlab_eval = state.model(x_unlab, train=False)
            probs_all = torch.softmax(
                torch.cat([out_lab_eval, out_unlab_eval]), dim=-1)
        disc.requires_grad_(True)
        d_out = disc(probs_all, x, train=True,
                     generator=rngs["feature_perturb"],
                     channel_masks=channel_masks)
        d_target = torch.arange(x.shape[0], device=x.device) < labeled_bs
        d_loss = losses.cross_entropy(d_out, d_target.long())
        grads = torch.autograd.grad(d_loss, disc_params)
        disc.requires_grad_(False)
        reference_adam(state.extra["disc_params"], dict(zip(names, grads)),
                       state.extra["disc_opt_state"])
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "loss_dice": loss_dice.detach(),
            "consistency_loss": adversarial.detach(),
            "dan_loss": d_loss.detach(),
            "vis": train_vis(x_lab, out_lab_eval, y_lab),
        }

    return step_fn


def make_bundle(cfg: TrainConfig, labeled, unlabeled, val) -> MethodBundle:
    """The method on given labeled / unlabeled slice datasets: the stack
    [labeled; unlabeled] staged on the device, paired index batches."""
    model, state = make_model_and_state(cfg)
    disc, state.extra = make_discriminator(cfg)
    stack, it, spe = paired_data(cfg, labeled, unlabeled)
    return MethodBundle(model=model, state=state,
                        step_fn=make_step(cfg, disc),
                        aux=stage_dataset(cfg, stack), data_iter=it,
                        val_volumes=val, steps_per_epoch=spe)


def build(cfg: TrainConfig) -> MethodBundle:
    return make_bundle(cfg, *semi_datasets(cfg))
