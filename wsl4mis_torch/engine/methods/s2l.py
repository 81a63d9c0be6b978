"""Scribble2Label: confidence-gated pseudo labels from an EMA probability
buffer over the whole training set (port of
``wsl4mis_tpu/engine/methods/s2l.py``).

    loss = CE(ignore 4) on the scribbles
           + [step >= thr_iter] * 0.5 * CE(ignore 4) on the pseudo labels

A pseudo label is class c on an unscribbled pixel (class 4) whose EMA
class probability exceeds thr_conf, for c in 0..3 in order (a later class
wins). The buffer is state.extra["weight"], (N, H, W, 4) f32 on the
device: each step gathers its batch's rows and co-augments them with the
image and the scribble in one augment kernel (``data.augment_device.
augment_batch_s2l``, every map filled with 0); every period_iter
iterations the Trainer's host hook re-infers the whole train stack in eval
mode and sets w <- alpha * softmax(logits) + (1 - alpha) * w.

The gate is a Python comparison of the host step count, so it waits for
nothing on the device; the pseudo-label term's metric is computed either
way, without a gradient while the gate is closed (the JAX step multiplies
it by 0, which adds nothing).
"""

from __future__ import annotations

import torch

from ...data import AcdcSliceDataset, AcdcVolumeDataset
from ...data.augment_device import augment_batch_s2l
from ...ops import losses
from ..config import TrainConfig
from .common import (
    MethodBundle,
    index_batches,
    make_model_and_state,
    stage_dataset,
    train_vis,
)

REFRESH_BS = 32  # slices per eval forward of the refresh sweep


def pseudo_labels(scribbles, weights, thr_conf: float):
    """(B,H,W) int32: class c where the pixel is unscribbled and
    weights[..., c] > thr_conf (later classes win), else 4."""
    unscr = scribbles == 4
    out = torch.full_like(scribbles, 4)
    for c in range(4):
        out = torch.where(unscr & (weights[..., c] > thr_conf), c, out)
    return out


def make_step(cfg: TrainConfig):
    thr_conf = cfg.thr_conf
    thr_iter = cfg.thr_iter

    def step_fn(state, batch, rngs, aux=None):
        """batch {"index"} over the staged stack `aux`."""
        idx = torch.as_tensor(batch["index"]).to(aux["images"].device,
                                                 torch.int64)
        images = aux["images"].index_select(0, idx)
        scribbles = aux["labels"].index_select(0, idx).to(torch.int32)
        weights = state.extra["weight"].index_select(0, idx)
        images, scribbles, weights = augment_batch_s2l(
            rngs["aug"], images, scribbles, weights)
        x = images[..., None]
        outputs = state.model(x, train=True, rngs=rngs)
        loss_ce = losses.cross_entropy(outputs, scribbles, ignore_index=4)
        u_labels = pseudo_labels(scribbles, weights, thr_conf)
        gate = state.step >= thr_iter
        loss_u = losses.cross_entropy(
            outputs if gate else outputs.detach(), u_labels, ignore_index=4)
        loss = loss_ce + 0.5 * loss_u if gate else loss_ce
        state.minimize(loss)
        return {
            "total_loss": loss.detach(),
            "loss_ce": loss_ce.detach(),
            "loss_u": loss_u.detach(),
            "vis": train_vis(x, outputs, scribbles),
        }

    return step_fn


def make_refresh(cfg: TrainConfig, images: torch.Tensor):
    """The full-dataset EMA sweep over the staged (N, H, W) image stack:
    refresh(state) runs the model in eval mode on chunks of REFRESH_BS
    slices (the last one zero-padded, so every forward has one shape) and
    updates state.extra["weight"] chunk by chunk, in place, as
    alpha * p + (1 - alpha) * w with p the f32 softmax. Peak memory is one
    chunk's activations; the values are those of the JAX sweep, which
    materializes all N predictions first. No gradient, no BN statistics."""
    alpha = cfg.alpha
    n = images.shape[0]

    @torch.no_grad()
    def refresh(state):
        weight = state.extra["weight"]
        for start in range(0, n, REFRESH_BS):
            x = images[start:start + REFRESH_BS]
            rows = x.shape[0]
            if rows < REFRESH_BS:
                x = torch.cat([x, x.new_zeros((REFRESH_BS - rows,
                                               *x.shape[1:]))])
            logits = state.model(x[..., None], train=False)
            p = torch.softmax(logits.float(), dim=-1)[:rows]
            w = weight[start:start + rows]
            w.mul_(1 - alpha).add_(p.mul_(alpha))

    return refresh


def make_bundle(cfg: TrainConfig, train, val) -> MethodBundle:
    """The method on a given scribble slice dataset, staged on the device,
    with a zero weight buffer and the refresh as the host hook."""
    model, state = make_model_and_state(cfg)
    aux = stage_dataset(cfg, train)
    images = aux["images"]
    state.extra = {"weight": torch.zeros((*images.shape, 4),
                                         dtype=torch.float32,
                                         device=images.device)}
    refresh = make_refresh(cfg, images)

    def host_hook(bundle, state, iter_num):
        if iter_num > 0 and iter_num % cfg.period_iter == 0:
            refresh(state)

    return MethodBundle(model=model, state=state, step_fn=make_step(cfg),
                        aux=aux, data_iter=index_batches(cfg, train),
                        val_volumes=val,
                        steps_per_epoch=len(train) // cfg.batch_size,
                        host_hook=host_hook)


def build(cfg: TrainConfig) -> MethodBundle:
    """ACDC train slices with scribbles, whatever cfg.sup_type says."""
    train = AcdcSliceDataset(base_dir=cfg.root_path, fold=cfg.fold,
                             sup_type="scribble", patch_size=cfg.patch_size,
                             limit=cfg.data_limit)
    val = AcdcVolumeDataset(base_dir=cfg.root_path, fold=cfg.fold,
                            limit=(4 if cfg.data_limit else None))
    return make_bundle(cfg, train, val)
