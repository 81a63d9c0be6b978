"""Shared plumbing for method steps (port of
``wsl4mis_tpu/engine/methods/common.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ...data import (
    AcdcSliceDataset,
    AcdcVolumeDataset,
    ArraySliceDataset,
    augment_batch,
    batch_iterator,
    paired_iterator,
)
from ...models import net_factory
from ...ops import losses
from ...utils.device import resolve_device
from ..config import TrainConfig
from ..optim import ReferenceSGD
from ..state import TrainState


@dataclass
class MethodBundle:
    """Everything the Trainer needs to run one method."""

    model: torch.nn.Module          # the model trained and validated
    state: TrainState
    step_fn: Callable               # (state, batch, rngs, aux) -> metrics
    data_iter: Iterator[dict]       # host batches ({"index"} when staged)
    val_volumes: Any                # iterable of {"image", "label"} volumes
    steps_per_epoch: int
    aux: Any = None                 # the dataset staged on the device
    host_hook: Callable | None = None  # (bundle, state, iter_num), run
                                       # after each iteration; updates
                                       # the state in place


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.compute_dtype]


def make_model_and_state(cfg: TrainConfig, *, model_name=None, extra=None):
    """Model with torch-default init drawn from cfg.seed, on cfg.device,
    and a fresh TrainState with the reference SGD."""
    device = resolve_device(cfg.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = net_factory(model_name or cfg.model, cfg.num_classes,
                        dtype=compute_dtype(cfg), generator=gen).to(device)
    opt = ReferenceSGD(model.parameters(), cfg.base_lr, cfg.max_iterations)
    return model, TrainState(model=model, opt=opt, extra=extra)


def standard_data(cfg: TrainConfig):
    """ACDC train slices, the fold's val volumes, and an index-batch stream
    over the slices (the slices themselves are staged on the device)."""
    if cfg.aug_mode == "host":
        raise NotImplementedError(
            "aug_mode='host' (reference host augmentation, data/augment.py) "
            "is not ported yet: ROADMAP.md Queue 1 item 8")
    train = AcdcSliceDataset(base_dir=cfg.root_path, fold=cfg.fold,
                             sup_type=cfg.sup_type,
                             patch_size=cfg.patch_size, limit=cfg.data_limit)
    val = AcdcVolumeDataset(base_dir=cfg.root_path, fold=cfg.fold,
                            limit=(4 if cfg.data_limit else None))
    return train, val, index_batches(cfg, train), len(train) // cfg.batch_size


def index_batches(cfg: TrainConfig, train) -> Iterator[dict]:
    """{"index": (B,) int32} batches over a staged dataset."""
    it = batch_iterator(train, cfg.batch_size, seed=cfg.seed,
                        include_index=True)
    return ({"index": b["index"].astype(np.int32)} for b in it)


def resolve_labeled_bs(cfg: TrainConfig) -> int:
    """The semi-supervised split [labeled_bs labeled, batch_size -
    labeled_bs unlabeled]: cfg.labeled_bs if 0 < it < batch_size, else
    half the batch."""
    if 0 < cfg.labeled_bs < cfg.batch_size:
        return cfg.labeled_bs
    return cfg.batch_size // 2


def semi_datasets(cfg: TrainConfig):
    """The labeled and unlabeled train slices of the fold (dense labels on
    both, whatever cfg.sup_type says) and its val volumes."""
    labeled, unlabeled = (
        AcdcSliceDataset(base_dir=cfg.root_path, fold=cfg.fold,
                         sup_type="label", labeled_type=side,
                         patch_size=cfg.patch_size, limit=cfg.data_limit)
        for side in ("labeled", "unlabeled"))
    val = AcdcVolumeDataset(base_dir=cfg.root_path, fold=cfg.fold,
                            limit=(4 if cfg.data_limit else None))
    return labeled, unlabeled, val


def paired_data(cfg: TrainConfig, labeled, unlabeled):
    """(the stack [labeled; unlabeled] to stage, its paired index-batch
    stream, steps per epoch: the unlabeled slices over the unlabeled
    batch)."""
    labeled_bs = resolve_labeled_bs(cfg)
    unlabeled_bs = cfg.batch_size - labeled_bs
    stack = ArraySliceDataset(
        np.concatenate([labeled.images, unlabeled.images]),
        np.concatenate([labeled.labels, unlabeled.labels]))
    it = paired_iterator(labeled, unlabeled, labeled_bs, unlabeled_bs,
                         seed=cfg.seed)
    return stack, it, len(unlabeled) // unlabeled_bs


def stage_dataset(cfg: TrainConfig, train) -> dict:
    """The slice stack on the device: images f32, labels uint8."""
    device = resolve_device(cfg.device)
    return {
        "images": torch.from_numpy(np.ascontiguousarray(train.images,
                                                        np.float32)).to(device),
        "labels": torch.from_numpy(train.labels.astype(np.uint8)).to(device),
    }


def prep_batch(generator, batch, staged=None, augment: bool = True):
    """Gather (from the staged dataset) + augmentation + NHWC expansion.

    batch is {"index"} over `staged`, or {"image", "label"} tensors already
    on the device (augment=False when they arrive augmented). Returns
    (x (B,H,W,1) f32, labels (B,H,W) int32)."""
    if staged is not None and "index" in batch:
        idx = torch.as_tensor(batch["index"]).to(staged["images"].device,
                                                 torch.int64)
        images = staged["images"].index_select(0, idx)
        labels = staged["labels"].index_select(0, idx).to(torch.int32)
    else:
        images, labels = batch["image"], batch["label"]
    if augment:
        images, labels = augment_batch(generator, images, labels)
    return images[..., None], labels


def supervised_ce_dice(outputs, labels, num_classes: int):
    """0.5 * (CE(ignore=4) + Dice), the reference's supervised loss."""
    probs = torch.softmax(outputs, dim=-1)
    loss_ce = losses.cross_entropy(outputs, labels, ignore_index=4)
    loss_dice = losses.dice_loss(probs, labels, num_classes)
    return 0.5 * (loss_ce + loss_dice), loss_ce, loss_dice


def sigmoid_rampup(current, rampup_length: float):
    """exp(-5 (1 - t)^2), t = clip(current, 0, length) / length, for an int
    step or a tensor of steps; an f32 tensor (on the tensor's device)."""
    if rampup_length == 0:
        return torch.tensor(1.0)
    cur = torch.as_tensor(current).float().clamp(0.0, rampup_length)
    phase = 1.0 - cur / rampup_length
    return torch.exp(-5.0 * phase * phase)


def train_vis(x, logits, labels) -> dict:
    """Batch element 1's image, argmax prediction and label (the TB
    train/Image, Prediction, GroundTruth triptych)."""
    if isinstance(logits, (tuple, list)):
        logits = logits[0]
    i = 1 if x.shape[0] > 1 else 0
    return {
        "image": x[i, ..., 0].detach().float(),
        "pred": logits[i].detach().argmax(-1).to(torch.int32),
        "label": labels[i].to(torch.int32),
    }


RNG_PURPOSES = ("aug", "dropout", "feature_perturb", "method")


def split_rngs(seed: int, step: int, device, names=RNG_PURPOSES) -> dict:
    """Per-purpose generators for one step, seeded from (seed, step,
    purpose): a resumed run draws what an uninterrupted one would."""
    out = {}
    for i, name in enumerate(names):
        s = np.random.SeedSequence([seed, step, i]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(int(s))
        out[name] = gen
    return out
