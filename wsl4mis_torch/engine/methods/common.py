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
from ... import parallel
from ...data.augment import HostRandomGenerator
from ...models import net_factory
from ...models.factory import MODEL_NUM_OUTPUTS
from ...ops import losses
from ...utils.device import capturing, resolve_device
from ..config import TrainConfig
from ..optim import ReferenceSGD
from ..state import TrainState


@dataclass
class MethodBundle:
    """Everything the Trainer needs to run one method."""

    model: torch.nn.Module          # the model trained and validated
    state: TrainState
    step_fn: Callable               # (state, batch, rngs, aux) -> metrics
    data_iter: Iterator[dict]       # {"index"} batches into the staged
                                    # aux, or DeviceBatches of slices
    val_volumes: Any                # iterable of {"image", "label"} volumes
    steps_per_epoch: int
    aux: Any = None                 # the dataset staged on the device
                                    # (None with cfg.device_data False)
    host_hook: Callable | None = None  # (bundle, state, iter_num), run
                                       # after each iteration; updates
                                       # the state in place
    predictor: Any | None = None    # VolumePredictor in place of the
                                    # Trainer's argmax-of-the-model one
    val_variables: Callable | None = None  # (state) -> extra forward
                                    # kwargs of both validation rules
                                    # (state the model needs beside its
                                    # own tensors)
    nan_val_metrics: bool = False   # ScribbleVC's NaN conventions and
                                    # NaN-mean (val_2D_scribblevc.py:15-28)
    dice_snapshot_threshold: float | None = None
                                    # save {model}_{dice}_model.pth when
                                    # the val dice beats it
                                    # (train_ACDC_scribblevc.py:292-295)
    select_predictor: Any | None = None
                                    # a second predictor whose metric
                                    # drives best-model selection (logged
                                    # under info/val_select_*)
    eval_extra: tuple = ()          # state.extra keys the eval forward
                                    # needs, saved in inference checkpoints
    batch_parts: tuple | None = None  # the batch's parts, each sharded on
                                    # its own over a process group
                                    # (semi_parts); None: one part
    variant: Callable | None = None  # (state, seed) -> {keyword: value}:
                                    # the step's arguments that the host
                                    # decides at state.step (ustm's
                                    # rot_times, s2l's and scribblevc's
                                    # gates), which its eager step decides
                                    # alike when not given; a captured
                                    # step keeps a graph for each value
                                    # (engine.graph). None: one shape of
                                    # computation


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.compute_dtype]


def make_model_and_state(cfg: TrainConfig, *, model_name=None, extra=None):
    """Model with torch-default init drawn from cfg.seed, on cfg.device,
    and a fresh TrainState with the reference SGD. A method that names no
    model takes cfg.model's single output: a model with several raises
    ValueError (the JAX step fails on the tuple). An efficient_unet starts
    from cfg.encoder_weights where given (a file of
    ``convert_torch_weights``, read as the JAX package reads it)."""
    name = model_name or cfg.model
    outputs = MODEL_NUM_OUTPUTS.get(name, 1)
    if model_name is None and outputs != 1:
        raise ValueError(
            f"method {cfg.method!r} trains a model with one output; "
            f"model {name!r} returns {outputs}")
    device = resolve_device(cfg.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = net_factory(name, cfg.num_classes, dtype=compute_dtype(cfg),
                        generator=gen)
    if cfg.encoder_weights and name == "efficient_unet":
        from ...utils.checkpoint import load_jax_checkpoint
        from ...utils.torch_import import load_encoder_weights

        payload = load_jax_checkpoint(cfg.encoder_weights)
        load_encoder_weights(model, payload["encoder_params"],
                             payload["encoder_batch_stats"])
    model = model.to(device)
    opt = ReferenceSGD(model.parameters(), cfg.base_lr, cfg.max_iterations)
    return model, TrainState(model=model, opt=opt, extra=extra)


def standard_data(cfg: TrainConfig):
    """ACDC train slices (at their native sizes too with aug_mode "host"),
    the fold's val volumes, the batch stream (train_batches) and the steps
    per epoch."""
    train = AcdcSliceDataset(base_dir=cfg.root_path, fold=cfg.fold,
                             sup_type=cfg.sup_type,
                             patch_size=cfg.patch_size,
                             keep_native=cfg.aug_mode == "host",
                             limit=cfg.data_limit)
    val = AcdcVolumeDataset(base_dir=cfg.root_path, fold=cfg.fold,
                            limit=(4 if cfg.data_limit else None))
    return train, val, train_batches(cfg, train), len(train) // cfg.batch_size


def train_batches(cfg: TrainConfig, train) -> Iterator[dict]:
    """The step's batches over `train`: {"index"} batches into the slices
    staged on the device; with aug_mode "host" {"image", "label"} batches
    augmented on the host; with device_data False the slices themselves,
    {"image", "label"}, which the step augments. Both of the latter are
    DeviceBatches (copied to the device), and every stream draws the same
    slices in the same order from cfg.seed."""
    if cfg.aug_mode == "host":
        return DeviceBatches(_host_augmented_iterator(cfg, train),
                             resolve_device(cfg.device))
    if not cfg.device_data:
        return DeviceBatches(batch_iterator(train, cfg.batch_size,
                                            seed=cfg.seed),
                             resolve_device(cfg.device))
    return index_batches(cfg, train)


def index_batches(cfg: TrainConfig, train) -> Iterator[dict]:
    """{"index": (B,) int32} batches over a staged dataset."""
    it = batch_iterator(train, cfg.batch_size, seed=cfg.seed,
                        include_index=True)
    return ({"index": b["index"].astype(np.int32)} for b in it)


def _host_augmented_iterator(cfg: TrainConfig, train) -> Iterator[dict]:
    """numpy {"image": (B,H,W) f32, "label": (B,H,W) int32} batches over
    the index stream of the device path, each slice augmented at its
    native size and then zoomed (HostRandomGenerator, seeded cfg.seed)."""
    gen = HostRandomGenerator(cfg.patch_size, seed=cfg.seed)
    for b in batch_iterator(train, cfg.batch_size, seed=cfg.seed,
                            include_index=True):
        out = [gen({"image": train.native_images[i],
                    "label": train.native_labels[i]}) for i in b["index"]]
        yield {"image": np.stack([o["image"] for o in out]),
               "label": np.stack([o["label"] for o in out])}


class DeviceBatches:
    """Each numpy batch of `host` as tensors on `device`; on the card an
    asynchronous copy from pinned memory. The Trainer runs the stream in
    its prefetch thread, so the step neither waits for the copy nor spends
    host time on it, and the default stream, which both threads use,
    orders the copy before the step that reads the batch. ``map_host(fn)``
    is the same stream over fn of each host batch: under a process group
    the Trainer keeps the rank's rows there, before the copy."""

    def __init__(self, host: Iterator[dict], device):
        self.host, self.device = iter(host), torch.device(device)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        out = {}
        for k, v in next(self.host).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def map_host(self, fn: Callable[[dict], dict]) -> "DeviceBatches":
        return DeviceBatches(map(fn, self.host), self.device)


def resolve_labeled_bs(cfg: TrainConfig) -> int:
    """The semi-supervised split [labeled_bs labeled, batch_size -
    labeled_bs unlabeled]: cfg.labeled_bs if 0 < it < batch_size, else
    half the batch."""
    if 0 < cfg.labeled_bs < cfg.batch_size:
        return cfg.labeled_bs
    return cfg.batch_size // 2


def semi_parts(cfg: TrainConfig) -> tuple[int, int]:
    """(labeled, unlabeled) rows of a semi-supervised batch: the parts the
    student runs on apart, so each is sharded on its own."""
    labeled_bs = resolve_labeled_bs(cfg)
    return labeled_bs, cfg.batch_size - labeled_bs


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
    batch). With cfg.device_data False: no stack (None), and the stream
    ships the batches' slices, [labeled rows; unlabeled rows], as
    DeviceBatches."""
    labeled_bs, unlabeled_bs = semi_parts(cfg)
    spe = len(unlabeled) // unlabeled_bs
    it = paired_iterator(labeled, unlabeled, labeled_bs, unlabeled_bs,
                         seed=cfg.seed, images=not cfg.device_data)
    if not cfg.device_data:
        return None, DeviceBatches(it, resolve_device(cfg.device)), spe
    stack = ArraySliceDataset(
        np.concatenate([labeled.images, unlabeled.images]),
        np.concatenate([labeled.labels, unlabeled.labels]))
    return stack, it, spe


def stage_dataset(cfg: TrainConfig, train) -> dict | None:
    """The slice stack on the device: images f32, labels uint8; None with
    cfg.device_data False (the batches bring their slices)."""
    if not cfg.device_data:
        return None
    device = resolve_device(cfg.device)
    return {
        "images": torch.from_numpy(np.ascontiguousarray(train.images,
                                                        np.float32)).to(device),
        "labels": torch.from_numpy(train.labels.astype(np.uint8)).to(device),
    }


def prep_batch(generator, batch, staged=None, augment: bool = True,
               labeled: int | None = None):
    """Gather (from the staged dataset) + augmentation + NHWC expansion.

    batch is {"index"} over `staged`, or {"image", "label"} tensors already
    on the device (device_data False; augment=False when they arrive
    augmented: train_batches with aug_mode "host"); `labeled`: the batch
    is [labeled rows; the rest] (the semi family's parts, each sharded on
    its own, so the rank draws its rows of each part's policy). Returns
    (x (B,H,W,1) f32, labels (B,H,W) int32)."""
    if staged is not None and "index" in batch:
        idx = torch.as_tensor(batch["index"]).to(staged["images"].device,
                                                 torch.int64)
        images = staged["images"].index_select(0, idx)
        labels = staged["labels"].index_select(0, idx).to(torch.int32)
    else:
        images, labels = batch["image"], batch["label"]
    if augment:
        parts = () if labeled is None else (labeled,
                                             labels.shape[0] - labeled)
        with parallel.row_segments(*parts):
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
    step or a tensor of steps; an f32 tensor (on the tensor's device). A
    step passes a tensor of its step (``TrainState.step_tensor``): an int
    makes a CPU tensor, which a capture would freeze, so it raises there."""
    if not isinstance(current, torch.Tensor) and capturing():
        raise RuntimeError("sigmoid_rampup of a host step under capture: "
                           "pass the state's step_tensor()")
    cur = torch.as_tensor(current)
    if rampup_length == 0:
        return torch.ones((), device=cur.device)
    cur = cur.float().clamp(0.0, rampup_length)
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


def rng_seeds(seed: int, step: int, names=RNG_PURPOSES) -> dict:
    """The seed of each purpose's generator at one step, from (seed, step,
    purpose)."""
    return {name: int(np.random.SeedSequence([seed, step, i]).generate_state(
        1, np.uint64)[0]) for i, name in enumerate(names)}


def split_rngs(seed: int, step: int, device, names=RNG_PURPOSES) -> dict:
    """Per-purpose generators for one step, seeded from (seed, step,
    purpose): a resumed run draws what an uninterrupted one would."""
    out = {}
    for name, s in rng_seeds(seed, step, names).items():
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(s)
        out[name] = gen
    return out
