"""Offline test of trained checkpoints (port of ``wsl4mis_tpu/eval/infer.py``,
the reference's test_2D_fully.py):

* a sweep over the folds, each over its 20 held-out patients' volumes;
* batched slice inference (zoom, forward, argmax, zoom back) through the
  validation's VolumePredictor, so a checkpoint scores here what it
  scored in training;
* per-class Dice / HD95 / ASD at native voxel spacing, read from the
  original NIfTI (``{raw_data_path}/{case}.nii.gz``, by default
  ``ACDC_training/`` beside the data root) where it exists, else a default
  spacing with a warning (the H5 data carries none);
* the prediction, image and label of each case written as NIfTI;
* the per-fold means and the mean Dice over the folds printed.

The checkpoint is the port's own ``.pth`` or the JAX package's msgpack
file of the same name (``utils.checkpoint.load_model_checkpoint``). For a
model with several outputs the first is the main head
(test_2D_fully_sps.py:97-101).
"""

from __future__ import annotations

import logging
import os
import shutil
from dataclasses import dataclass

import numpy as np
import torch

from ..data.acdc import AcdcVolumeDataset, default_acdc_root
from ..data.nifti import read_spacing, write_nifti
from ..models import net_factory
from ..utils.checkpoint import load_model_checkpoint
from ..utils.device import resolve_device
from .metrics import calculate_metric_percase_spacing
from .val2d import VolumePredictor


@dataclass
class InferenceConfig:
    root_path: str | None = None
    exp: str = "ACDC"
    model: str = "unet"
    fold: str = "fold1"
    sup_type: str = "scribble"
    num_classes: int = 4
    snapshot_root: str = "model"
    checkpoint: str = "iter_60000.pth"
    raw_data_path: str | None = None        # dir with {case}.nii.gz
    default_spacing: tuple = (1.25, 1.25, 10.0)  # (sx, sy, sz) fallback
    save_predictions: bool = True
    compute_dtype: str = "bfloat16"
    folds: tuple = ("fold1", "fold2", "fold3", "fold4", "fold5")
    data_limit: int | None = None
    device: str = "cuda"                    # "cuda" or "cpu"; no fallback


def checkpoint_path(cfg: InferenceConfig, fold: str) -> tuple[str, str]:
    """(the checkpoint file, its snapshot dir): cfg.checkpoint, else
    {model}_best_model.pth with a warning."""
    snapshot = os.path.join(cfg.snapshot_root, f"{cfg.exp}_{fold}",
                            cfg.sup_type)
    path = os.path.join(snapshot, cfg.checkpoint)
    if not os.path.exists(path):
        fallback = os.path.join(snapshot, f"{cfg.model}_best_model.pth")
        if not os.path.exists(fallback):
            raise FileNotFoundError(f"no checkpoint at {path} or {fallback}")
        logging.warning("%s missing; using %s", path, fallback)
        path = fallback
    return path, snapshot


def load_model(cfg: InferenceConfig, path: str):
    """cfg.model on cfg.device with the checkpoint's weights."""
    model = net_factory(cfg.model, cfg.num_classes,
                        dtype=getattr(torch, cfg.compute_dtype))
    model = model.to(resolve_device(cfg.device))
    load_model_checkpoint(path, model)
    print(f"init weight from {path}")
    return model


def _case_spacing(cfg: InferenceConfig, case: str) -> tuple:
    """(sz, sx, sy), the reference's (spacing[2], spacing[0], spacing[1])
    permutation of the NIfTI's (sx, sy, sz), for the (z, y, x) arrays."""
    raw_dir = cfg.raw_data_path
    if raw_dir is None:
        raw_dir = os.path.join(
            os.path.dirname(cfg.root_path or default_acdc_root()),
            "ACDC_training")
    nii = os.path.join(raw_dir, f"{case}.nii.gz")
    if os.path.exists(nii):
        sx, sy, sz = read_spacing(nii)
    else:
        sx, sy, sz = cfg.default_spacing
        logging.warning("no raw NIfTI for %s; using default spacing %s",
                        case, cfg.default_spacing)
    return (sz, sx, sy)


def score_volumes(cfg: InferenceConfig, model, volumes, save_dir=None,
                  decision_fn=None, forward_kwargs=None, variables=None,
                  spacing=None):
    """(mean (classes-1, 3) [dice, hd95, asd] over `volumes`, their (D, H,
    W) int32 predictions); with save_dir, each case's {case}_pred, _img and
    _gt.nii.gz there, at the case's spacing. volumes: {"case", "image",
    "label"} dicts in memory. decision_fn, forward_kwargs and variables
    go to the validation's VolumePredictor (default: the argmax of the
    first output). spacing: one (sz, sx, sy) for every case, in place of
    each case's own (_case_spacing)."""
    predictor = VolumePredictor(model, (256, 256), device=cfg.device,
                                decision_fn=decision_fn,
                                forward_kwargs=forward_kwargs)
    preds = predictor.predict_volumes([vol["image"] for vol in volumes],
                                      variables)
    totals = np.zeros((cfg.num_classes - 1, 3), np.float64)
    for vol, prediction in zip(volumes, preds):
        case = vol["case"]
        case_spacing = spacing or _case_spacing(cfg, case)
        for i in range(1, cfg.num_classes):
            totals[i - 1] += calculate_metric_percase_spacing(
                prediction == i, vol["label"] == i, case_spacing)
        if save_dir is not None:
            sx_sy_sz = (case_spacing[1], case_spacing[2], case_spacing[0])
            for suffix, arr in (("pred", prediction), ("img", vol["image"]),
                                ("gt", vol["label"])):
                write_nifti(os.path.join(save_dir, f"{case}_{suffix}.nii.gz"),
                            np.asarray(arr).astype(np.float32), sx_sy_sz)
    return totals / len(volumes), preds


def inference_fold(cfg: InferenceConfig, fold: str) -> np.ndarray:
    """Mean (classes-1, 3) [dice, hd95, asd] per foreground class over the
    fold's volumes."""
    path, snapshot = checkpoint_path(cfg, fold)
    model = load_model(cfg, path)
    save_dir = None
    if cfg.save_predictions:
        save_dir = os.path.join(snapshot, f"{cfg.model}_predictions")
        if os.path.exists(save_dir):
            shutil.rmtree(save_dir)
        os.makedirs(save_dir)
    volumes = AcdcVolumeDataset(base_dir=cfg.root_path, fold=fold,
                                limit=cfg.data_limit)
    avg, _ = score_volumes(cfg, model, list(volumes), save_dir)
    print(avg)
    print(avg.mean(axis=0))
    return avg


def run_inference(cfg: InferenceConfig) -> float:
    """The fold sweep; the mean foreground Dice over the folds
    (test_2D_fully.py:168-177)."""
    total = 0.0
    for fold in cfg.folds:
        print(f"Inference {fold}")
        total += float(inference_fold(cfg, fold).mean(axis=0)[0])
    mean_dice = total / len(cfg.folds)
    print(mean_dice)
    return mean_dice


def load_scribblevc(path: str, num_classes: int, compute_dtype: str,
                    device: str):
    """(ScribbleVC on `device` with the checkpoint's weights, its class
    memory): the checkpoint's memory, or zeros where it holds none (an
    older checkpoint; the test's rule does not read it)."""
    model = net_factory("scribblevc", num_classes,
                        dtype=getattr(torch, compute_dtype))
    model = model.to(resolve_device(device))
    memory = model.init_memory((256, 256), model.cls_token.device)
    load_model_checkpoint(path, model, {"class_memory": memory},
                          extra_optional=True)
    print(f"init weight from {path}")
    return model, memory


def score_scribblevc(cfg: InferenceConfig, model, memory, volumes,
                     spacing=None):
    """ScribbleVC's offline test (test_ACDC_scribblevc.py,
    test_scribblevc.py): the argmax of the two heads' mean softmax without
    the class memory, the ScribbleVC bundle's select predictor, so a
    checkpoint's Dice equals its select-rule validation's; mean (classes-1,
    3) [dice, hd95, asd] at the cases' spacing, or at `spacing` (sz, sx,
    sy) for every case (the --checkpoints test's, cli.MULTI_SPACING)."""
    from ..engine.methods.scribblevc import mean_softmax_decision

    avg, _ = score_volumes(cfg, model, volumes,
                           decision_fn=mean_softmax_decision,
                           forward_kwargs={"use_class_rep": False},
                           variables={"memory": memory}, spacing=spacing)
    return avg
