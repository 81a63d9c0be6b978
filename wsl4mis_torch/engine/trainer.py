"""Generic training loop (port of ``wsl4mis_tpu/engine/trainer.py``).

Keeps the reference run contract: TensorBoard tags (info/lr,
info/total_loss, info/loss_ce, info/val_*) when tensorboardX is present,
validation every ``val_every`` iterations with best-model checkpoints,
periodic checkpoints every ``ckpt_every``, log.txt + stdout logging and
the snapshot dir ``{root}/{exp}_{fold}/{sup_type}``.

Each step runs eagerly on cfg.device with per-step generators from
(cfg.seed, iteration); metrics stay on the device until the logging
cadence reads them.
"""

from __future__ import annotations

import logging
import os
import shutil

import numpy as np

from ..data.loader import prefetch
from ..eval.val2d import VolumePredictor, evaluate_fold
from ..utils.checkpoint import (
    restore_train_state,
    save_model_checkpoint,
    save_train_state,
)
from ..utils.device import resolve_device
from ..utils.logging_utils import Timer, setup_run_logging
from .config import TrainConfig
from .methods.common import MethodBundle, split_rngs
from .optim import poly_lr


class Trainer:
    def __init__(self, cfg: TrainConfig, bundle: MethodBundle,
                 use_tensorboard: bool = True):
        self.cfg = cfg
        self.bundle = bundle
        self.device = resolve_device(cfg.device)
        self.snapshot_path = cfg.snapshot_path
        os.makedirs(self.snapshot_path, exist_ok=True)
        setup_run_logging(self.snapshot_path)
        self._snapshot_code()

        self.state = bundle.state
        self.image_every = 20  # train_fully_supervised_2D.py:121
        self.data_iter = prefetch(bundle.data_iter, size=4)
        self.predictor = VolumePredictor(bundle.model, cfg.patch_size,
                                         device=self.device)
        self.lr = poly_lr(cfg.base_lr, cfg.max_iterations)

        self.writer = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                logging.warning("tensorboardX unavailable; scalars not "
                                "logged")
            else:
                self.writer = SummaryWriter(self.snapshot_path + "/log")

        if cfg.resume:
            ckpt = os.path.join(self.snapshot_path, "latest_full.ckpt")
            if os.path.exists(ckpt):
                restore_train_state(ckpt, self.state)
                logging.info("resumed from %s at step %d", ckpt,
                             self.state.step)

    def _snapshot_code(self):
        """Copy the library into the run dir for provenance."""
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(self.snapshot_path, "code")
        try:
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
                "__pycache__", ".git"))
        except OSError as e:
            logging.warning("code snapshot failed: %s", e)

    def _scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def _images(self, vis, step):
        if self.writer is None or vis is None:
            return
        image = vis["image"].cpu().numpy()
        lo, hi = image.min(), image.max()
        image = (image - lo) / max(hi - lo, 1e-12)
        self.writer.add_image("train/Image", image[None], step)
        pred = (vis["pred"].cpu().numpy() * 50).astype(np.uint8)
        self.writer.add_image("train/Prediction", pred[None], step)
        lab = (vis["label"].cpu().numpy() * 50).astype(np.uint8)
        self.writer.add_image("train/GroundTruth", lab[None], step)

    def validate(self, iter_num: int) -> tuple[float, float]:
        """Mean (dice, hd95) over the val volumes; logs per-class tags."""
        metric_list = evaluate_fold(self.predictor, self.bundle.val_volumes,
                                    self.cfg.num_classes)
        for class_i in range(self.cfg.num_classes - 1):
            self._scalar(f"info/val_{class_i + 1}_dice",
                         metric_list[class_i, 0], iter_num)
            self._scalar(f"info/val_{class_i + 1}_hd95",
                         metric_list[class_i, 1], iter_num)
        performance = float(metric_list[:, 0].mean())
        mean_hd95 = float(metric_list[:, 1].mean())
        self._scalar("info/val_mean_dice", performance, iter_num)
        self._scalar("info/val_mean_hd95", mean_hd95, iter_num)
        return performance, mean_hd95

    def _save_model(self, name: str):
        save_model_checkpoint(os.path.join(self.snapshot_path, name),
                              self.state)

    def train(self) -> str:
        cfg = self.cfg
        logging.info("%d iterations per epoch", self.bundle.steps_per_epoch)
        iter_num = self.state.step
        best_performance = 0.0
        timer = Timer()

        while iter_num < cfg.max_iterations:
            batch = next(self.data_iter)
            rngs = split_rngs(cfg.seed, iter_num, self.device)
            metrics = self.bundle.step_fn(self.state, batch, rngs,
                                          self.bundle.aux)
            iter_num += 1

            if iter_num % self.image_every == 0:
                self._images(metrics.get("vis"), iter_num)

            if iter_num % cfg.log_every == 0:
                host = {k: float(v) for k, v in metrics.items() if k != "vis"}
                lr = self.lr(iter_num)
                self._scalar("info/lr", lr, iter_num)
                for k, v in host.items():
                    self._scalar(f"info/{k}", v, iter_num)
                logging.info(
                    "iteration %d : %s : %.1f ms/it", iter_num,
                    " ".join(f"{k}: {v:f}" for k, v in host.items()),
                    1e3 * timer.tick() / cfg.log_every,
                )

            if iter_num > 0 and iter_num % cfg.val_every == 0:
                performance, mean_hd95 = self.validate(iter_num)
                if performance > best_performance:
                    best_performance = performance
                    self._save_model(f"iter_{iter_num}_dice_"
                                     f"{round(best_performance, 4)}.pth")
                    self._save_model(f"{cfg.model}_best_model.pth")
                logging.info("iteration %d : mean_dice : %f mean_hd95 : %f",
                             iter_num, performance, mean_hd95)

            if iter_num % cfg.ckpt_every == 0:
                self._save_model(f"iter_{iter_num}.pth")
                save_train_state(
                    os.path.join(self.snapshot_path, "latest_full.ckpt"),
                    self.state)
                logging.info("save model to %s", self.snapshot_path)

            # after the checkpoint, as the JAX trainer runs it: a checkpoint
            # of a hook iteration holds the state from before the hook
            if self.bundle.host_hook is not None:
                self.bundle.host_hook(self.bundle, self.state, iter_num)

        if self.writer is not None:
            self.writer.close()
        return "Training Finished!"
