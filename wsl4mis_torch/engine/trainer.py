"""Generic training loop (port of ``wsl4mis_tpu/engine/trainer.py``).

Keeps the reference run contract: TensorBoard tags (info/lr,
info/total_loss, info/loss_ce, info/val_*) when tensorboardX is present,
validation every ``val_every`` iterations with best-model checkpoints,
periodic checkpoints every ``ckpt_every``, log.txt + stdout logging and
the snapshot dir ``{root}/{exp}_{fold}/{sup_type}``.

A method's bundle may change validation and checkpoints as the JAX
trainer lets it (ScribbleVC does all of it): its own predictor and forward
kwargs (``predictor``, ``val_variables``), NaN-aware metrics, a
``select_predictor`` whose metric (logged under ``info/val_select_*``)
drives best-model selection in place of the main one (``cfg.light_val``
then skips the main pass), a ``{model}_{dice}_model.pth`` snapshot above
``dice_snapshot_threshold``, the ``eval_extra`` state in every inference
checkpoint. The logged LR is the optimizer's ``schedule``.

Each step runs eagerly on cfg.device with per-step generators from
(cfg.seed, iteration); metrics stay on the device until the logging
cadence reads them.

``cfg.resume`` continues from ``{snapshot}/latest_full.ckpt`` in either
package's format (``utils.checkpoint.restore_train_state``), with the
data iterator started anew, as the JAX trainer does. A JAX run continued
here takes the port's draws from the resumed step on: JAX's PRNG streams
have no torch counterpart.

Under a process group (``parallel.make_mesh``; the counterpart of the JAX
trainer's mesh) the state is replicated from rank 0, each rank runs the
same global batch stream and keeps its rows of each batch
(``parallel.shard_batch``, part by part with ``bundle.batch_parts``), and
the step equals the single-process step at the global batch. Rank 0 alone
writes the snapshot dir (code, log.txt, TensorBoard, checkpoints) and
validates; the other ranks wait at a barrier. Every rank restores the same
file on ``--resume`` and runs the host hook.
"""

from __future__ import annotations

import logging
import os
import shutil

import numpy as np

from .. import parallel
from ..data.loader import prefetch
from ..eval.val2d import VolumePredictor, evaluate_fold, nanmean
from ..utils.checkpoint import (
    restore_train_state,
    save_model_checkpoint,
    save_train_state,
)
from ..utils.device import resolve_device
from ..utils.logging_utils import Timer, setup_run_logging
from .config import TrainConfig
from .methods.common import MethodBundle, split_rngs


class Trainer:
    def __init__(self, cfg: TrainConfig, bundle: MethodBundle,
                 use_tensorboard: bool = True):
        self.cfg = cfg
        self.bundle = bundle
        self.device = resolve_device(cfg.device)
        self.snapshot_path = cfg.snapshot_path
        self.mesh = parallel.current_mesh()
        if cfg.num_devices not in (None, self.mesh.world_size):
            raise ValueError(
                f"num_devices {cfg.num_devices} but this process is rank "
                f"{self.mesh.rank} of {self.mesh.world_size}: start the "
                f"ranks with parallel.spawn (the train command does)")
        self.lead = self.mesh.rank == 0
        parallel.check_batch(self.mesh, cfg.batch_size, bundle.batch_parts)
        if self.lead:
            os.makedirs(self.snapshot_path, exist_ok=True)
            setup_run_logging(self.snapshot_path)
            self._snapshot_code()

        self.state = bundle.state
        self.image_every = 20  # train_fully_supervised_2D.py:121
        batches = bundle.data_iter
        if self.mesh.world_size > 1:
            parallel.replicate_tree(self.state.state_dict())
            batches = (parallel.shard_batch(self.mesh, b, bundle.batch_parts)
                       for b in batches)
        self.data_iter = prefetch(batches, size=4)
        self.predictor = bundle.predictor or VolumePredictor(
            bundle.model, cfg.patch_size, device=self.device)

        self.writer = None
        if use_tensorboard and self.lead:
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
                fmt = restore_train_state(ckpt, self.state)
                logging.info("resumed from %s (%s format) at step %d", ckpt,
                             fmt, self.state.step)

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

    def _evaluate(self, predictor, variables_fn):
        """(per-class metrics, mean dice, mean hd95) of one predictor."""
        bundle = self.bundle
        variables = None if variables_fn is None else variables_fn(
            self.state)
        metric_list = evaluate_fold(predictor, bundle.val_volumes,
                                    self.cfg.num_classes,
                                    nan_aware=bundle.nan_val_metrics,
                                    variables=variables)
        mean = (nanmean(metric_list) if bundle.nan_val_metrics
                else metric_list.mean(axis=0))
        return metric_list, float(mean[0]), float(mean[1])

    def validate(self, iter_num: int) -> tuple[float, float]:
        """Mean (dice, hd95) over the val volumes, the one that drives
        best-model selection: the select predictor's where the bundle has
        one, else the main predictor's (logged with per-class tags)."""
        bundle = self.bundle
        select = bundle.select_predictor
        if not (self.cfg.light_val and select is not None):
            metric_list, performance, mean_hd95 = self._evaluate(
                self.predictor, bundle.val_variables)
            for class_i in range(self.cfg.num_classes - 1):
                self._scalar(f"info/val_{class_i + 1}_dice",
                             metric_list[class_i, 0], iter_num)
                self._scalar(f"info/val_{class_i + 1}_hd95",
                             metric_list[class_i, 1], iter_num)
            self._scalar("info/val_mean_dice", performance, iter_num)
            self._scalar("info/val_mean_hd95", mean_hd95, iter_num)
            if select is None:
                return performance, mean_hd95
            logging.info("iteration %d : val(train-rule) dice %f", iter_num,
                         performance)
        _, performance, mean_hd95 = self._evaluate(
            select, bundle.val_variables)
        self._scalar("info/val_select_mean_dice", performance, iter_num)
        self._scalar("info/val_select_mean_hd95", mean_hd95, iter_num)
        logging.info("iteration %d : val(select-rule) dice %f", iter_num,
                     performance)
        return performance, mean_hd95

    def _save_model(self, name: str):
        save_model_checkpoint(os.path.join(self.snapshot_path, name),
                              self.state, eval_extra=self.bundle.eval_extra)

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

            if iter_num % cfg.log_every == 0 and self.lead:
                host = {k: float(v) for k, v in metrics.items() if k != "vis"}
                lr = self.state.opt.schedule(iter_num)
                self._scalar("info/lr", lr, iter_num)
                for k, v in host.items():
                    self._scalar(f"info/{k}", v, iter_num)
                logging.info(
                    "iteration %d : %s : %.1f ms/it", iter_num,
                    " ".join(f"{k}: {v:f}" for k, v in host.items()),
                    1e3 * timer.tick() / cfg.log_every,
                )

            if iter_num > 0 and iter_num % cfg.val_every == 0 and self.lead:
                performance, mean_hd95 = self.validate(iter_num)
                thresh = self.bundle.dice_snapshot_threshold
                if thresh is not None and performance > thresh:
                    self._save_model(
                        f"{cfg.model}_{str(performance)[0:6]}_model.pth")
                if performance > best_performance:
                    best_performance = performance
                    self._save_model(f"iter_{iter_num}_dice_"
                                     f"{round(best_performance, 4)}.pth")
                    self._save_model(f"{cfg.model}_best_model.pth")
                logging.info("iteration %d : mean_dice : %f mean_hd95 : %f",
                             iter_num, performance, mean_hd95)

            if iter_num % cfg.ckpt_every == 0 and self.lead:
                self._save_model(f"iter_{iter_num}.pth")
                save_train_state(
                    os.path.join(self.snapshot_path, "latest_full.ckpt"),
                    self.state)
                logging.info("save model to %s", self.snapshot_path)
            if iter_num % cfg.val_every == 0 or iter_num % cfg.ckpt_every == 0:
                parallel.barrier()  # the other ranks wait for rank 0

            # after the checkpoint, as the JAX trainer runs it: a checkpoint
            # of a hook iteration holds the state from before the hook
            if self.bundle.host_hook is not None:
                self.bundle.host_hook(self.bundle, self.state, iter_num)

        if self.writer is not None:
            self.writer.close()
        return "Training Finished!"
