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

``cfg.steps_per_call`` K > 1 runs K steps a call, as the JAX trainer's
K-step device call does: the validation, checkpoint, log and image
cadences are rounded to multiples of K (``_round``, with the JAX
trainer's warning where K does not divide val_every), 4·K batches are
prefetched, and each call returns its K-th step's metrics; the host hook
runs after each call. On the card a call replays the step captured in a
CUDA graph K times (``engine.graph.CapturedStep``; every method, one
graph for each value of its ``MethodBundle.variant``), unless a process
group runs: then, as on the CPU, the K steps run eagerly. The Trainer
logs once which way it went and why, and each variant's capture as it
happens. Every step keeps its
(cfg.seed, step) draws, so a K-step run is bit-equal to the K = 1 run.
``cfg.profile_steps`` N > 0 writes a torch.profiler trace (Chrome JSON) of
the steps from iteration 10 to 10 + N into ``{snapshot}/profile``, opened
and closed where the JAX trainer's would be (at a call's boundary).

``cfg.resume`` continues from ``{snapshot}/latest_full.ckpt`` in either
package's format (``utils.checkpoint.restore_train_state``), with the
data iterator started anew, as the JAX trainer does. A JAX run continued
here takes the port's draws from the resumed step on: JAX's PRNG streams
have no torch counterpart.

``cfg.debug_nans`` checks every step for a NaN and raises
FloatingPointError where one first appears (``engine.debug_nans.NanCheck``:
one reduction and one sync a step, and a copy of the state before it); a
K-step call then runs its steps eagerly, and the Trainer logs why.

Under a process group (``parallel.make_mesh``; the counterpart of the JAX
trainer's mesh) the state is replicated from rank 0, each rank runs the
same global batch stream and keeps its rows of each batch
(``parallel.shard_batch``, part by part with ``bundle.batch_parts``; of a
stream of host batches, ``DeviceBatches``, on the host before the copy, as
the JAX trainer shards host arrays), and the step equals the
single-process step at the global batch. Rank 0 alone
writes the snapshot dir (code, log.txt, TensorBoard, checkpoints) and
validates; the other ranks wait at a barrier. Every rank restores the same
file on ``--resume`` and runs the host hook.
"""

from __future__ import annotations

import logging
import os
import shutil

import numpy as np
import torch

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
from .debug_nans import NanCheck
from .graph import CapturedStep
from .methods.common import DeviceBatches, MethodBundle, split_rngs


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
        self.multi = max(1, cfg.steps_per_call)

        def _round(v):
            return max(self.multi, (v // self.multi) * self.multi)

        if self.multi > 1 and cfg.val_every % self.multi:
            logging.warning(
                "steps_per_call %d does not divide val_every %d: validation/"
                "checkpoint cadence quantizes to every %d iterations (the "
                "reference contract is every %d, "
                "train_fully_supervised_2D.py:132)",
                self.multi, cfg.val_every, _round(cfg.val_every),
                cfg.val_every)
        self.val_every = _round(cfg.val_every)
        self.ckpt_every = _round(cfg.ckpt_every)
        self.log_every = _round(cfg.log_every)
        self.image_every = _round(20)  # train_fully_supervised_2D.py:121
        batches = bundle.data_iter
        if self.mesh.world_size > 1:
            parallel.replicate_tree(self.state.state_dict())

            def shard(b):
                return parallel.shard_batch(self.mesh, b, bundle.batch_parts)

            batches = (batches.map_host(shard)
                       if isinstance(batches, DeviceBatches)
                       else map(shard, batches))
        self.data_iter = prefetch(batches, size=4 * self.multi)
        self.nan_check = (NanCheck(bundle.step_fn, cfg.seed, self.device)
                          if cfg.debug_nans else None)
        self.captured, self.uncaptured = None, None
        if self.multi > 1:
            self.uncaptured = self._uncaptured_reason()
            if self.uncaptured is None:
                self.captured = CapturedStep(bundle.step_fn, self.state,
                                             bundle.aux, cfg.seed,
                                             bundle.variant)
                logging.info("steps_per_call %d: a call replays the step "
                             "captured in a CUDA graph %d times%s",
                             self.multi, self.multi,
                             "" if bundle.variant is None else
                             " (a graph for each variant of the step)")
            else:
                logging.info("steps_per_call %d: the steps of a call run "
                             "uncaptured: %s", self.multi, self.uncaptured)
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

    def _uncaptured_reason(self) -> str | None:
        """Why the K steps of a call cannot replay a captured step, or
        None."""
        if self.device.type != "cuda":
            return f"{self.device.type} has no CUDA graph"
        if self.mesh.world_size > 1:
            return ("a process group's collectives run in the step, each a "
                    "host round trip")
        if self.cfg.debug_nans:
            return ("debug_nans checks each step's outputs on the host and "
                    "runs a step that made a NaN again, eagerly")
        return None

    def _call(self, batches, iter_num: int) -> dict:
        """One step a batch of `batches` from iteration `iter_num` on; the
        last step's metrics."""
        if self.captured is not None:
            return self.captured(batches)
        for k, batch in enumerate(batches):
            if self.nan_check is not None:
                metrics = self.nan_check(self.state, batch, self.bundle.aux,
                                         iter_num + k)
            else:
                rngs = split_rngs(self.cfg.seed, iter_num + k, self.device)
                metrics = self.bundle.step_fn(self.state, batch, rngs,
                                              self.bundle.aux)
        return metrics

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        profile_dir = os.path.join(self.snapshot_path, "profile")
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        logging.info("profiler trace written to %s", path)

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
        profiling = cfg.profile_steps > 0 and self.lead
        prof = None

        while iter_num < cfg.max_iterations:
            batches = [next(self.data_iter) for _ in range(self.multi)]
            if profiling and iter_num == 10:
                prof = self._start_profile()
            metrics = self._call(batches, iter_num)
            iter_num += self.multi
            if prof is not None and iter_num == 10 + cfg.profile_steps:
                self._stop_profile(prof)
                prof = None

            if iter_num % self.image_every == 0:
                self._images(metrics.get("vis"), iter_num)

            if iter_num % self.log_every == 0 and self.lead:
                host = {k: float(v) for k, v in metrics.items() if k != "vis"}
                lr = self.state.opt.schedule(iter_num)
                self._scalar("info/lr", lr, iter_num)
                for k, v in host.items():
                    self._scalar(f"info/{k}", v, iter_num)
                logging.info(
                    "iteration %d : %s : %.1f ms/it", iter_num,
                    " ".join(f"{k}: {v:f}" for k, v in host.items()),
                    1e3 * timer.tick() / self.log_every,
                )

            if iter_num > 0 and iter_num % self.val_every == 0 and self.lead:
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

            if iter_num % self.ckpt_every == 0 and self.lead:
                self._save_model(f"iter_{iter_num}.pth")
                save_train_state(
                    os.path.join(self.snapshot_path, "latest_full.ckpt"),
                    self.state)
                logging.info("save model to %s", self.snapshot_path)
            if iter_num % self.val_every == 0 \
                    or iter_num % self.ckpt_every == 0:
                parallel.barrier()  # the other ranks wait for rank 0

            # after the checkpoint, as the JAX trainer runs it: a checkpoint
            # of a hook iteration holds the state from before the hook
            if self.bundle.host_hook is not None:
                self.bundle.host_hook(self.bundle, self.state, iter_num)

        if prof is not None:  # the run ended inside the window
            logging.warning("profile window open at the end (iteration %d "
                            "of 10 + %d)", iter_num, cfg.profile_steps)
            self._stop_profile(prof)
        if self.writer is not None:
            self.writer.close()
        return "Training Finished!"
