"""Training cells: the train command's ``Trainer.train()`` on phantom
slices, captured K-step calls, as users run it.

A run:

1. set-up: the traffic's datasets (phantoms from the seed, made on the
   device, scribbled where the traffic says so, handed to the program as
   its in-memory datasets), the method's bundle as the program's build
   makes it from them (``program_bundle``) and the ``Trainer`` as the
   train command builds it (validation and checkpoints beyond the window,
   logging at its default), the benchmark's weights loaded into the
   model;
2. the first steps, through the Trainer's own call and feed (one batch a
   call): step 0's loss and gradient and the first three steps' losses
   and change are kept for the comparison, and the batches the Trainer
   took; then steps up to a multiple of K, so that the window's calls
   line up with the Trainer's cadences;
3. a calibration segment, from which the window's step count is set so
   that it lasts about --seconds;
4. the window: ``Trainer.train()`` over those steps, between two
   synchronizes; ``train_slices_per_s`` = steps x batch / its wall time,
   ``setup_s`` = process start to its start; with --trace 1 the
   harness's span around each batch the Trainer takes;
5. with --trace 1, a traced segment of ``traced_steps``;
6. the peak memory is read, the program freed, and the reference follows
   the first three steps from the same weights, batches and draws, with
   the method's loss and optimizer.

What a configuration, a method or an optimizer contributes is found by
name (``harness/spec``): the model's work from the configuration's
module through the method's ``work``, the first gradient from the
optimizer's file. Nothing here reads a configuration's sizes but its
``patch_size``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import check, inputs, trace as tr, work
from .common import (Result, free, load_weights, marker, peak_bytes,
                     reset_peak, sync)

BEYOND = 10 ** 9  # validation and checkpoint cadences past any window
FOLLOWED = 3  # steps the reference follows
CALIBRATION_STEPS = 48


class Feed:
    """The Trainer's feed, passed through: the first `keep` batches it
    gives are kept (the reference follows them), and while ``timing`` is
    on, the harness's span around each ``next`` (host seconds waited)."""

    def __init__(self, it, keep: int):
        self.it, self.keep = it, keep
        self.kept, self.waits, self.timing = [], [], False

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.it)
        if self.timing:
            self.waits.append(time.perf_counter() - t0)
        if len(self.kept) < self.keep:
            self.kept.append(batch)
        return batch


def program_bundle(cfg, datasets: list, model_name: str):
    """The method's bundle as its build makes it from loaded data: the
    method's ``make_bundle(cfg, *datasets, val)`` where it has one (its
    variant, batch parts, host hook and predictor with it), else the
    parts its build puts together (model, step, the train command's batch
    stream, the slices staged on the device)."""
    from wsl4mis_torch.engine.methods import get_method
    from wsl4mis_torch.engine.methods.common import (
        MethodBundle, make_model_and_state, stage_dataset, train_batches)

    mod = get_method(cfg.method)
    if hasattr(mod, "make_bundle"):
        return mod.make_bundle(cfg, *datasets, [])
    train, = datasets
    model, state = make_model_and_state(cfg, model_name=model_name)
    return MethodBundle(
        model=model, state=state, step_fn=mod.make_step(cfg),
        data_iter=train_batches(cfg, train), val_volumes=[],
        steps_per_epoch=len(train) // cfg.batch_size,
        aux=stage_dataset(cfg, train))


class Setup:
    def __init__(self, cell, seed, device, snapshot_root, mark=None):
        from wsl4mis_torch.data.synthetic import ArraySliceDataset
        from wsl4mis_torch.engine.config import TrainConfig
        from wsl4mis_torch.engine.trainer import Trainer

        mark = mark or (lambda name: None)
        mark("program imported")
        t, c = cell.traffic, cell.config
        self.cell, self.seed, self.device = cell, seed, device
        h, w = c["patch_size"]
        # made on the device, handed over as the host arrays the program's
        # datasets hold; the reference gathers its batches from them too
        self.data = [{k: v.to(torch.float32 if k == "images"
                              else torch.int32).cpu().numpy()
                      for k, v in inputs.slices(seed, i, d, h, w,
                                                device).items()
                      if v is not None}
                     for i, d in enumerate(t["datasets"])]
        self.reference = cell.reference_model()
        self.method = cell.reference_method()
        self.optimizer = cell.optimizer()
        self.leaves = self.reference.leaves(c)
        self.weights = inputs.weights(self.leaves, seed, device)
        mark("inputs and weights")
        reset_peak(device)
        self.cfg = TrainConfig(
            method=t["method"], model=c["model"], sup_type=t["sup_type"],
            num_classes=c["class_num"], batch_size=t["batch"],
            base_lr=t["base_lr"], max_iterations=t["schedule_iterations"],
            patch_size=tuple(c["patch_size"]), seed=seed,
            steps_per_call=t["steps_per_call"],
            compute_dtype=t["compute_dtype"], val_every=BEYOND,
            ckpt_every=BEYOND, log_every=t["log_every"],
            snapshot_root=snapshot_root, device=device,
            device_data=t["device_data"])
        datasets = [ArraySliceDataset(d["images"], d["labels"],
                                      dense_labels=d.get("dense"))
                    for d in self.data]
        bundle = program_bundle(self.cfg, datasets, c["model"])
        load_weights(bundle.model, self.weights)
        self.trainer = Trainer(self.cfg, bundle, use_tensorboard=False)
        self.feed = self.trainer.data_iter = Feed(self.trainer.data_iter,
                                                  FOLLOWED)

    def first_steps(self, n: int = FOLLOWED) -> dict:
        """n steps, one batch a call through the Trainer's call and feed
        (and its host hook); then steps to a multiple of K. Returns the
        program's side of the comparison."""
        trainer = self.trainer
        bundle, state = trainer.bundle, trainer.state
        names = [k for k, _ in state.model.named_parameters()]

        def step():
            m = trainer._call([next(trainer.data_iter)], state.step)
            if bundle.host_hook is not None:
                bundle.host_hook(bundle, state, state.step)
            return m

        losses, grad = [], None
        for t in range(n):
            losses.append(step()["total_loss"])
            if t == 0:
                grad = self.optimizer.program_grad(state, names)
        change = {k: v.detach().float() - self.weights[k]
                  for k, v in state.model.state_dict().items()}
        while state.step % trainer.multi:
            step()
        return {"loss": [float(x) for x in losses], "grad": grad,
                "change": change}

    def take_batches(self, n: int = FOLLOWED) -> None:
        """Take the first n batches from the Trainer's feed without
        stepping (a control follows them in the program's place)."""
        for _ in range(n):
            next(self.trainer.data_iter)

    def steps(self, n: int) -> float:
        """Wall seconds of Trainer.train() over n more steps, between
        synchronizes."""
        trainer = self.trainer
        trainer.cfg = trainer.cfg.replace(
            max_iterations=trainer.state.step + n)
        sync(self.device)
        t0 = time.perf_counter()
        trainer.train()
        sync(self.device)
        return time.perf_counter() - t0

    def capture_s(self):
        cap = self.trainer.captured
        return None if cap is None else sum(cap.capture_s.values())

    def finite(self) -> bool:
        return all(bool(torch.isfinite(p).all())
                   for p in self.trainer.state.model.parameters())

    def release(self) -> None:
        """Drop the program's objects (the feed's thread stays blocked on
        its full queue, a daemon)."""
        self.trainer = None
        free(self.device)

    def batches(self) -> list:
        """The slices of the batches the Trainer took first, from the
        benchmark's own arrays (indices into the datasets stacked in
        order), or the slices the batch brought."""
        def stacked(key):
            parts = [d[key] for d in self.data]
            return parts[0] if len(parts) == 1 else np.concatenate(parts)

        images, labels = stacked("images"), stacked("labels")
        out = []
        for b in self.feed.kept:
            if "index" in b:
                idx = np.asarray(b["index"], dtype=np.int64)
                out.append((torch.from_numpy(images[idx]).to(self.device),
                            torch.from_numpy(labels[idx]).to(self.device)))
            else:
                out.append((b["image"].to(self.device, torch.float32),
                            b["label"].to(self.device)))
        return out

    def follow(self, precision: str = "float32") -> dict:
        from reference.layers import Precision
        from reference.train import follow

        return follow(self.reference, self.method, self.optimizer,
                      self.cell.config, self.cell.traffic, self.weights,
                      self.leaves, self.batches(), self.seed, self.device,
                      Precision(precision))


def window_steps(per_step_s: float, seconds: float, k: int) -> int:
    return max(k, int(round(seconds / per_step_s / k)) * k)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device, snapshot_root: str, marks: list) -> Result:
    t, c = cell.traffic, cell.config
    mark = marker(marks, t_start)
    s = Setup(cell, seed, device, snapshot_root, mark)
    mark("program objects")
    prog = s.first_steps()
    mark("first steps and capture")
    k = s.trainer.multi
    per_step = s.steps(CALIBRATION_STEPS) / CALIBRATION_STEPS
    mark("calibration")
    n = window_steps(per_step, seconds, k)
    s.feed.timing = trace
    setup_s = time.time() - t_start
    window_s = s.steps(n)
    s.feed.timing = False
    peak = peak_bytes(device)
    traced = None
    if trace:
        traced = tr.traced(lambda: s.steps(2 * k),
                           lambda: s.steps(t["traced_steps"]), device)
    finite = s.finite()
    capture_s = s.capture_s()
    s.release()

    numbers = check.training_numbers(prog, s.follow())
    ok, rows = check.verdict(numbers, cell.limits)
    dtype, batch = t["compute_dtype"], t["batch"]
    flops, launches = s.method.work(s.reference, c, batch, dtype)
    context = {
        "window_s": window_s, "units": n, "work": flops,
        "peak_flops": work.PEAK_FLOPS[dtype],
        "conv_bound_s": work.launches_bound_s(launches, dtype),
        "trace": traced, "traced_units": t["traced_steps"],
        "capture_s": capture_s, "data_wait_s": s.feed.waits or None,
        "setup_marks": marks,
    }
    return Result(
        correct=ok and finite, attempted=n, failed=0 if finite else n,
        end_to_end={"train_slices_per_s": n * batch / window_s,
                    "setup_s": setup_s},
        context=context, memory_peak_bytes=peak, checks=rows,
        numbers=numbers, trace=traced)


def snapshot_root(root: str, cell) -> str:
    return os.path.join(root, "build", "benchmark", "runs", cell.name)
