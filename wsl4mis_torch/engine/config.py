"""Shared training configuration (port of
``wsl4mis_tpu/engine/config.py``). Field names keep the reference CLI flag
names. The TPU runtime knobs (steps_per_call, fast_prng, remat,
num_devices, profile_steps) are not ported; ``device`` is new."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class TrainConfig:
    # reference CLI flags (train_fully_supervised_2D.py:29-53)
    root_path: str | None = None        # None -> data.default_acdc_root()
    exp: str = "ACDC"
    fold: str = "fold1"
    sup_type: str = "label"
    model: str = "unet"
    num_classes: int = 4
    max_iterations: int = 30000
    batch_size: int = 16
    base_lr: float = 0.03
    patch_size: tuple[int, int] = (256, 256)
    seed: int = 2022

    # semi-supervised flags (train_mean_teacher_2D.py:50-69); consistency
    # and its sigmoid ramp also weigh pce_intensity_variance's term
    labeled_bs: int = 8
    ema_decay: float = 0.99
    consistency: float = 0.1
    consistency_rampup: float = 200.0

    # scribble2label flags (train_s2l.py:50-66)
    thr_iter: int = 6000
    thr_conf: float = 0.8
    period_iter: int = 100
    alpha: float = 0.2

    # run knobs
    method: str = "fully_supervised"
    snapshot_root: str = "model"
    val_every: int = 200
    ckpt_every: int = 3000
    log_every: int = 1
    compute_dtype: str = "bfloat16"     # bfloat16 | float32
    resume: bool = False
    data_limit: int | None = None       # cap the dataset size (smoke runs)
    aug_mode: str = "device"            # "device": augment inside the step;
                                        # "host": batches arrive augmented
    device: str = "cuda"                # "cuda" or "cpu"; cuda never falls
                                        # back to the CPU

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def snapshot_path(self) -> str:
        return f"{self.snapshot_root}/{self.exp}_{self.fold}/{self.sup_type}"
