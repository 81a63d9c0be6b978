"""Shared training configuration (port of
``wsl4mis_tpu/engine/config.py``). Field names keep the reference CLI flag
names. ``device`` is new. ``num_devices`` is the data-parallel width: one
process a card (``parallel``).

``steps_per_call`` runs K steps a Trainer call, as the JAX trainer's
K-step device call does (cadences rounded to multiples of K); on the card
a call replays the step captured in a CUDA graph K times, where the method
can be captured (the Trainer's docstring says when). One difference from
JAX: JAX splits one key into the K steps' keys, so its K > 1 run draws
otherwise than its K = 1 run; here every step keeps its own (seed, step)
draws (``split_rngs``), so a K-step run is bit-equal to the K = 1 run on
the same device, and a resumed run still draws what an uninterrupted one
would. ``profile_steps`` writes a torch.profiler trace of the steps from
iteration 10 to 10 + N. ``remat`` checkpoints ScribbleVC's Conformer
stages (less memory for one more forward of them, the same results).
``device_data`` False ships each step's slices from the host (copied from
pinned memory in the Trainer's prefetch thread) in place of index batches
into a stack staged on the device; the augmentation still runs on the
device, and the steps are the same. ``debug_nans`` is the counterpart of
``jax_debug_nans``: each step's outputs are checked for NaN, and a step
that made one is run again to find the first module or backward node that
produced it, then the run raises FloatingPointError
(``engine.debug_nans``). Not ported: the TPU-only fast_prng (a JAX PRNG
stream)."""

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
    steps_per_call: int = 1             # K train steps a Trainer call (on
                                        # the card a captured CUDA graph
                                        # replayed K times; cadences
                                        # rounded to multiples of K)
    compute_dtype: str = "bfloat16"     # bfloat16 | float32
    remat: bool = False                 # checkpoint ScribbleVC's Conformer
                                        # stages: recompute them in the
                                        # backward instead of keeping them
    resume: bool = False
    profile_steps: int = 0              # >0: a torch.profiler trace of
                                        # iterations 10 .. 10 + N
    data_limit: int | None = None       # cap the dataset size (smoke runs)
    light_val: bool = False             # skip the train-rule validation
                                        # pass when the method has a
                                        # select_predictor (selection
                                        # never reads it)
    encoder_weights: str | None = None  # efficient_unet: a converted
                                        # encoder file (convert_torch_weights)
    aug_mode: str = "device"            # "device": augment inside the step;
                                        # "host": batches arrive augmented
    device_data: bool = True            # stage the slices on the device
                                        # (index batches); False: ship
                                        # each batch's slices from the host
    debug_nans: bool = False            # check every step for NaN and
                                        # raise FloatingPointError naming
                                        # where it first appeared
    device: str = "cuda"                # "cuda" or "cpu"; cuda never falls
                                        # back to the CPU
    num_devices: int | None = None      # processes of a data-parallel run,
                                        # one a card (gloo ones on the
                                        # CPU); None: every visible card.
                                        # The Trainer raises where it
                                        # differs from the process group's

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def snapshot_path(self) -> str:
        return f"{self.snapshot_root}/{self.exp}_{self.fold}/{self.sup_type}"
