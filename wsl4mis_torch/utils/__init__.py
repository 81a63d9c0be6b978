"""Device, parameter bridge, checkpoints, segmentation utilities and
logging helpers."""

from .checkpoint import (
    load_checkpoint,
    restore_jax_train_state,
    restore_train_state,
    save_checkpoint,
    save_jax_train_state,
    save_model_checkpoint,
    save_train_state,
)
from .device import resolve_device
from .logging_utils import AverageMeter, Timer, setup_run_logging
from .seg_utils import (
    compute_sdf,
    cross_entropy2d,
    decode_segmap,
    get_mc_dice,
    post_processing,
)

__all__ = [
    "AverageMeter",
    "Timer",
    "compute_sdf",
    "cross_entropy2d",
    "decode_segmap",
    "get_mc_dice",
    "load_checkpoint",
    "post_processing",
    "resolve_device",
    "restore_jax_train_state",
    "restore_train_state",
    "save_checkpoint",
    "save_jax_train_state",
    "save_model_checkpoint",
    "save_train_state",
    "setup_run_logging",
]
