"""Metrics and batched volume validation of the port."""

from .metrics import (
    calculate_metric_percase,
    calculate_metric_percase_nan,
    dice_coefficient,
    hd95,
)
from .val2d import VolumePredictor, evaluate_fold

__all__ = ["VolumePredictor", "calculate_metric_percase",
           "calculate_metric_percase_nan", "dice_coefficient",
           "evaluate_fold", "hd95"]
