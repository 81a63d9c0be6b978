"""Metrics, batched volume validation and the offline test of the port."""

from .infer import InferenceConfig, inference_fold, run_inference, score_volumes
from .metrics import (
    asd,
    calculate_metric_percase,
    calculate_metric_percase_nan,
    calculate_metric_percase_spacing,
    dice_coefficient,
    hd95,
    surface_distances,
)
from .val2d import (
    VolumePredictor,
    evaluate_fold,
    test_single_volume,
)

__all__ = ["InferenceConfig", "VolumePredictor", "asd",
           "calculate_metric_percase", "calculate_metric_percase_nan",
           "calculate_metric_percase_spacing", "dice_coefficient",
           "evaluate_fold", "hd95", "inference_fold", "run_inference",
           "score_volumes", "surface_distances", "test_single_volume"]
