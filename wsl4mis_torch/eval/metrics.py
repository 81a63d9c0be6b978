"""Binary segmentation metrics, medpy-parity on scipy (the port's copy of
``wsl4mis_tpu/eval/metrics.py``: Dice, HD95 and ASD, the per-case
metrics of validation and of the offline test at voxel spacing, and
ScribbleVC's NaN-aware per-case metric).

Surface voxels are mask ^ binary_erosion(mask) with a connectivity-1
structuring element; distances are the EDT of the complement of the other
surface sampled at the border voxels. A class with an empty prediction or
ground truth scores (0, 0), as the reference validation does ((0, 0, 0)
in the offline test).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dice_coefficient(result: np.ndarray, reference: np.ndarray) -> float:
    result = result.astype(bool)
    reference = reference.astype(bool)
    size_sum = np.count_nonzero(result) + np.count_nonzero(reference)
    if size_sum == 0:
        return 0.0
    return 2.0 * np.count_nonzero(result & reference) / size_sum


def _border(mask: np.ndarray) -> np.ndarray:
    footprint = ndimage.generate_binary_structure(mask.ndim, 1)
    return mask & ~ndimage.binary_erosion(mask, structure=footprint,
                                          iterations=1)


def _crop_to_union(result: np.ndarray, reference: np.ndarray):
    """Crop both masks to the union bounding box plus a 1-voxel margin:
    border voxels and the EDT values at them are unchanged."""
    union = result | reference
    slices = ndimage.find_objects(union.astype(np.int8), max_label=1)[0]
    if slices is None:
        return result, reference
    padded = tuple(
        slice(max(s.start - 1, 0), min(s.stop + 1, dim))
        for s, dim in zip(slices, result.shape)
    )
    return result[padded], reference[padded]


def surface_distances(result, reference, voxelspacing=None) -> np.ndarray:
    result = np.atleast_1d(result.astype(bool))
    reference = np.atleast_1d(reference.astype(bool))
    result, reference = _crop_to_union(result, reference)
    if voxelspacing is not None:
        voxelspacing = np.atleast_1d(np.asarray(voxelspacing, np.float64))
        if voxelspacing.size == 1:
            voxelspacing = np.repeat(voxelspacing, result.ndim)
    if not result.any():
        raise RuntimeError("result is empty: no surface to measure")
    if not reference.any():
        raise RuntimeError("reference is empty: no surface to measure")
    dt = ndimage.distance_transform_edt(~_border(reference),
                                        sampling=voxelspacing)
    return dt[_border(result)]


def hd95(result, reference, voxelspacing=None) -> float:
    d1 = surface_distances(result, reference, voxelspacing)
    d2 = surface_distances(reference, result, voxelspacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def asd(result, reference, voxelspacing=None) -> float:
    """Mean distance from the result's surface to the reference's (one
    direction, as medpy's asd)."""
    return float(surface_distances(result, reference, voxelspacing).mean())


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray):
    """(dice, hd95), (0, 0) when the prediction or the label is empty."""
    pred = pred > 0
    gt = gt > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_coefficient(pred, gt), hd95(pred, gt)
    return 0.0, 0.0


def calculate_metric_percase_nan(pred: np.ndarray, gt: np.ndarray):
    """(dice, hd95) with ScribbleVC's NaN conventions
    (val_2D_scribblevc.py:15-28): a class absent from both scores (nan,
    nan), so a NaN-mean skips it; absent from gt but predicted (0, 0);
    present but not predicted (dice, nan)."""
    pred = pred > 0
    gt = gt > 0
    if gt.sum() == 0 and pred.sum() == 0:
        return np.nan, np.nan
    if gt.sum() == 0:
        return 0.0, 0.0
    dice = dice_coefficient(pred, gt)
    if pred.sum() == 0:
        return dice, np.nan
    return dice, hd95(pred, gt)


def calculate_metric_percase_spacing(pred, gt, spacing):
    """(dice, hd95, asd) at voxel spacing (the offline test's metric,
    test_2D_fully.py:74-80); (0, 0, 0) when the prediction or the label is
    empty."""
    pred = pred > 0
    gt = gt > 0
    if pred.sum() == 0 or gt.sum() == 0:
        return 0.0, 0.0, 0.0
    return (dice_coefficient(pred, gt), hd95(pred, gt, spacing),
            asd(pred, gt, spacing))
