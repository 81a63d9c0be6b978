"""ACDC preprocessing: raw NIfTI -> per-slice / per-volume HDF5 (the
port's copy of ``wsl4mis_tpu/data/preprocess.py``; host numpy).

Parity with the reference's code/dataloaders/acdc_data_processing.py:
  * images clipped at the 99th-percentile of the cumulative intensity
    distribution (MedicalImageDeal.valid_img, :15-20), then min-max
    normalized to [0, 1] (:45);
  * per-slice H5 files `{case}_slice_{i}.h5` with gzip'ed `image` (f32),
    `label`, `scribble` keys (:52-60) and per-volume `{case}.h5` (:108-114).

Uses the built-in NIfTI reader (data/nifti.py) instead of SimpleITK.
``h5py`` is imported by ``convert_acdc`` alone, which raises ImportError
without it.

    python -c "from wsl4mis_torch.data import convert_acdc; \
        print(convert_acdc('RAW_DIR', 'OUT_DIR'))"
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .nifti import read_nifti


def percentile_clip(img: np.ndarray, percent: float = 0.99) -> np.ndarray:
    """Clip at the first intensity whose CDF >= percent.

    Equivalent to skimage.exposure.cumulative_distribution over the exact
    value histogram (acdc_data_processing.py:15-20).
    """
    values, counts = np.unique(img, return_counts=True)
    cdf = np.cumsum(counts) / img.size
    watershed = values[cdf >= percent][0]
    return np.clip(img, img.min(), watershed)


def normalize(img: np.ndarray) -> np.ndarray:
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def process_case(image_path: str, label_path: str, scribble_path: str):
    image = read_nifti(image_path).array_zyx
    label = read_nifti(label_path).array_zyx
    scribble = read_nifti(scribble_path).array_zyx
    if image.shape != label.shape:
        raise ValueError(f"shape mismatch for {image_path}")
    image = normalize(percentile_clip(image, 0.99))
    return image, label.astype(np.uint8), scribble.astype(np.uint16)


def convert_acdc(raw_dir: str, out_dir: str, limit: int | None = None) -> int:
    """Convert `{case}_gt.nii.gz`-keyed raw ACDC data into the H5 layout
    the datasets consume. Returns the number of slices written."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("convert_acdc writes H5 files and needs h5py, "
                          "which is not installed") from e

    slices_dir = os.path.join(out_dir, "ACDC_training_slices")
    volumes_dir = os.path.join(out_dir, "ACDC_training_volumes")
    os.makedirs(slices_dir, exist_ok=True)
    os.makedirs(volumes_dir, exist_ok=True)
    cases = sorted(glob.glob(os.path.join(raw_dir, "*_gt.nii.gz")))
    if limit:
        cases = cases[:limit]
    slice_num = 0
    for gt_path in cases:
        image_path = gt_path.replace("_gt", "")
        scribble_path = gt_path.replace("_gt", "_scribble")
        item = os.path.basename(gt_path).split(".")[0].replace("_gt", "")
        image, label, scribble = process_case(
            image_path, gt_path, scribble_path
        )
        for ind in range(image.shape[0]):
            with h5py.File(
                os.path.join(slices_dir, f"{item}_slice_{ind}.h5"), "w"
            ) as f:
                f.create_dataset("image", data=image[ind], compression="gzip")
                f.create_dataset("label", data=label[ind], compression="gzip")
                f.create_dataset(
                    "scribble", data=scribble[ind], compression="gzip"
                )
            slice_num += 1
        with h5py.File(os.path.join(volumes_dir, f"{item}.h5"), "w") as f:
            f.create_dataset("image", data=image, compression="gzip")
            f.create_dataset("label", data=label, compression="gzip")
            f.create_dataset("scribble", data=scribble, compression="gzip")
    return slice_num
