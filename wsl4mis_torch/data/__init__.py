"""Datasets, batch iteration, host and on-device augmentation, and NIfTI
files of the port."""

from .acdc import (
    AcdcSliceDataset,
    AcdcVolumeDataset,
    default_acdc_root,
    fold_ids,
    labeled_patient_ids,
)
from .augment import HostRandomGenerator
from .augment_device import augment_batch, augment_batch_s2l, sample_policy
from .loader import batch_iterator, paired_iterator, prefetch
from .nifti import NiftiImage, read_nifti, read_spacing, write_nifti
from .synthetic import (
    ArraySliceDataset,
    synthetic_slices,
    synthetic_volumes,
    zoomed_with_native,
)

__all__ = [
    "AcdcSliceDataset",
    "AcdcVolumeDataset",
    "ArraySliceDataset",
    "HostRandomGenerator",
    "NiftiImage",
    "augment_batch",
    "augment_batch_s2l",
    "batch_iterator",
    "default_acdc_root",
    "fold_ids",
    "labeled_patient_ids",
    "paired_iterator",
    "prefetch",
    "read_nifti",
    "read_spacing",
    "sample_policy",
    "synthetic_slices",
    "synthetic_volumes",
    "write_nifti",
    "zoomed_with_native",
]
