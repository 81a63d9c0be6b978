"""Datasets, batch iteration and on-device augmentation of the port."""

from .acdc import (
    AcdcSliceDataset,
    AcdcVolumeDataset,
    default_acdc_root,
    fold_ids,
    labeled_patient_ids,
)
from .augment_device import augment_batch, augment_batch_s2l, sample_policy
from .loader import batch_iterator, paired_iterator, prefetch
from .synthetic import ArraySliceDataset, synthetic_slices, synthetic_volumes

__all__ = [
    "AcdcSliceDataset",
    "AcdcVolumeDataset",
    "ArraySliceDataset",
    "augment_batch",
    "augment_batch_s2l",
    "batch_iterator",
    "default_acdc_root",
    "fold_ids",
    "labeled_patient_ids",
    "paired_iterator",
    "prefetch",
    "sample_policy",
    "synthetic_slices",
    "synthetic_volumes",
]
