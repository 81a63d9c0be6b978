"""Datasets, batch iteration and on-device augmentation of the port."""

from .acdc import (
    AcdcSliceDataset,
    AcdcVolumeDataset,
    default_acdc_root,
    fold_ids,
)
from .augment_device import augment_batch, sample_policy
from .loader import batch_iterator, prefetch
from .synthetic import ArraySliceDataset, synthetic_slices, synthetic_volumes

__all__ = [
    "AcdcSliceDataset",
    "AcdcVolumeDataset",
    "ArraySliceDataset",
    "augment_batch",
    "batch_iterator",
    "default_acdc_root",
    "fold_ids",
    "prefetch",
    "sample_policy",
    "synthetic_slices",
    "synthetic_volumes",
]
