"""Datasets, batch iteration, host and on-device augmentation, NIfTI
files and the offline data tools (preprocessing, scribble simulation,
CTAugment) of the port."""

from .acdc import (
    ALL_CASES,
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
from .preprocess import convert_acdc, normalize, percentile_clip, process_case
from .scribble_sim import (
    generate_scribble,
    largest_components,
    scribble_2d,
    scribble_for_class,
    zhang_suen_thin,
)
from .synthetic import (
    ArraySliceDataset,
    synthetic_slices,
    synthetic_volumes,
    zoomed_with_native,
)
from .weak_strong import (
    OPS,
    CTATransform,
    CTAugment,
    OpCall,
    WeakStrongAugment,
    cta_apply,
)

__all__ = [
    "ALL_CASES",
    "OPS",
    "AcdcSliceDataset",
    "AcdcVolumeDataset",
    "ArraySliceDataset",
    "CTATransform",
    "CTAugment",
    "HostRandomGenerator",
    "NiftiImage",
    "OpCall",
    "WeakStrongAugment",
    "augment_batch",
    "augment_batch_s2l",
    "batch_iterator",
    "convert_acdc",
    "cta_apply",
    "default_acdc_root",
    "fold_ids",
    "generate_scribble",
    "labeled_patient_ids",
    "largest_components",
    "normalize",
    "paired_iterator",
    "percentile_clip",
    "prefetch",
    "process_case",
    "read_nifti",
    "read_spacing",
    "sample_policy",
    "scribble_2d",
    "scribble_for_class",
    "synthetic_slices",
    "synthetic_volumes",
    "write_nifti",
    "zhang_suen_thin",
    "zoomed_with_native",
]
