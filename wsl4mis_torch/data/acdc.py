"""ACDC fold logic and RAM-cached H5 readers (port of
``wsl4mis_tpu/data/acdc.py``).

* 100 patients, 5 folds; fold k holds out patients 20(k-1)+1 .. 20k.
  ScribbleVC's splits: ``MAAGfold`` (35 train patients), ``MAAGfold70``,
  ``MAAGfoldN`` (N of the 70, drawn with seed 0) against a fixed 15, the
  MSCMR split ``MSCMRfold`` (2-digit case names), and the prostate splits
  ``prostate_fold1..4`` / ``prostate_a`` (80 patients); their slices and
  volumes live under the datasets' ``slices_dirname`` /
  ``volumes_dirname`` (``MSCMR_training_slices``, ...).
* The train split reads per-slice H5 files under ``ACDC_training_slices/``
  and supervises on ``h5f[sup_type]`` (``label`` | ``scribble`` |
  ``random_walker``: precomputed, or else made from the slice's scribble
  by ``data.random_walker``, the ACDC or prostate generator per
  ``rw_mode``); slices are order-0 zoomed to the patch size once at load
  time.
* The val split reads whole volumes under ``ACDC_training_volumes/``.
* The semi-supervised split (``labeled_type``) labels the patients whose
  number is a multiple of 10 among a fold's train patients.

``h5py`` is imported inside the readers only, so the package imports
without it.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

ALL_CASES = ["patient{:0>3}".format(i) for i in range(1, 101)]

_FOLD_RE = re.compile(r"^fold([1-5])$")


def default_acdc_root() -> str:
    """WSL4MIS_ACDC_ROOT, else the first existing of the usual places."""
    env = os.environ.get("WSL4MIS_ACDC_ROOT")
    if env:
        return env
    for cand in ("../data/ACDC", "data/ACDC"):
        if os.path.isdir(cand):
            return cand
    return "../data/ACDC"


def _acdc_fold_ids(fold: str) -> tuple[list[str], list[str]]:
    m = _FOLD_RE.match(fold)
    if not m:
        raise KeyError(f"unknown fold {fold!r}; expected fold1..fold5, "
                       "MAAGfold[N], MSCMRfold or prostate_*")
    k = int(m.group(1))
    testing = set(ALL_CASES[20 * (k - 1): 20 * k])
    return [c for c in ALL_CASES if c not in testing], sorted(testing)


_MAAG_TRAIN35 = [37, 50, 53, 100, 38, 19, 61, 74, 97, 31, 91, 35, 56, 94,
                 26, 69, 46, 59, 4, 89, 71, 6, 52, 43, 45, 63, 93, 14, 98,
                 88, 21, 28, 99, 54, 90]
_MAAG_TRAIN70 = _MAAG_TRAIN35 + [2, 76, 34, 85, 70, 86, 3, 8, 51, 40, 7, 13,
                                 47, 55, 12, 58, 87, 9, 65, 62, 33, 42, 23,
                                 92, 29, 11, 83, 68, 75, 67, 16, 48, 66, 20,
                                 15]
_MAAG_VAL = [84, 32, 27, 96, 17, 18, 57, 81, 79, 22, 1, 44, 49, 25, 95]
# the held-out offline test set (test_ACDC_scribblevc.py:45-46)
_MAAG_TEST = [5, 39, 77, 82, 78, 10, 64, 24, 30, 73, 80, 41, 36, 60, 72]


def maag_test_ids() -> list[str]:
    """The 15 patients of ScribbleVC's offline MAAG test."""
    return ["patient{:0>3}".format(i) for i in _MAAG_TEST]


def maag_fold_ids(fold: str, seed: int = 0) -> tuple[list[str], list[str]]:
    """ScribbleVC's MAAG splits (dataset_scribblevc.py:314-336): MAAGfold
    35 train patients, MAAGfold70 70, MAAGfoldN a random N of the 70; the
    same 15 validation patients."""
    fmt = "patient{:0>3}".format
    val = [fmt(i) for i in _MAAG_VAL]
    if fold == "MAAGfold":
        return [fmt(i) for i in _MAAG_TRAIN35], val
    if fold == "MAAGfold70":
        return [fmt(i) for i in _MAAG_TRAIN70], val
    if fold.startswith("MAAGfold"):
        n = int(fold[8:])
        chosen = np.random.RandomState(seed).choice(_MAAG_TRAIN70, size=n,
                                                     replace=False)
        return [fmt(i) for i in chosen], val
    raise KeyError(f"unknown MAAG fold {fold!r}")


_MSCMR_TRAIN = [13, 14, 15, 18, 19, 20, 21, 22, 24, 25, 26, 27, 2, 31, 32,
                34, 37, 39, 42, 44, 45, 4, 6, 7, 9]
_MSCMR_VAL = [1, 29, 36, 41, 8]


def mscmr_fold_ids() -> tuple[list[str], list[str]]:
    """The MSCMR split (dataset_scribblevc.py:406-410; 2-digit ids)."""
    fmt = "patient{:0>2}".format
    return [fmt(i) for i in _MSCMR_TRAIN], [fmt(i) for i in _MSCMR_VAL]


_PROSTATE_A_TEST = [61, 58, 22, 56, 44, 24, 40, 59, 53, 64, 65, 35, 30, 78,
                    72, 80, 26, 68, 52, 74]


def prostate_fold_ids(fold: str) -> tuple[list[str], list[str]]:
    """The prostate splits (dataset_scribblevc.py:78-116): 80 patients;
    prostate_fold1..4 hold out 20-patient blocks, prostate_a tests a fixed
    20. The reference's 'a' train list leaves out fold4's block, not the
    'a' test ids (dataset_scribblevc.py:100-103), and so does this one."""
    fmt = "patient{:0>3}".format
    all_cases = [fmt(i) for i in range(1, 81)]
    sub = fold[len("prostate_"):]
    if sub == "a":
        f4 = {fmt(i) for i in range(61, 81)}
        return ([c for c in all_cases if c not in f4],
                [fmt(i) for i in _PROSTATE_A_TEST])
    m = re.match(r"^fold([1-4])$", sub)
    if not m:
        raise KeyError(f"unknown prostate fold {fold!r}; expected "
                       "prostate_fold1..4 or prostate_a")
    k = int(m.group(1))
    testing = set(all_cases[20 * (k - 1): 20 * k])
    return [c for c in all_cases if c not in testing], sorted(testing)


def fold_ids(fold: str) -> tuple[list[str], list[str]]:
    """(train_patients, test_patients) of fold1..fold5, MAAGfold*,
    MSCMRfold or prostate_* (the JAX package's resolve_fold_ids)."""
    if fold.startswith("MAAGfold"):
        return maag_fold_ids(fold)
    if fold == "MSCMRfold":
        return mscmr_fold_ids()
    if fold.startswith("prostate_"):
        return prostate_fold_ids(fold)
    return _acdc_fold_ids(fold)


resolve_fold_ids = fold_ids  # the JAX package's name for every fold kind


def labeled_patient_ids(fold: str) -> tuple[list[str], list[str]]:
    """(labeled, unlabeled) train patients of a fold: the labeled ones are
    the multiples of 10 (dataset_semi.py:27-34)."""
    train, _ = fold_ids(fold)
    all_labeled = ["patient{:0>3}".format(10 * i) for i in range(1, 11)]
    labeled = [c for c in all_labeled if c in train]
    return labeled, [c for c in train if c not in labeled]


def _nearest_zoom2d(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """scipy.ndimage.zoom(arr, scale, order=0) by explicit index math:
    output i samples input i * (in-1)/(out-1), rounded half up."""
    h, w = arr.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return np.ascontiguousarray(arr)
    ri = np.floor(np.arange(oh) * ((h - 1) / (oh - 1)) + 0.5).astype(np.int64)
    ci = np.floor(np.arange(ow) * ((w - 1) / (ow - 1)) + 0.5).astype(np.int64)
    ri = np.clip(ri, 0, h - 1)
    ci = np.clip(ci, 0, w - 1)
    return np.ascontiguousarray(arr[np.ix_(ri, ci)])


@dataclass
class AcdcSliceDataset:
    """All training slices of a fold, in RAM, zoomed to ``patch_size``.

    images (N,H,W) float32; labels (N,H,W) int32 per ``sup_type``
    (scribbles mark unannotated pixels 4); dense_labels the ``label`` key.
    ``labeled_type`` "labeled" / "unlabeled" keeps the slices of one side
    of ``labeled_patient_ids``; None keeps every train patient's.
    ``keep_native`` also keeps each slice's image and supervision at their
    native size (``native_images`` / ``native_labels``, lists), which host
    augmentation transforms before it zooms.
    """

    base_dir: str | None = None
    fold: str = "fold1"
    sup_type: str = "label"
    labeled_type: str | None = None
    patch_size: tuple[int, int] = (256, 256)
    keep_native: bool = False
    limit: int | None = None
    slices_dirname: str = "ACDC_training_slices"
    rw_mode: str = "acdc"  # the on-the-fly random-walker generator for a
                           # slice without a random_walker key: "acdc" or
                           # "prostate"

    images: np.ndarray = field(init=False, repr=False)
    labels: np.ndarray = field(init=False, repr=False)
    dense_labels: np.ndarray = field(init=False, repr=False)
    case_ids: list[str] = field(init=False, repr=False)
    slice_names: list[str] = field(init=False, repr=False)
    native_images: list[np.ndarray] | None = field(init=False, repr=False)
    native_labels: list[np.ndarray] | None = field(init=False, repr=False)

    def __post_init__(self):
        import h5py

        base = self.base_dir or default_acdc_root()
        slices_dir = os.path.join(base, self.slices_dirname)
        if self.labeled_type is None:
            wanted = fold_ids(self.fold)[0]
        else:
            labeled, unlabeled = labeled_patient_ids(self.fold)
            wanted = labeled if self.labeled_type == "labeled" else unlabeled
        wanted = set(wanted)
        names = sorted(
            f for f in os.listdir(slices_dir) if f.split("_")[0] in wanted
        )
        if not names:
            raise FileNotFoundError(f"no slices for {self.fold} in {slices_dir}")
        if self.limit is not None:
            names = names[: self.limit]
        imgs, labs, dense = [], [], []
        native_i, native_l = [], []
        for name in names:
            with h5py.File(os.path.join(slices_dir, name), "r") as f:
                img = f["image"][:].astype(np.float32)
                if self.sup_type == "random_walker" and \
                        self.sup_type not in f:
                    lab = self._random_walker(img, f["scribble"][:])
                elif self.sup_type not in f:
                    raise KeyError(f"{name} has no {self.sup_type!r} key")
                else:
                    lab = f[self.sup_type][:].astype(np.int32)
                den = f["label"][:].astype(np.int32)
            imgs.append(_nearest_zoom2d(img, self.patch_size))
            labs.append(_nearest_zoom2d(lab, self.patch_size))
            dense.append(_nearest_zoom2d(den, self.patch_size))
            native_i.append(img)
            native_l.append(lab)
        self.images = np.stack(imgs).astype(np.float32)
        self.labels = np.stack(labs).astype(np.int32)
        self.dense_labels = np.stack(dense).astype(np.int32)
        self.case_ids = [n.split("_")[0] for n in names]
        self.slice_names = names
        self.native_images = native_i if self.keep_native else None
        self.native_labels = native_l if self.keep_native else None

    def _random_walker(self, image, scribble):
        """The pseudo label of one slice made from its scribble
        (dataset_scribblevc.py:353-356 of the reference)."""
        from .random_walker import (
            pseudo_label_generator_acdc,
            pseudo_label_generator_prostate,
        )

        gen = (pseudo_label_generator_prostate if self.rw_mode == "prostate"
               else pseudo_label_generator_acdc)
        return gen(image, scribble.astype(np.int32))

    def __len__(self) -> int:
        return self.images.shape[0]


@dataclass
class AcdcVolumeDataset:
    """Validation volumes of a fold: list of {"case", "image", "label"}
    at native resolution with dense labels."""

    base_dir: str | None = None
    fold: str = "fold1"
    limit: int | None = None
    volumes_dirname: str = "ACDC_training_volumes"
    custom_patients: list[str] | None = None  # in place of fold's test ids

    cases: list[str] = field(init=False, repr=False)
    volumes: list[dict] = field(init=False, repr=False)

    def __post_init__(self):
        import h5py

        base = self.base_dir or default_acdc_root()
        vol_dir = os.path.join(base, self.volumes_dirname)
        wanted = set(self.custom_patients if self.custom_patients
                     is not None else fold_ids(self.fold)[1])
        names = sorted(
            f for f in os.listdir(vol_dir) if f.split("_")[0] in wanted
        )
        if self.limit is not None:
            names = names[: self.limit]
        self.cases = names
        self.volumes = []
        for name in names:
            with h5py.File(os.path.join(vol_dir, name), "r") as f:
                self.volumes.append({
                    "case": name.replace(".h5", ""),
                    "image": f["image"][:].astype(np.float32),
                    "label": f["label"][:].astype(np.int32),
                })

    def __len__(self) -> int:
        return len(self.volumes)

    def __iter__(self):
        return iter(self.volumes)
