"""ACDC fold logic and RAM-cached H5 readers (port of
``wsl4mis_tpu/data/acdc.py``, ACDC folds only).

* 100 patients, 5 folds; fold k holds out patients 20(k-1)+1 .. 20k.
* The train split reads per-slice H5 files under ``ACDC_training_slices/``
  and supervises on ``h5f[sup_type]`` (``label`` | ``scribble`` | a
  precomputed ``random_walker``); slices are order-0 zoomed to the patch
  size once at load time.
* The val split reads whole volumes under ``ACDC_training_volumes/``.

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


def fold_ids(fold: str) -> tuple[list[str], list[str]]:
    """(train_patients, test_patients) for fold1..fold5."""
    m = _FOLD_RE.match(fold)
    if not m:
        raise KeyError(f"unknown fold {fold!r}; expected fold1..fold5 (the "
                       "MAAG, MSCMR and prostate splits come with ScribbleVC, "
                       "ROADMAP.md Queue 1 item 13)")
    k = int(m.group(1))
    testing = set(ALL_CASES[20 * (k - 1): 20 * k])
    return [c for c in ALL_CASES if c not in testing], sorted(testing)


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
    """

    base_dir: str | None = None
    fold: str = "fold1"
    sup_type: str = "label"
    patch_size: tuple[int, int] = (256, 256)
    limit: int | None = None
    slices_dirname: str = "ACDC_training_slices"

    images: np.ndarray = field(init=False, repr=False)
    labels: np.ndarray = field(init=False, repr=False)
    dense_labels: np.ndarray = field(init=False, repr=False)
    case_ids: list[str] = field(init=False, repr=False)
    slice_names: list[str] = field(init=False, repr=False)

    def __post_init__(self):
        import h5py

        base = self.base_dir or default_acdc_root()
        slices_dir = os.path.join(base, self.slices_dirname)
        wanted = set(fold_ids(self.fold)[0])
        names = sorted(
            f for f in os.listdir(slices_dir) if f.split("_")[0] in wanted
        )
        if not names:
            raise FileNotFoundError(f"no slices for {self.fold} in {slices_dir}")
        if self.limit is not None:
            names = names[: self.limit]
        imgs, labs, dense = [], [], []
        for name in names:
            with h5py.File(os.path.join(slices_dir, name), "r") as f:
                if self.sup_type not in f:
                    raise KeyError(
                        f"{name} has no {self.sup_type!r} key (on-the-fly "
                        "random-walker labels are ROADMAP.md Queue 1 item 15)")
                img = f["image"][:].astype(np.float32)
                lab = f[self.sup_type][:].astype(np.int32)
                den = f["label"][:].astype(np.int32)
            imgs.append(_nearest_zoom2d(img, self.patch_size))
            labs.append(_nearest_zoom2d(lab, self.patch_size))
            dense.append(_nearest_zoom2d(den, self.patch_size))
        self.images = np.stack(imgs).astype(np.float32)
        self.labels = np.stack(labs).astype(np.int32)
        self.dense_labels = np.stack(dense).astype(np.int32)
        self.case_ids = [n.split("_")[0] for n in names]
        self.slice_names = names

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

    cases: list[str] = field(init=False, repr=False)
    volumes: list[dict] = field(init=False, repr=False)

    def __post_init__(self):
        import h5py

        base = self.base_dir or default_acdc_root()
        vol_dir = os.path.join(base, self.volumes_dirname)
        wanted = set(fold_ids(self.fold)[1])
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
