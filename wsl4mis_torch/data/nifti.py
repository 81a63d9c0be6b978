"""Minimal NIfTI-1 reader/writer in pure numpy (no nibabel/SimpleITK; the
port's copy of ``wsl4mis_tpu/data/nifti.py``).

The reference uses SimpleITK/nibabel for two things only: reading voxel
spacing of the original ACDC volumes (test_2D_fully.py:104-106) and writing
prediction/image/label volumes (test_2D_fully.py:115-123). Neither library
is needed: the 348-byte NIfTI-1 header is handled directly. Supports
.nii and .nii.gz, the dtypes this framework emits (uint8/int16/int32/
float32/float64), and the pixdim/srow affine fields.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    data: np.ndarray          # array indexed [x, y, z] (NIfTI order)
    spacing: tuple            # (sx, sy, sz) — matches sitk GetSpacing order
    affine: np.ndarray | None = None

    @property
    def array_zyx(self) -> np.ndarray:
        """Volume as [z, y, x] — the layout sitk.GetArrayFromImage yields."""
        return np.transpose(self.data, (2, 1, 0))


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> NiftiImage:
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    dim = struct.unpack("<8h", hdr[40:56])
    ndim = dim[0]
    shape = tuple(dim[1 : 1 + ndim])
    datatype = struct.unpack("<h", hdr[70:72])[0]
    bitpix = struct.unpack("<h", hdr[72:74])[0]
    pixdim = struct.unpack("<8f", hdr[76:108])
    vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
    scl_slope = struct.unpack("<f", hdr[112:116])[0]
    scl_inter = struct.unpack("<f", hdr[116:120])[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype])
    if dt.itemsize * 8 != bitpix:
        raise ValueError(f"{path}: bitpix {bitpix} does not match datatype "
                         f"{datatype}")
    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=dt, count=count, offset=vox_offset
    ).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    srow = np.array(
        [
            struct.unpack("<4f", hdr[280:296]),
            struct.unpack("<4f", hdr[296:312]),
            struct.unpack("<4f", hdr[312:328]),
        ]
    )
    affine = np.vstack([srow, [0, 0, 0, 1]])
    spacing = tuple(float(p) for p in pixdim[1:4])
    return NiftiImage(data=np.asarray(data), spacing=spacing, affine=affine)


def write_nifti(path: str, array_zyx: np.ndarray, spacing=(1.0, 1.0, 1.0)) -> None:
    """Write a [z, y, x] array (sitk convention) with (sx, sy, sz) spacing."""
    data = np.transpose(np.asarray(array_zyx), (2, 1, 0))  # -> [x, y, z]
    dt = data.dtype
    if dt not in _CODES:
        data = data.astype(np.float32)
        dt = data.dtype
    code = _CODES[np.dtype(dt)]
    hdr = bytearray(352)  # 348 header + 4 extension bytes
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, dt.itemsize * 8)
    pixdim = [1.0] + list(spacing) + [1.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    # qform/sform: simple scaled-identity sform
    struct.pack_into("<h", hdr, 252, 0)      # qform_code
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = scanner anat
    struct.pack_into("<4f", hdr, 280, spacing[0], 0, 0, 0)
    struct.pack_into("<4f", hdr, 296, 0, spacing[1], 0, 0)
    struct.pack_into("<4f", hdr, 312, 0, 0, spacing[2], 0)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + data.tobytes(order="F")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _open(path, "wb") as f:
        f.write(payload)


def read_spacing(path: str) -> tuple:
    """(sx, sy, sz) without materializing the data payload."""
    with _open(path, "rb") as f:
        hdr = f.read(348)
    pixdim = struct.unpack("<8f", hdr[76:108])
    return tuple(float(p) for p in pixdim[1:4])
