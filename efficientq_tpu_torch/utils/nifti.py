"""Minimal NIfTI-1 I/O.

A copy of the JAX package's ``utils/nifti.py``: a NIfTI-1 (348-byte header,
'n+1' magic) writer and reader for 3-D integer and float volumes with an
affine, gzip-compressed for ``.nii.gz``, delegating to nibabel when it is
importable.  The reference exports segmentations as .nii.gz via nibabel.
"""
from __future__ import annotations

import gzip
import struct
from typing import Optional

import numpy as np

try:  # pragma: no cover - depends on environment
    import nibabel as _nib
except Exception:  # pragma: no cover
    _nib = None

_DTYPES = {
    np.dtype(np.uint8): (2, 8),
    np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32),
    np.dtype(np.float32): (16, 32),
    np.dtype(np.float64): (64, 64),
    np.dtype(np.uint16): (512, 16),
}
_CODES = {v[0]: k for k, v in _DTYPES.items()}


def save_nifti(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a 3-D volume as .nii.gz (or .nii)."""
    data = np.asarray(data)
    if affine is None:
        affine = np.eye(4)
    if _nib is not None:
        _nib.Nifti1Image(data, affine).to_filename(path)
        return
    if data.dtype not in _DTYPES:
        data = data.astype(np.float32)
    code, bitpix = _DTYPES[data.dtype]
    dim = np.ones(8, np.int16)
    dim[0] = data.ndim
    dim[1:1 + data.ndim] = data.shape
    pixdim = np.zeros(8, np.float32)
    pixdim[1:4] = np.linalg.norm(affine[:3, :3], axis=0)[:3]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)                      # sizeof_hdr
    struct.pack_into("<8h", hdr, 40, *dim)                   # dim
    struct.pack_into("<h", hdr, 70, code)                    # datatype
    struct.pack_into("<h", hdr, 72, bitpix)                  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)                # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                    # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                      # qform_code
    struct.pack_into("<h", hdr, 254, 1)                      # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])            # srow_x
    struct.pack_into("<4f", hdr, 296, *affine[1])            # srow_y
    struct.pack_into("<4f", hdr, 312, *affine[2])            # srow_z
    struct.pack_into("<4s", hdr, 344, b"n+1\x00")            # magic

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


class _Nifti:
    def __init__(self, data, affine):
        self._data = data
        self.affine = affine
        self.shape = data.shape

    def get_fdata(self):
        return self._data.astype(np.float64)

    @property
    def dataobj(self):
        return self._data


def load_nifti(path: str):
    """Read a .nii/.nii.gz written by this module (or any simple NIfTI-1)."""
    if _nib is not None:
        return _nib.load(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    assert sizeof_hdr == 348, "not a NIfTI-1 file"
    dim = struct.unpack_from("<8h", raw, 40)
    (code,) = struct.unpack_from("<h", raw, 70)
    (vox_offset,) = struct.unpack_from("<f", raw, 108)
    shape = tuple(dim[1:1 + dim[0]])
    dtype = _CODES[code]
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=n,
                         offset=int(vox_offset)).reshape(shape, order="F")
    affine = np.eye(4)
    for i, off in enumerate((280, 296, 312)):
        affine[i] = struct.unpack_from("<4f", raw, off)
    return _Nifti(data.copy(), affine)
