"""Paired (image, label) transforms, host-side NumPy: the 3-D part that
the evaluation and calibration loaders run.

A copy of the JAX package's ``data/transforms.py``.  Images are
(C, D, H, W) float32, labels (D, H, W) integer (or (C', D, H, W) after a
label-split Lambda).  Transforms are callables (img, label) ->
(img, label).  They run on the host before the upload.  The train
loader's transforms (``Pad``, ``CenterCrop``, ``RandomCrop``,
``BalanceCrop``, ``RandomFlip``, ``RandomScaleCrop``, ``RandomNoise``,
``RandomModalityDropout``, ``RandomBlack`` and ``crop_centroid``) come
with ``train_fp``, their first caller (ROADMAP queue 1 item 6); the 2-D
helpers are off the path (ROADMAP).
"""
from __future__ import annotations

import numbers
from typing import Callable, List

import numpy as np


def _triple(v):
    if isinstance(v, numbers.Number):
        return (int(v),) * 3
    return tuple(int(x) for x in v)


def crop_size_correct(sp, ep, size):
    """Shift an out-of-range crop window back inside
    (dataloader/transforms.py:29-37)."""
    assert ep - sp <= size, f"Invalid crop size: {sp}..{ep} vs {size}"
    if sp < 0:
        ep -= sp
        sp = 0
    elif ep > size:
        sp -= ep - size
        ep = size
    return sp, ep


def crop(arr: np.ndarray, loc) -> np.ndarray:
    """Crop the inner-most 3 dims with boundary correction."""
    x1, y1, z1, x2, y2, z2 = loc
    s = arr.shape
    x1, x2 = crop_size_correct(x1, x2, s[-3])
    y1, y2 = crop_size_correct(y1, y2, s[-2])
    z1, z2 = crop_size_correct(z1, z2, s[-1])
    return arr[..., x1:x2, y1:y2, z1:z2]


def center_crop(arr: np.ndarray, size) -> np.ndarray:
    """Center crop with zero pad-to-size when smaller
    (dataloader/transforms.py:60-83)."""
    size = _triple(size)
    d, h, w = arr.shape[-3:]
    td, th, tw = size
    if (d, h, w) == (td, th, tw):
        return arr
    pads = []
    for cur, tgt in zip((d, h, w), (td, th, tw)):
        if cur < tgt:
            lo = (tgt - cur) // 2
            pads.append((lo, tgt - cur - lo))
        else:
            pads.append((0, 0))
    if any(p != (0, 0) for p in pads):
        full = [(0, 0)] * (arr.ndim - 3) + pads
        arr = np.pad(arr, full)
        d, h, w = arr.shape[-3:]
    x1, y1, z1 = (d - td) // 2, (h - th) // 2, (w - tw) // 2
    return crop(arr, (x1, y1, z1, x1 + td, y1 + th, z1 + tw))


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img, label):
        for t in self.transforms:
            img, label = t(img, label)
        return img, label


class ToArray:
    """ToTensor analogue: float32 image, int64 label."""

    def __call__(self, img, label):
        return np.asarray(img, np.float32), np.asarray(label, np.int64)


class Normalize:
    """Per-channel (x - mean) / std when provided
    (dataloader/transforms.py:160-178)."""

    def __init__(self, mean=None, std=None):
        self.mean = mean
        self.std = std

    def __call__(self, img, label):
        if self.mean is None:
            return img, label
        img = img.copy()
        if isinstance(self.mean, (list, tuple, np.ndarray)):
            for c, (m, s) in enumerate(zip(self.mean, self.std)):
                img[c] = (img[c] - m) / s
        else:
            img = (img - self.mean) / self.std
        return img, label


class Lambda:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, img, label):
        return self.fn(img, label)
