"""Paired (image, label) transforms, host-side NumPy: the 3-D transforms
of the evaluation, calibration and train loaders.

A copy of the JAX package's ``data/transforms.py``.  Images are
(C, D, H, W) float32, labels (D, H, W) integer (or (C', D, H, W) after a
label-split Lambda).  Transforms are callables (img, label) ->
(img, label).  They run on the host before the upload.  The random ones
draw from the explicit ``numpy.random.Generator`` they are given, in the
JAX version's order of draws, so equal generators give equal outputs.
``BalanceCrop`` samples with NumPy only (the JAX package prefers a C++
reservoir sampler when its library builds, which picks other voxels).
The 2-D transforms, ``Pad``, ``RandomModalityDropout`` and ``RandomBlack``
are not ported: no loader that a flag reaches builds them.
"""
from __future__ import annotations

import numbers
from typing import Callable, List, Optional

import numpy as np
from scipy import ndimage


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


def crop_centroid(arr: np.ndarray, centroid, size) -> np.ndarray:
    s = [int(x) // 2 for x in size]
    sp = [int(c) - si for c, si in zip(centroid, s)]
    ep = [p + int(sz) for p, sz in zip(sp, size)]
    return crop(arr, (sp[0], sp[1], sp[2], ep[0], ep[1], ep[2]))


class CenterCrop:
    def __init__(self, size, size_label=None):
        self.size = _triple(size)
        self.size_label = _triple(size_label) if size_label else self.size

    def __call__(self, img, label):
        return center_crop(img, self.size), center_crop(label, self.size_label)


def _random_loc(rng, shape, size):
    """A crop window of ``size`` inside ``shape`` (D, H, W), its corner
    drawn axis by axis."""
    corner = [int(rng.integers(0, e - t + 1)) for e, t in zip(shape, size)]
    return (*corner, *(c + t for c, t in zip(corner, size)))


class RandomCrop:
    def __init__(self, size, rng: Optional[np.random.Generator] = None):
        self.size = _triple(size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img, label):
        shape = img.shape[-3:]
        assert all(t <= e for t, e in zip(self.size, shape))
        if tuple(shape) == self.size:
            return img, label
        loc = _random_loc(self.rng, shape, self.size)
        return crop(img, loc), crop(label, loc)


def sample_mask_voxel(mask: np.ndarray, positive: bool, seed: int):
    """(count, index) of a uniformly drawn voxel where ``mask != 0``
    (positive) or ``mask == 0``: the JAX package's NumPy sampler.  The
    flat indices are the row-major order that ``np.argwhere`` lists, so
    the pick is the same, in a third of its memory."""
    m = np.asarray(mask)
    flat = np.flatnonzero(m != 0 if positive else m == 0)
    if len(flat) == 0:
        return 0, None
    k = np.random.default_rng(seed).integers(0, len(flat))
    return len(flat), tuple(int(v) for v in np.unravel_index(flat[k],
                                                             m.shape))


class BalanceCrop:
    """Crop centered on a positive-mask voxel with probability
    ``positive_prob`` (dataloader/transforms.py:429-470)."""

    def __init__(self, positive_prob, img_size, label_size=None,
                 mask_func=None, rng: Optional[np.random.Generator] = None):
        self.prob = positive_prob
        self.img_size = _triple(img_size)
        self.label_size = _triple(label_size) if label_size else self.img_size
        self.mask_func = mask_func or (lambda label: label > 0)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img, label):
        mask = np.asarray(self.mask_func(label))
        seed = int(self.rng.integers(1, 2 ** 62))
        n_pos, pos_c = sample_mask_voxel(mask, True, seed)
        n_neg, neg_c = sample_mask_voxel(mask, False, seed + 1)
        if n_pos == 0 and n_neg == 0:
            raise RuntimeError("Invalid patch size.")
        if n_neg == 0:
            is_pos = True
        elif n_pos == 0:
            is_pos = False
        else:
            is_pos = self.rng.random() <= self.prob
        center = (pos_c if is_pos else neg_c)[-3:]  # mask may carry channels
        return (crop_centroid(img, center, self.img_size),
                crop_centroid(label, center, self.label_size))


class RandomFlip:
    """An independent coin flip per spatial axis."""

    def __init__(self, axis_switch=(1, 1, 1),
                 rng: Optional[np.random.Generator] = None):
        self.axis_switch = axis_switch
        self.rng = rng or np.random.default_rng()

    def __call__(self, img, label):
        for ax_i, on in enumerate(self.axis_switch):
            if on and self.rng.integers(0, 2) == 1:
                axis = ax_i - 3
                img = np.flip(img, axis).copy()
                if label.ndim >= 3:
                    label = np.flip(label, axis).copy()
        return img, label


class RandomScaleCrop:
    """With probability ``p`` crop ceil(size/factor) at a random factor,
    scipy-zoom it to at least ``size`` and crop to ``size``; else a plain
    random crop."""

    def __init__(self, l_scale, h_scale, size, scale_order=1, p=0.5,
                 rng: Optional[np.random.Generator] = None):
        self.l_scale = l_scale
        self.h_scale = h_scale
        self.size = _triple(size)
        self.order = scale_order
        self.p = p
        self.rng = rng or np.random.default_rng()
        self.crop_only = RandomCrop(size, self.rng)

    def __call__(self, img, label):
        if self.rng.random() >= self.p:
            return self.crop_only(img, label)
        crop_size = np.array(self.size)
        shape = img.shape[-3:]
        fmin = max(c / e for c, e in zip(crop_size, shape))
        factor = (float(self.rng.uniform(max(self.l_scale, fmin),
                                         self.h_scale)),) * 3
        size = [int(np.ceil(x / y)) for x, y in zip(crop_size, factor)]
        loc = _random_loc(self.rng, shape, size)
        ip, lp = crop(img, loc), crop(label, loc)
        ip = np.stack([ndimage.zoom(c, factor, order=self.order) for c in ip])
        pmax, pmin = lp.max(), lp.min()
        if lp.ndim == 3:
            lp = ndimage.zoom(lp, factor, order=0)
        else:
            lp = np.stack([ndimage.zoom(c, factor, order=0) for c in lp])
        if self.order >= 2:
            lp = np.clip(lp, pmin, pmax)
        return (crop(ip, (0, 0, 0, *crop_size)).astype(np.float32),
                crop(lp, (0, 0, 0, *crop_size)))


class RandomNoise:
    """Additive Gaussian noise with probability ``prob``, sigma drawn from
    U(0, max_scale)."""

    def __init__(self, prob, max_scale=0.3,
                 rng: Optional[np.random.Generator] = None):
        self.prob = prob
        self.max_scale = max_scale
        self.rng = rng or np.random.default_rng()

    def __call__(self, img, label):
        if self.rng.random() < self.prob:
            scale = self.max_scale * self.rng.random()
            img = img + (self.rng.standard_normal(img.shape)
                         .astype(np.float32) * scale)
        return img, label
