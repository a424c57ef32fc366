"""The one traffic generator: a mix's volume pool, made on the device from
the seed, and its batches as a loader hands them over.

A mix file (``traffic/<mix>.json``) names its driver and gives:
- ``volume``: the (D, H, W) of every volume, with ``pool``, the number of
  distinct volumes; or ``depths``, the last axis of each volume of
  ``base`` (D, H), in the order they are served.  Every seed serves the
  same sizes in the same order (the order decides which chunk shapes
  repeat, and so what the port captures); the seed fills them;
- ``batch``: volumes a loader batch holds (the configuration's
  ``test_batch_size`` unless given);
- ``warmup_batches``: batches the set-up serves before the window, the
  first in serving order (0: one pass over the pool);
- ``check_every``: the check compares every ``check_every``-th volume the
  window serves, from an offset drawn from the seed (``session``).

A volume follows the rules of the program's synthetic subjects: a large
"organ" blob and a small "lesion" blob inside it, each modality Gaussian
noise of std 0.1 plus the blobs' seeded intensities, stored as integers
over ``GRID`` in [-2, 2): 12 significant bits, as a CT scan's Hounsfield
units have.  TF32 keeps 11, so it rounds the organ's intensities, while
the stem's float32 sums of them stay exact (``model``'s note).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .model import _seed

# intensities are integers over GRID in [-2, 2): 12 significant bits
GRID = 2048


def volume_shapes(mix: Dict) -> List[Tuple[int, int, int]]:
    """The sizes of the pool in serving order, the same for every seed."""
    if "depths" in mix:
        return [(*mix["base"], int(d)) for d in mix["depths"]]
    return [tuple(mix["volume"])] * int(mix["pool"])


def _ball(shape, center, radius, device):
    axes = [torch.arange(s, device=device, dtype=torch.float32) - c
            for s, c in zip(shape, center)]
    dist2 = (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
             + axes[2][None, None, :] ** 2)
    return dist2 <= radius * radius


def _randint(gen, lo, hi):
    """An integer in [lo, hi) from ``gen``."""
    return int(torch.randint(lo, hi, (1,), generator=gen,
                             device=gen.device).item())


def make_volume(num_mod: int, shape, seed: int, device):
    """One subject's (num_mod, D, H, W) float32 image on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c1 = [_randint(gen, s // 3, 2 * s // 3) for s in shape]
    r1 = min(shape) // 3
    organ = _ball(shape, c1, r1, device)
    c2 = [min(max(c + _randint(gen, -(r1 // 2), r1 // 2 + 1), 0), s - 1)
          for c, s in zip(c1, shape)]
    lesion = _ball(shape, c2, max(2, r1 // 3), device) & organ
    amp = 0.2 * torch.randn(2, num_mod, generator=gen, device=device)
    img = 0.1 * torch.randn((num_mod, *shape), generator=gen, device=device)
    img += organ * (1.0 + amp[0])[:, None, None, None]
    img += lesion * (0.8 + amp[1])[:, None, None, None]
    return torch.clamp(torch.round(img * GRID), -2 * GRID,
                       2 * GRID - 1) / GRID


def make_pool(cfg: Dict, mix: Dict, seed: int, device):
    """The mix's images for ``seed``, in serving order, on ``device``."""
    return [make_volume(cfg["num_mod"], shape, _seed(seed, 100 + i), device)
            for i, shape in enumerate(volume_shapes(mix))]


def batches(pool, batch: int):
    """The loader's batches of the pool, cycled once: a list of
    (volume indices, images (N, C, D, H, W) float32 NumPy).  A pool that
    the batch does not divide is cycled until it does, so every batch is
    full."""
    n = len(pool)
    span = n * batch // np.gcd(n, batch)
    out = []
    for s in range(0, span, batch):
        idx = [(s + j) % n for j in range(batch)]
        out.append((idx, torch.stack([pool[i] for i in idx]).cpu().numpy()))
    return out
