"""Synthetic subjects and datasets in the reference's on-disk layout.

Counterpart of the JAX package's ``data/synthetic.py`` (NumPy; the same
generator calls in the same order, so a seed gives the same volumes):
blob-shaped lesions with seg labels {0, 1, 2[, 4]} and one (LiTS) or four
(BraTS) image modalities.  ``make_subject`` builds one subject in memory;
``make_synthetic_dataset`` writes ``<root>/<modality>/<sn>.npy|.npz`` and
split files.
"""
from __future__ import annotations

import os
import os.path as P

import numpy as np


def _blob(shape, center, radius):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    dist = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2
            + (xx - center[2]) ** 2) ** 0.5
    return dist <= radius


def task_modalities(task: str):
    """Modalities tuple with the label first."""
    if task.lower() == "brats":
        return ("seg", "flair", "t1", "t1ce", "t2")
    return ("seg", "ct")


def make_subject(rng: np.random.Generator, task="lits",
                 vol_shape=(32, 32, 32)):
    """One subject: ({modality: (D, H, W) float32}, (D, H, W) uint8 label).
    BraTS labels are {1, 2, 4} (organ, lesion, core); LiTS {1, 2}."""
    brats = task.lower() == "brats"
    mods = task_modalities(task)[1:]
    labels_vals = [1, 2, 4] if brats else [1, 2]
    label = np.zeros(vol_shape, np.uint8)
    # big organ blob + small lesion blob inside
    c1 = [int(rng.integers(s // 3, 2 * s // 3)) for s in vol_shape]
    r1 = int(min(vol_shape) // 3)
    organ = _blob(vol_shape, c1, r1)
    label[organ] = labels_vals[0]
    c2 = [int(np.clip(c + rng.integers(-r1 // 2, r1 // 2 + 1), 0, s - 1))
          for c, s in zip(c1, vol_shape)]
    lesion = _blob(vol_shape, c2, max(2, r1 // 3))
    label[lesion & organ] = labels_vals[1]
    if brats:
        core = _blob(vol_shape, c2, max(1, r1 // 5))
        label[core & organ] = labels_vals[2]
    images = {}
    for m in mods:
        img = rng.standard_normal(vol_shape).astype(np.float32) * 0.1
        img += organ * (1.0 + 0.2 * rng.standard_normal())
        img += lesion * (0.8 + 0.2 * rng.standard_normal())
        images[m] = img
    return images, label


def make_synthetic_dataset(root, task="lits", n_subjects=4,
                           vol_shape=(32, 32, 32), seed=0, access_type="npy",
                           splits=(0.5, 0.25, 0.25), round_id="1"):
    """Writes ``n_subjects`` subjects and the split files; returns
    (data_dir, split_dir)."""
    rng = np.random.default_rng(seed)
    mods = task_modalities(task)[1:]
    data_dir = P.join(root, "data")
    split_dir = P.join(root, "split")
    os.makedirs(P.join(data_dir, "seg"), exist_ok=True)
    for m in mods:
        os.makedirs(P.join(data_dir, m), exist_ok=True)

    def save(path, arr):
        if access_type == "npz":
            np.savez_compressed(path + ".npz", arr)
        else:
            np.save(path + ".npy", arr)

    sns = [f"sub{idx:03d}" for idx in range(n_subjects)]
    for sn in sns:
        images, label = make_subject(rng, task, vol_shape)
        for m in mods:
            save(P.join(data_dir, m, sn), images[m])
        save(P.join(data_dir, "seg", sn), label)

    # sn -> source-NIfTI map used for affine lookup on export
    with open(P.join(data_dir, "sn_fn.txt"), "w") as f:
        for sn in sns:
            f.write(f"{sn},{P.join(data_dir, mods[0], sn + '.nii.gz')}\n")

    rdir = P.join(split_dir, f"round{round_id}")
    os.makedirs(rdir, exist_ok=True)
    n_tr = max(1, int(len(sns) * splits[0]))
    n_val = max(1, int(len(sns) * splits[1]))
    parts = {
        "train.txt": sns[:n_tr],
        "val.txt": sns[n_tr:n_tr + n_val] or sns[:1],
        "test.txt": sns[n_tr + n_val:] or sns[-1:],
        # label-free inference target: the test subjects
        "true_test.txt": sns[n_tr + n_val:] or sns[-1:],
    }
    for fname, lst in parts.items():
        with open(P.join(rdir, fname), "w") as f:
            f.write("\n".join(lst) + "\n")
    return data_dir, split_dir
