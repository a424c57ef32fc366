"""Volume datasets: npy / npz / memmap access, in-RAM and on-disk variants.

A copy of the JAX package's ``data/datasets.py`` (NumPy there too): a split
file lists subject names (one per line; the RAM dataset sorts them, the
on-disk one keeps their order, as the reference does), ``modalities[0]`` is
the label directory (None for unlabeled inference sets), and the remaining
entries are image modality directories stacked into (C, D, H, W) float32.
``Loader`` is a plain iterator of stacked NumPy batches on the host: no
worker processes, which would fork a process holding a CUDA context.
"""
from __future__ import annotations

import os.path as P
import pickle
from typing import Callable, List

import numpy as np


def access_npy(data_dir, mod, sn, dtype):
    return np.load(P.join(data_dir, mod, f"{sn}.npy")).astype(dtype, copy=False)


def access_npz(data_dir, mod, sn, dtype):
    data = np.load(P.join(data_dir, mod, f"{sn}.npz"), allow_pickle=True)["arr_0"]
    return data.astype(dtype, copy=False)


def make_access_memmap(data_dir):
    with open(P.join(data_dir, "shapes.pickle"), "rb") as f:
        shapes = pickle.load(f)

    def access(data_dir, mod, sn, dtype):
        return np.memmap(P.join(data_dir, mod, f"{sn}.dat"), dtype=dtype,
                         mode="r", shape=shapes[sn])

    return access


def get_accessor(access_type: str, data_dir: str) -> Callable:
    if access_type == "npy":
        return access_npy
    if access_type == "npz":
        return access_npz
    if access_type == "memmap":
        return make_access_memmap(data_dir)
    raise ValueError(f"unknown access type {access_type}")


def read_split(path: str) -> List[str]:
    with open(path) as f:
        return f.read().splitlines()


class SegDataset:
    """All subjects resident in RAM (datasets.py:39-111). Subject names are
    sorted, like the reference."""

    def __init__(self, data_dir, split, modalities, access_type="npz",
                 transform_rand=None, transform_fix=None):
        self.transform_rand = transform_rand
        self.transform_fix = transform_fix
        self.transform = transform_rand if transform_rand else transform_fix
        self.sn_list = sorted(read_split(split))
        access = get_accessor(access_type, data_dir)
        self.data, self.label = [], []
        for sn in self.sn_list:
            imgs = [access(data_dir, m, sn, "float32") for m in modalities[1:]]
            img = np.stack(imgs)
            self.data.append(img)
            if modalities[0] is not None:
                self.label.append(access(data_dir, modalities[0], sn, "uint8"))
            else:
                self.label.append(imgs[-1].astype("uint8"))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        img, label = self.data[i], self.label[i]
        if self.transform is not None:
            img, label = self.transform(img, label)
        return img, label

    def use_random_transform(self):
        self.transform = self.transform_rand

    def use_fix_transform(self):
        self.transform = self.transform_fix


class SegDatasetOnDisk:
    """Lazy per-item load (datasets.py:114-182); split order preserved."""

    def __init__(self, data_dir, split, modalities, access_type="npz",
                 transform_rand=None, transform_fix=None):
        self.data_dir = data_dir
        self.modalities = modalities
        self.transform_rand = transform_rand
        self.transform_fix = transform_fix
        self.transform = transform_rand if transform_rand else transform_fix
        self.sn_list = read_split(split)
        self.access = get_accessor(access_type, data_dir)

    def __len__(self):
        return len(self.sn_list)

    def __getitem__(self, i):
        sn = self.sn_list[i]
        imgs = [self.access(self.data_dir, m, sn, "float32")
                for m in self.modalities[1:]]
        img = np.stack(imgs)
        if self.modalities[0] is not None:
            label = self.access(self.data_dir, self.modalities[0], sn, "uint8")
        else:
            label = imgs[-1].astype("uint8")
        if self.transform is not None:
            img, label = self.transform(img, label)
        return img, label

    def use_random_transform(self):
        self.transform = self.transform_rand

    def use_fix_transform(self):
        self.transform = self.transform_fix


class Loader:
    """Minimal batched loader over a dataset: shuffling, drop_last, stacked
    NumPy batches (in place of torch's DataLoader; ``data/prefetch.py``
    prefetches on a thread and uploads through pinned memory)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            chunk = idx[s:s + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            items = [self.dataset[int(i)] for i in chunk]
            imgs = np.stack([it[0] for it in items])
            labels = np.stack([it[1] for it in items])
            yield imgs, labels
