"""DataHub: owns all loaders and transform pipelines of a task.

A copy of the JAX package's ``data/datahub.py``: split files per round, an
optional ``meanstd.txt``, the train (shuffled, augmented, behind a
``PrefetchLoader`` when ``num_workers > 0``) / train-seq (sequential,
fixed transforms: the calibration's) / val / test / true-test loaders,
the sn -> filename map (``sn_fn.txt``), the sliding-window patch and
overlap, and the label-merge metadata the definer attaches.  The random
transforms draw from one ``np.random.default_rng(0)`` in the JAX
version's op order; the shuffle from the Loader's own.  The train ops are
those the JAX CLI reaches: a flip on every axis, the crop, noise.  The JAX
hub's seed, flip axes, scale probability, modality dropout and black
patches have no flag in either CLI and stay at its defaults here.

One repair: the train loader reads a shallow copy of the train-seq
loader's dataset (the volumes shared, the transform its own).  In the JAX
package both loaders share one dataset, so the calibration's
``use_fix_transform`` also switches the train loader to whole,
uncropped volumes, and ``ptq --qat_epochs`` then trains on those (at
BraTS's 155 x 240 x 240 the net cannot take them).
"""
from __future__ import annotations

import copy
import os.path as P
from typing import Callable, Optional

import numpy as np

from . import transforms as T
from .datasets import Loader, SegDataset, SegDatasetOnDisk, read_split


def file_to_dict(fname, sep=","):
    if fname is None or not P.isfile(fname):
        return None
    d = {}
    with open(fname) as f:
        for line in f.read().splitlines():
            k, v = line.split(sep)
            d[k] = v
    return d


class DataHub:
    def __init__(self, data_dir, modalities, train_split=None, val_split=None,
                 test_split=None, true_test_split=None, train_batchsize=1,
                 test_batchsize=1, mean=None, std=None, access_type="npz",
                 crop_type=None, crop_size_img=None, balance_rate=0.5,
                 balance_mask_func=None, on_disk=False,
                 random_noise_prob=None, scale_bound=None, scale_order=1,
                 sn_fn_file=None, slide_patch_size=None, slide_overlap=None,
                 tfm_lambda: Optional[Callable] = None, num_workers=0):
        self.data_dir = data_dir
        self.slide_patch_size = slide_patch_size
        self.slide_overlap = slide_overlap
        self.sn_to_fn_map = file_to_dict(
            P.join(data_dir, sn_fn_file) if sn_fn_file else None)
        self.train_sn = self.val_sn = self.test_sn = self.true_test_sn = None
        self.trainloader = self.trainseqloader = None
        self.valloader = self.testloader = self.true_test_image_loader = None
        # attached later by the definer (definer.py:122-125)
        self.restore_shape_func = None
        self.restore_infokw = None
        self.merge_label_func = None
        self.multilabel_fusetype = None

        if P.exists(P.join(data_dir, "meanstd.txt")):
            with open(P.join(data_dir, "meanstd.txt")) as f:
                lines = f.read().splitlines()
            mean = [float(x) for x in lines[0].split()[1:]]
            std = [float(x) for x in lines[1].split()[1:]]
            print("import mean and std value from file 'meanstd.txt'")

        rng = np.random.default_rng(0)
        basic = [T.ToArray(), T.Normalize(mean, std)]
        train_ops = list(basic) + [T.RandomFlip((1, 1, 1), rng=rng)]
        if crop_type == "random":
            if scale_bound:
                train_ops.append(T.RandomScaleCrop(
                    scale_bound[0], scale_bound[1], crop_size_img,
                    scale_order, 0.5, rng=rng))
            else:
                train_ops.append(T.RandomCrop(crop_size_img, rng=rng))
        elif crop_type == "balance":
            train_ops.append(T.BalanceCrop(balance_rate, crop_size_img, None,
                                           balance_mask_func, rng=rng))
        elif crop_type == "center":
            train_ops.append(T.CenterCrop(crop_size_img))
        elif crop_type is not None:
            raise ValueError("Unknown train crop type.")
        if random_noise_prob:
            train_ops.append(T.RandomNoise(random_noise_prob, 0.3, rng=rng))
        ops = list(basic)
        if tfm_lambda:
            train_ops.append(T.Lambda(tfm_lambda))
            ops.append(T.Lambda(tfm_lambda))
        train_tf = T.Compose(train_ops)
        tf = T.Compose(ops)
        DS = SegDatasetOnDisk if on_disk else SegDataset

        def exists(split):
            return split and P.isfile(split)

        if exists(train_split):
            self.train_sn = read_split(train_split)
            ds = DS(data_dir, train_split, modalities, access_type,
                    transform_rand=train_tf, transform_fix=tf)
            self.trainloader = Loader(copy.copy(ds), train_batchsize,
                                      shuffle=True, seed=0)
            if num_workers and num_workers > 0:
                from .prefetch import PrefetchLoader

                self.trainloader = PrefetchLoader(self.trainloader,
                                                  depth=min(num_workers, 4))
            self.trainseqloader = Loader(ds, test_batchsize, shuffle=False)
        if exists(val_split):
            self.val_sn = read_split(val_split)
            ds = DS(data_dir, val_split, modalities, access_type,
                    transform_fix=tf)
            self.valloader = Loader(ds, test_batchsize)
        if exists(test_split):
            self.test_sn = read_split(test_split)
            ds = DS(data_dir, test_split, modalities, access_type,
                    transform_fix=tf)
            self.testloader = Loader(ds, test_batchsize)
        if exists(true_test_split):
            self.true_test_sn = read_split(true_test_split)
            mods = list(modalities)
            mods[0] = None
            ds = DS(data_dir, true_test_split, mods, access_type,
                    transform_fix=tf)
            self.true_test_image_loader = Loader(ds, test_batchsize)
