"""DataHub: owns the evaluation and calibration loaders of a task.

A copy of the JAX package's ``data/datahub.py`` for what the ``ptq`` and
``infer`` missions read: split files per round, an optional
``meanstd.txt``, the train-seq (sequential, fixed transforms: the
calibration's) / val / test / true-test loaders, the sn -> filename map
(``sn_fn.txt``), the sliding-window patch and overlap, and the label-merge
metadata the definer attaches.  The shuffled, augmented train loader, its
random transforms and its ``PrefetchLoader`` come with ``train_fp``, their
first caller (ROADMAP queue 1 item 6); ``trainloader`` stays None.
"""
from __future__ import annotations

import os.path as P
from typing import Callable, Optional

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
                 test_split=None, true_test_split=None, test_batchsize=1,
                 mean=None, std=None, access_type="npz", on_disk=False,
                 sn_fn_file=None, slide_patch_size=None, slide_overlap=None,
                 tfm_lambda: Optional[Callable] = None):
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

        ops = [T.ToArray(), T.Normalize(mean, std)]
        if tfm_lambda:
            ops.append(T.Lambda(tfm_lambda))
        tf = T.Compose(ops)
        DS = SegDatasetOnDisk if on_disk else SegDataset

        def exists(split):
            return split and P.isfile(split)

        if exists(train_split):
            self.train_sn = read_split(train_split)
            ds = DS(data_dir, train_split, modalities, access_type,
                    transform_fix=tf)
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
