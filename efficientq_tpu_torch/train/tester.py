"""Tester / PTQTester: an evaluation-only facade over the validation stack.

Counterpart of the JAX package's ``train/tester.py`` (the reference's
``src/utils/tester.py``): ``test_as_is`` evaluates the current weights on
every configured split; ``snapshot`` saves them, optionally as a
compressed npz of NumPy arrays.
"""
from __future__ import annotations

import os
import os.path as P
import pickle

import numpy as np

from ..eval.validate import true_test_inference, validate_seg
from ..models import torch_io


class Tester:
    def __init__(self, graph, variables, data_cube, num_mo: int, n_class: int,
                 root: str, multilabel_fusetype=None, mode: str = "fp",
                 device="cuda"):
        self.graph = graph
        self.variables = variables
        self.data = data_cube
        self.num_mo = num_mo
        self.n_class = n_class
        self.root = root
        self.multilabel_fusetype = multilabel_fusetype
        self.mode = mode
        self.device = device
        os.makedirs(root, exist_ok=True)

    def test_as_is(self, folder: str = "test_as_is", is_save_nii: bool = False,
                   is_indiv: bool = True, is_cc: bool = False,
                   is_true_test: bool = False):
        """Evaluate the current weights on the val and test splits; writes
        <split>_seg.txt under <root>/<folder>; ``is_cc`` adds the
        lesion-level columns, ``is_true_test`` the label-free true-test
        segmentations."""
        save_dir = P.join(self.root, folder)
        os.makedirs(save_dir, exist_ok=True)
        results = {}
        for split, loader, sns in (("val", self.data.valloader,
                                    self.data.val_sn),
                                   ("test", self.data.testloader,
                                    self.data.test_sn)):
            if loader is None:
                continue
            nii_dir = P.join(save_dir, split) if is_save_nii else None
            sm = validate_seg(
                self.graph, self.variables, loader, sns, self.num_mo,
                self.n_class, patch_size=self.data.slide_patch_size,
                overlap=self.data.slide_overlap, mode=self.mode,
                save_dir=nii_dir, is_cc=is_cc,
                sn_fn_dict=self.data.sn_to_fn_map,
                restore_shape_func=self.data.restore_shape_func,
                restore_infokw=self.data.restore_infokw,
                merge_label_func=self.data.merge_label_func,
                multilabel_fusetype=self.multilabel_fusetype,
                device=self.device)
            with open(P.join(save_dir, f"{split}_seg.txt"), "w") as f:
                for i in range(-1, -self.num_mo - 1, -1):
                    sm[i].write_metric(f, "Output %d:" % i, is_indiv)
            sm[-1].print_metric("  " + split)
            results[split] = sm
        if is_true_test:
            true_test_inference(self.graph, self.variables, self.data,
                                P.join(save_dir, "true_test"),
                                mode=self.mode,
                                multilabel_fusetype=self.multilabel_fusetype,
                                device=self.device)
        return results

    def snapshot(self, fname: str, compress: bool = False):
        sd = torch_io.to_torch_state_dict(self.graph, self.variables)
        path = P.join(self.root, fname)
        if compress:
            np.savez_compressed(path if path.endswith(".npz")
                                else path + ".npz", state_dict=sd)
        else:
            with open(path, "wb") as f:
                pickle.dump({"state_dict": sd}, f)
        return path


class PTQTester(Tester):
    """Quantized-mode tester (tester.py:61-65)."""

    def __init__(self, graph, variables, data_cube, num_mo, n_class, root,
                 multilabel_fusetype=None, device="cuda"):
        super().__init__(graph, variables, data_cube, num_mo, n_class, root,
                         multilabel_fusetype, mode="quantized", device=device)
