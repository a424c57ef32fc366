"""Segmentation metrics + the multi-class metric accumulator (NumPy).

A copy of the JAX package's ``eval/metrics.py`` (which is NumPy code too):
binary voxel metrics, connected-component lesion counts
(scipy.ndimage.label) and ``SegMetricMC`` with the reference's buffering,
csv and pretty-print formats.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
from scipy import ndimage

EPS = 1e-6


def dice(pred_b, target_b) -> float:
    p = np.asarray(pred_b, np.float64)
    t = np.asarray(target_b, np.float64)
    return float((2 * (p * t).sum() + EPS) / (p.sum() + t.sum() + EPS))


def accuracy(pred_b, target_b) -> float:
    p = np.asarray(pred_b)
    t = np.asarray(target_b)
    return float((p == t).sum() / t.size)


def sensitivity(pred_b, target_b) -> float:
    p = np.asarray(pred_b, np.float64)
    t = np.asarray(target_b, np.float64)
    return float(((p * t).sum() + EPS) / (t.sum() + EPS))


def specificity(pred_b, target_b) -> float:
    p = np.asarray(pred_b) == 0
    t = np.asarray(target_b) == 0
    return float(((p & t).sum() + EPS) / (t.sum() + EPS))


def precision(pred_b, target_b) -> float:
    p = np.asarray(pred_b, np.float64)
    t = np.asarray(target_b, np.float64)
    return float(((p * t).sum() + EPS) / (p.sum() + EPS))


def num_component(mask) -> float:
    _, n = ndimage.label(np.asarray(mask))
    return float(n)


def num_false_positive(pred_b, target_b) -> float:
    """Connected components of pred with zero overlap with target
    (utils/metrics.py:75-86)."""
    pred = np.asarray(pred_b)
    target = np.asarray(target_b)
    compo, n = ndimage.label(pred)
    false = 0
    for i in range(1, n + 1):
        if not (target * (compo == i)).any():
            false += 1
    return float(false)


def num_false_negative(pred_b, target_b) -> float:
    return num_false_positive(target_b, pred_b)


def num_positive(pred_b, target_b) -> float:
    return num_component(target_b)


def validate_vs_label(output, target, task="lits"):
    """Per-class Dice between a (possibly multi-head) raw output and a
    target — the FP-vs-Q comparison utility (utils/metrics.py:119-148).

    output: (M, N, C, D, H, W) or (N, C, D, H, W) logits; target: hard
    labels (N, D, H, W) for lits, binary channels (N, C, D, H, W) for brats.
    """
    output = np.asarray(output)
    if output.ndim >= 6:
        return [validate_vs_label(o, target, task) for o in output]
    target = np.asarray(target)
    if task == "lits":
        pred = np.argmax(output, axis=1)
        return [dice(pred == c, target == c) for c in range(output.shape[1])]
    if task == "brats":
        pred = (1 / (1 + np.exp(-output)) >= 0.5).astype(np.int32)
        measure = [dice(pred.sum(axis=1) == 0, target.sum(axis=1) == 0)]
        for c in range(output.shape[1]):
            measure.append(dice(pred[:, c], target[:, c]))
        return measure
    raise ValueError(f"Unknown task {task}")


class SegMetricMC:
    """Multi-class segmentation metric accumulator with the reference's
    write formats (validate.py:19-209): per-class and foreground-mean
    acc/dsc/sens/spec (+ lesion fpl/fnl/totall when is_cc)."""

    BASE = ("acc", "dsc", "sens", "spec")
    CC = ("fpl", "fnl", "totall")

    CALC = {
        "acc": accuracy, "dsc": dice, "sens": sensitivity, "spec": specificity,
        "fpl": num_false_positive, "fnl": num_false_negative,
        "totall": num_positive,
    }

    def __init__(self, n_class: int = 2, sn_list: Optional[List[str]] = None,
                 is_cc: bool = False):
        self.n_class = n_class
        self.is_cc = is_cc
        self.metric_names = self.BASE + (self.CC if is_cc else ())
        self.sn_list = list(sn_list) if sn_list else []
        self.buffer: Dict[str, List[float]] = {}
        for m in self.metric_names:
            self.buffer[m] = []
            for i in range(n_class):
                self.buffer[f"{m}/{i}"] = []

    def evaluate_append(self, seg_out: np.ndarray, label: np.ndarray,
                        multilabel_fusetype: Optional[str] = None) -> np.ndarray:
        """seg_out: logits, (C, D, H, W) (multi-class argmax path when one
        more dim than label) or (C, D, H, W) vs label (C, D, H, W)
        (multilabel sigmoid path).  Returns the hard prediction."""
        seg_out = np.asarray(seg_out)
        label = np.asarray(label)
        multilabel = seg_out.ndim == label.ndim
        if multilabel:
            assert seg_out.shape == label.shape
            pred = (1.0 / (1.0 + np.exp(-seg_out)) >= 0.5).astype(np.int32)
        else:
            pred = np.argmax(seg_out, axis=0)
        return self.evaluate_append_pred(pred, label, multilabel,
                                         multilabel_fusetype)

    def evaluate_append_pred(self, pred: np.ndarray, label: np.ndarray,
                             multilabel: bool,
                             multilabel_fusetype: Optional[str] = None
                             ) -> np.ndarray:
        """Accumulate from an already-hard prediction — (C, D, H, W) binary
        per-class (multilabel) or (D, H, W) class ids (argmax).  Lets the
        caller compute the prediction on device (eval/sliding.py
        ``hard_pred``) and transfer uint8 instead of float logits."""
        pred = np.asarray(pred)
        label = np.asarray(label)
        if multilabel:
            assert pred.shape == label.shape
            if multilabel_fusetype:
                from ..data.labels import merge_label_basic
                pred = merge_label_basic(pred, multilabel_fusetype)

        for m in self.metric_names:
            vals = []
            for i in range(self.n_class):
                if multilabel:
                    seg, gt = pred[i], label[i]
                else:
                    seg, gt = (pred == i).astype(np.int32), (label == i).astype(np.int32)
                v = self.CALC[m](seg, gt)
                self.buffer[f"{m}/{i}"].append(v)
                vals.append(v)
            # mean ignores background for the argmax path (validate.py:195-198)
            self.buffer[m].append(float(np.mean(vals if multilabel else vals[1:])))
        return pred

    def __len__(self):
        return len(self.buffer[self.metric_names[0] + "/0"])

    def get_metric(self) -> Dict[str, float]:
        out = {}
        for m in self.metric_names:
            out[m] = float(np.mean(self.buffer[m])) if self.buffer[m] else 0.0
            for i in range(self.n_class):
                key = f"{m}/{i}"
                out[key] = float(np.mean(self.buffer[key])) if self.buffer[key] else 0.0
        return out

    # --- writers (formats match validate.py:86-160) ---

    def write_csv(self, epoch, fid):
        metric = [str(epoch)]
        for _, v in self.get_metric().items():
            metric.append("%.4f" % v)
        fid.write(", ".join(metric) + "\n")

    def write_metric(self, fid, preline=None, is_indiv=False):
        if preline:
            fid.write(preline + "\n")
        metric = self.get_metric()
        total_line = ", ".join("%s = %.4f" % (k, v) for k, v in metric.items())
        fid.write(total_line + "\n")
        if is_indiv:
            title = "|%20s|" % "SN" + "".join(
                "%8s|" % k.upper() for k in self.buffer)
            fid.write(title + "\n")
            for i, sn in enumerate(self.sn_list):
                line = "|%20s|" % sn + "".join(
                    "%8.4f|" % v[i] for v in self.buffer.values())
                fid.write(line + "\n")

    def print_metric(self, preword=None):
        hdr = ("%s Segmentation Metrics:" % preword) if preword \
            else "Segmentation Metrics:"
        print(hdr)
        metric = self.get_metric()
        parts = []
        for k, v in metric.items():
            if parts and re.match(r"^[^/]*$", k):
                parts[-1] += "\n"
            parts.append("%s = %.4f" % (k, v))
        print(", ".join(parts))

