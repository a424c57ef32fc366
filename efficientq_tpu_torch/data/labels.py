"""Task label encodings: BraTS / LiTS multi-label split & merge.

Mirrors src/utils/misc.py:221-285 (numpy instead of torch):

- BraTS labels {0,1,2,4} -> 3 binary channels (WT, TC, ET) and back
- LiTS labels {0,1,2} (bkg/liver/tumor) -> 2 channels (liver, tumor) and back
- 'agg'/'con' multilabel fusion
"""
from __future__ import annotations

import numpy as np


def merge_label_basic(pred: np.ndarray, fusetype: str) -> np.ndarray:
    """Fuse hierarchical binary channels (C, ...). Mutating semantics of the
    reference preserved by operating on a copy."""
    pred = pred.copy()
    if fusetype.lower() in ("agg", "aggressive"):
        for i in range(len(pred)):
            pred[i] = (pred[i:].sum(axis=0) > 0)
    elif fusetype.lower() in ("con", "conservative"):
        for i in range(1, len(pred)):
            pred[i] = pred[i] * pred[i - 1]
    else:
        raise ValueError(f"Unknown multilabel fusetype: {fusetype}")
    return pred


def split_label_brats(label: np.ndarray) -> np.ndarray:
    """(D, H, W) in the remapped on-disk convention {0, 1=NCR, 2=ED, 3=ET}
    -> (3, D, H, W) float {WT, TC, ET} (misc.py:260-266)."""
    out = np.zeros((3, *label.shape), np.float32)
    out[0] = label > 0
    out[1] = (label == 1) | (label == 3)
    out[2] = label == 3
    return out


def merge_label_brats(label: np.ndarray, fusetype=None) -> np.ndarray:
    """(3, D, H, W) binary -> (D, H, W) in {0,1,2,4}."""
    label = label.astype(np.int32)
    if fusetype:
        label = merge_label_basic(label, fusetype)
    merged = np.zeros(label.shape[1:], label.dtype)
    merged[label[0] != 0] = 1                       # WT
    merged[(label[0] != 0) & (label[1] == 0)] = 2   # ED = WT - TC
    merged[label[2] != 0] = 4                       # ET
    return merged


def split_label_lits(label: np.ndarray) -> np.ndarray:
    """(D, H, W) in {0,1,2} -> (2, D, H, W) float {liver, tumor}."""
    out = np.zeros((2, *label.shape), np.float32)
    out[0] = label > 0
    out[1] = label == 2
    return out


def merge_label_lits(label: np.ndarray, fusetype=None) -> np.ndarray:
    label = label.astype(np.int32)
    if fusetype:
        label = merge_label_basic(label, fusetype)
    merged = np.zeros(label.shape[1:], label.dtype)
    merged[label[0] != 0] = 1
    merged[label[1] != 0] = 2
    return merged


def one_hot(label: np.ndarray, n_class: int, axis: int = 1) -> np.ndarray:
    """(..., D, H, W) int -> one-hot float stacked on ``axis``
    (utils/misc.py:357-363)."""
    return np.stack([(label == i) for i in range(n_class)],
                    axis=axis).astype(np.float32)
