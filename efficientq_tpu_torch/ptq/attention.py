"""Segmentation-aware attention weighting for PTQ calibration (PyTorch).

Counterpart of the JAX package's ``ptq/attention.py``:

- ``hard_pred``: task-specific hard predictions from the last head
- ``class_voxel_counts``: per-class voxel counts inside the body mask
- ``attention_weight_map``: per-class weights (max_n / n_c)^p
- ``mask_pyramid``: 5 average-pooled resolutions of the voxel weight map

All tensors NDHWC (channels last); masks are (N, D, H, W).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import ops


def pred_lits(out: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) logits -> (N, D, H, W) argmax labels."""
    return torch.argmax(out, dim=-1)


def pred_brats(out: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) logits -> (N, D, H, W) overlay labels: later channels
    overwrite earlier (1 = WT, 2 = TC, 3 = ET)."""
    hard = torch.sigmoid(out) >= 0.5
    pred = torch.zeros(out.shape[:-1], dtype=torch.int32, device=out.device)
    for i in range(out.shape[-1]):
        pred = torch.where(hard[..., i], i + 1, pred)
    return pred


def pred_brats_con_merge(out: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Overlay prediction with conservative channel merging first (a
    channel counts only where every earlier channel is on); ``axis`` is the
    class axis (``1`` for the channels-first serving tail)."""
    hard = (torch.sigmoid(out) >= 0.5).to(torch.int32)
    merged = [hard.select(axis, 0)]
    for i in range(1, out.shape[axis]):
        merged.append(merged[-1] * hard.select(axis, i))
    pred = torch.zeros_like(merged[0])
    for i, m in enumerate(merged):
        pred = torch.where(m > 0, i + 1, pred)
    return pred


def hard_pred(out: torch.Tensor, task: str) -> torch.Tensor:
    if task == "lits":
        return pred_lits(out)
    if task == "brats":
        return pred_brats(out)
    raise ValueError(f"unknown task {task}")


def class_voxel_counts(out: torch.Tensor, body_mask: torch.Tensor,
                       task: str) -> List[int]:
    """Per-class voxel counts of the hard prediction within the body mask,
    read back to the host in one transfer."""
    if task == "lits":
        pred = pred_lits(out)
        counts = [((pred == i) & body_mask).sum() for i in range(3)]
    elif task == "brats":
        hard = torch.sigmoid(out) >= 0.5
        bkg = (hard.sum(dim=-1) == 0).sum() - (~body_mask).sum()
        counts = [bkg] + [(hard[..., i] & body_mask).sum()
                          for i in range(hard.shape[-1])]
    else:
        raise ValueError(f"unknown task {task}")
    return [int(v) for v in torch.stack(counts).cpu().tolist()]


def attention_weight_map(out_last: torch.Tensor, body_mask: torch.Tensor,
                         style: str, task: str
                         ) -> Tuple[Dict[int, float], List[int]]:
    """Per-class attention weights from the FP prediction.

    style 'p:<power>': weight_c = (max(nums) / n_c)^p, 1.0 for empty
    classes."""
    nums = class_voxel_counts(out_last, body_mask, task)
    if not style.startswith("p:"):
        raise ValueError(f"unknown attention weight map style {style}")
    p = float(style[2:])
    mx = max(nums)
    weight_map = {i: 1.0 if n == 0 else (mx / n) ** p
                  for i, n in enumerate(nums)}
    return weight_map, nums


def _any_pool(mask: torch.Tensor, k) -> torch.Tensor:
    """Boolean (N, D, H, W) mask -> True where any voxel of a window is."""
    pooled = ops.max_pool3d(mask[..., None].to(torch.float32), k)
    return pooled[..., 0] > 0.5


def mask_pyramid(output_fp: torch.Tensor, body_mask: torch.Tensor,
                 weight_map: Dict[int, float], init_stride, num_lvls: int = 5,
                 task: str = "lits") -> List[torch.Tensor]:
    """num_lvls-level pyramid of voxel weight maps, one per feature
    resolution.

    output_fp: stacked heads (M, N, D, H, W, C); the last head drives the
    prediction.  Level 0 is the prediction average-pooled by init_stride;
    each next level halves resolution.  Outside the body mask the weight
    is 1.
    """
    init_stride = ops.triple(init_stride)
    out = ops.avg_pool3d(output_fp[-1], init_stride)
    body = _any_pool(body_mask, init_stride)
    pyramid = []
    for _ in range(num_lvls):
        pred = hard_pred(out, task)
        mask = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
        for k, v in weight_map.items():
            mask = torch.where(pred == k, torch.full_like(mask, v), mask)
        pyramid.append(torch.where(body, mask, torch.ones_like(mask)))
        out = ops.avg_pool3d(out, 2)
        body = _any_pool(body, 2)
    return pyramid


def match_pyramid_level(pyramid, y_shape_ndhwc):
    """The pyramid level whose spatial shape matches the layer output, or
    None when no level matches."""
    target = tuple(y_shape_ndhwc[1:4])
    for mask in pyramid or ():
        if tuple(mask.shape[1:4]) == target:
            return mask
    return None
