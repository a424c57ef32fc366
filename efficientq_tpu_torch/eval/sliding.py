"""Whole-volume sliding-window inference with overlap-average stitching.

Counterpart of the JAX package's ``eval/sliding.py``: the same patch grid
(the reference's ``l[0 : d-p : p-o] + [d-p]`` rule, duplicate terminal start
included), the same left-to-right patch sum, and the same visit-count
normalisation.  It runs eagerly; ``make_volume_inferencer`` takes the place
of ``make_jitted_volume_inferencer``.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .. import nnir, ops


def grid_starts(size: int, patch: int, overlap: int) -> List[int]:
    """Start offsets along one axis: ``range(0, size-patch, patch-overlap)``
    plus the terminal start ``size - patch``."""
    if patch > size:
        raise ValueError(f"patch {patch} > volume extent {size}")
    return list(range(0, size - patch, patch - overlap)) + [size - patch]


def patch_grid(vol_shape: Sequence[int], patch_size,
               overlap) -> List[Tuple[int, int, int]]:
    patch_size = ops.triple(patch_size)
    overlap = ops.triple(overlap)
    d, h, w = vol_shape
    return [
        (i, j, k)
        for i in grid_starts(d, patch_size[0], overlap[0])
        for j in grid_starts(h, patch_size[1], overlap[1])
        for k in grid_starts(w, patch_size[2], overlap[2])
    ]


def extract_patches(image: torch.Tensor, starts, patch_size) -> torch.Tensor:
    """(N, D, H, W, C) -> (P, N, pd, ph, pw, C)."""
    pd, ph, pw = patch_size
    return torch.stack([image[:, i:i + pd, j:j + ph, k:k + pw, :]
                        for i, j, k in starts])


def visit_counter(starts, patch_size, vol_shape) -> np.ndarray:
    """Per-voxel patch visit counts (a host-side constant of the grid)."""
    pd, ph, pw = patch_size
    counter = np.zeros(tuple(vol_shape), np.float32)
    for i, j, k in starts:
        counter[i:i + pd, j:j + ph, k:k + pw] += 1.0
    return counter


def stitch_patches(preds: torch.Tensor, starts, vol_shape,
                   channels_first: bool = False,
                   normalize: bool = True) -> torch.Tensor:
    """(P, M, N, pd, ph, pw, C) -> (M, N, D, H, W, C), overlap-averaged.

    With ``channels_first`` the patches are (P, M, N, C, pd, ph, pw) and the
    canvas (M, N, C, D, H, W) (the channels-first serving tail,
    ``ptq.deploy.channels_first_tail``).

    Patches are added in grid order into a zero canvas, in place, in the
    patches' dtype: each voxel receives the same addends in the same order
    as the JAX package's padded-patch sum.  ``normalize=False`` returns the
    raw overlap sum (the visit count is positive and shared by all classes,
    so hard predictions do not need the division)."""
    lead = 3 if channels_first else 2  # canvas axes before D, H, W
    pd, ph, pw = preds.shape[1 + lead:4 + lead]
    canvas = preds.new_zeros((*preds.shape[1:1 + lead], *vol_shape,
                              *preds.shape[4 + lead:]))
    for idx, (i, j, k) in enumerate(starts):
        canvas[(slice(None),) * lead + (slice(i, i + pd), slice(j, j + ph),
                                        slice(k, k + pw))] += preds[idx]
    if not normalize:
        return canvas
    counter = torch.from_numpy(visit_counter(starts, (pd, ph, pw), vol_shape))
    trailing = (1,) * (canvas.dim() - lead - 3)
    return canvas / counter.to(canvas.device).reshape(*vol_shape, *trailing)


def sliding_window_inference(model_fn: Callable, image: torch.Tensor,
                             patch_size, overlap, patch_batch: int = 1,
                             normalize: bool = True,
                             channels_first: bool = False,
                             extract_fn: Callable = None,
                             vol_shape=None) -> torch.Tensor:
    """Run ``model_fn`` ((B, pd, ph, pw, C) -> (M, B, pd, ph, pw, C_out))
    over the overlapped patch grid of ``image`` (N, D, H, W, C), in chunks
    of ``patch_batch`` patches, and stitch: (M, N, D, H, W, C_out).  Heads
    are selected by the model (``nnir.apply(heads=...)``), so unused heads
    are never computed.

    ``channels_first``: the model emits (M, B, C_out, pd, ph, pw) and the
    result is (M, N, C_out, D, H, W).  ``extract_fn(image, starts,
    patch_size)`` replaces the patch extraction with another model-input
    space: a tuple of tensors batched on a leading P*N axis (e.g.
    ``kernels.stem.extract_pre_s2d_patches`` on an s2d volume).  The grid
    and the stitch then run in the coordinates of ``vol_shape``, the
    original volume's (D, H, W)."""
    patch_size = ops.triple(patch_size)
    if vol_shape is None:
        vol_shape = tuple(image.shape[1:4])
    starts = patch_grid(vol_shape, patch_size, overlap)
    P = len(starts)
    if extract_fn is not None:
        flat = extract_fn(image, starts, patch_size)
        N = flat[0].shape[0] // P
        chunks = [tuple(a[s:s + patch_batch] for a in flat)
                  for s in range(0, P * N, patch_batch)]
    else:
        N = image.shape[0]
        patches = extract_patches(image, starts, patch_size)
        flat = patches.reshape(P * N, *patches.shape[2:])
        chunks = [flat[s:s + patch_batch]
                  for s in range(0, P * N, patch_batch)]
    outs = [model_fn(c) for c in chunks]
    out = torch.cat(outs, dim=1)  # (M, P*N, ...)
    out = out.reshape(out.shape[0], P, N, *out.shape[2:]).movedim(1, 0)
    return stitch_patches(out, starts, vol_shape,
                          channels_first=channels_first, normalize=normalize)


def make_volume_inferencer(graph: nnir.Graph, patch_batch: int = 4,
                           mode: str = "fp", heads=None,
                           hard_pred: bool = False, multilabel: bool = False,
                           conv3x3_int8: Callable = None,
                           compute_dtype=None, int8_matmul: Callable = None,
                           qact_matmul: Callable = None):
    """Returns infer(variables, image, patch_size, overlap).

    ``heads``: the output heads to compute (e.g. ``slice(-1, None)`` for
    final-head-only serving; the aux heads are then never evaluated).
    ``hard_pred``: return uint8 hard predictions: (M, N, D, H, W, C)
    per-class binaries when ``multilabel`` (sigmoid(x) >= 0.5 <=> x >= 0),
    else (M, N, D, H, W) argmax class ids.  ``mode``: see ``nnir.apply``
    ('fp', 'quantized' or 'fq').  ``conv3x3_int8``, ``int8_matmul`` and
    ``qact_matmul`` replace the K1, K3 and K4 wrappers (see
    ``nnir.eval_node``).  ``compute_dtype``: see
    ``nnir.apply``; with hard predictions the heads stay in it through the
    stitch and the decision (the canvas traffic halves), else the logits
    come back as float32."""
    keep_hd = bool(hard_pred and compute_dtype is not None)

    def infer(variables, image, patch_size, overlap):
        def model_fn(xb):
            return nnir.apply(graph, variables, xb, mode=mode, heads=heads,
                              conv3x3_int8=conv3x3_int8,
                              int8_matmul=int8_matmul,
                              qact_matmul=qact_matmul,
                              compute_dtype=compute_dtype,
                              keep_head_dtype=keep_hd)

        with torch.inference_mode():
            out = sliding_window_inference(model_fn, image, patch_size,
                                           overlap, patch_batch,
                                           normalize=not hard_pred)
            if hard_pred:
                out = ((out >= 0) if multilabel
                       else torch.argmax(out, dim=-1)).to(torch.uint8)
        return out

    return infer
