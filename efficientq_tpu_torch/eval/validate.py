"""Whole-volume validation: sliding-window inference and per-head metrics.

Counterpart of the JAX package's ``eval/validate.py`` (the reference's
``utils/validate.py:212-303``): for each volume, patch grid -> batched
forward -> stitch -> hard prediction on the device, then per
deep-supervision head and per subject the host-side metrics; the last head
optionally goes to NIfTI with the source affine and shape restoration.

JAX's 1-deep pipeline is kept: volume i+1's upload and forward are enqueued
before volume i's prediction is read back, so the host's metrics and NIfTI
work overlap the card.  On a card that takes three pieces:

- the upload goes through ``data.prefetch.device_feed`` (pinned staging
  buffers, a side stream, the compute stream waiting on an event): the
  loader's (N, C, D, H, W) array goes up as it is and becomes contiguous
  NDHWC on the card;
- after volume i's forward an event is recorded, and a second side stream
  copies its uint8 prediction into pinned memory after that event, before
  volume i+1's kernels are enqueued (on the compute stream the copy would
  wait for volume i+1's forward as well);
- the host waits on that copy's event, not on the card, before it
  computes volume i's metrics.

Its span (``utils/tracing.py``): ``pipeline.serve``, one per loader
batch, with device marks, the root that carries the batch's index
(volume i's spans in ``eval/sliding.py`` nest in it).  The device time
from one batch's span to the next's is the time the card waited for the
host, or for the upload, between them.
"""
from __future__ import annotations

import collections
import os
import os.path as P
from typing import List, Optional

import numpy as np
import torch

from .. import nnir, ops
from ..data.prefetch import device_feed
from ..ptq.deploy import make_s2d_volume_inferencer, serving_rewrites
from ..utils.tracing import span
from .metrics import SegMetricMC
from .sliding import column_grid_plan, make_volume_inferencer, patch_grid


def _check_serving(artifact, mesh, serve_grid, stride_div, serve_stem,
                   num_mo=1):
    """The JAX package's checks of the serving options, with its messages;
    a mesh is ROADMAP queue 1 item 9."""
    if mesh is not None:
        raise NotImplementedError("serving over a device mesh is ROADMAP "
                                  "queue 1 item 9")
    if artifact is not None:
        if num_mo != 1:
            raise ValueError("serving artifacts emit the final head only; "
                             "pass num_mo=1")
        # the manifest decides the grid (the column plan is pinned at
        # export); --serve_grid column is legal only for a column artifact
        if serve_grid == "column" and \
                artifact.manifest.get("serve_grid") != "column":
            raise ValueError("--serve_grid column with an artifact "
                             "exported for the patch grid — re-export "
                             "with --serve_grid column "
                             "--export_column_depth N")
    elif serve_grid == "column" and not stride_div:
        # the JAX package's words (a parity test holds them); the divisor
        # is the served model's, UResQ's or SegResNet's
        raise ValueError("serve_grid='column' needs stride_div "
                         "(models.uresq.min_input_divisor's D entry)")
    if serve_stem == "s2d" and (artifact is not None
                                or serve_grid == "column"):
        raise ValueError("--serve_stem s2d composes with the patch grid on "
                         "a single device only (not --artifact / "
                         "--dp_devices / --serve_grid column)")


def _column_count(x, patch_size, overlap, stride_div) -> int:
    """Number of full-depth columns of a volume: the column mode's
    patch_batch (every column in one forward)."""
    pd, cp, co = column_grid_plan(x.shape[1:4], patch_size, overlap,
                                  stride_div)
    return len(patch_grid((pd,) + tuple(x.shape[2:4]), cp, co)) * x.shape[0]


def _build_infer(graph, variables, x, patch_size, overlap, *, mode,
                 patch_batch, multilabel, compute_dtype, serve_stem, heads,
                 device, artifact=None, serve_grid="patch", stride_div=None,
                 tune_serving="auto"):
    """The volume inferencer of the first volume ``x``: the artifact's,
    the s2d stem's or the direct one; captured on a card.  Each serves the
    graph of ``ptq.deploy.serving_rewrites`` (the s2d path and the
    artifacts call it themselves)."""
    if artifact is not None:
        return artifact.volume_inferencer(patch_batch=patch_batch,
                                          hard_pred=True,
                                          multilabel=multilabel)
    served = serving_rewrites(graph, variables)[0]
    auto = patch_batch in ("auto", 0, None)
    if serve_stem == "s2d":
        infer = make_s2d_volume_inferencer(
            graph, variables, patch_batch=patch_batch, hard_pred=True,
            multilabel=multilabel,
            compute_dtype=compute_dtype or torch.bfloat16, heads=heads,
            device=device)
        if infer is not None:
            return infer
        # no eligible stem (e.g. --deploy none): serve direct
        print("serve_stem=s2d: no eligible stem on this graph (needs a "
              "3^3-stride-2 init conv feeding an int8 K1 consumer: use "
              "--deploy int8|mixed); falling back to the direct path")
        pb = 8 if auto else int(patch_batch)
    elif not auto:
        pb = int(patch_batch)
    elif serve_grid == "column":
        # every column in one forward; the patch-grid sweep does not apply
        pb = _column_count(x, patch_size, overlap, stride_div)
    else:
        from .autotune import choose_patch_batch

        pb = choose_patch_batch(served, variables, x, patch_size, overlap,
                                mode=mode, heads=heads,
                                compute_dtype=compute_dtype,
                                tune=tune_serving)
    return make_volume_inferencer(served, patch_batch=pb, mode=mode,
                                  heads=heads, hard_pred=True,
                                  multilabel=multilabel,
                                  compute_dtype=compute_dtype,
                                  serve_grid=serve_grid,
                                  stride_div=stride_div)


def _readback(preds: torch.Tensor, stream):
    """Start copying a volume's hard prediction to pinned host memory on
    ``stream`` once the work enqueued so far (its forward) is done:
    (host tensor, the copy's event).  On the CPU: (preds, None)."""
    if stream is None:
        return preds, None
    forward_done = torch.cuda.Event()
    forward_done.record()
    stream.wait_event(forward_done)
    with torch.cuda.stream(stream):
        host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
        host.copy_(preds, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    preds.record_stream(stream)
    return host, copied


def _host(readback) -> np.ndarray:
    host, copied = readback
    if copied is not None:
        copied.synchronize()
    return host.numpy()


def _pipeline(loader, device, serve):
    """Yields (host prediction, masks) per loader batch, in order, with
    volume i+1's upload and forward enqueued before volume i is read back.
    ``serve(x_ndhwc, masks)`` enqueues one volume's work and returns its
    device prediction."""
    rb_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    masks_q = collections.deque()

    def images():
        for images, masks in loader:
            masks_q.append(masks)
            yield images

    pending = None
    for batch, xb in enumerate(device_feed(images(), device=device)):
        masks = masks_q.popleft()
        with span("pipeline.serve", batch=batch, device=device):
            x = ops.ncdhw_to_ndhwc(xb).contiguous()
            del xb
            rb = _readback(serve(x, masks), rb_stream)
            del x
        if pending is not None:
            yield _host(pending[0]), pending[1]
        pending = (rb, masks)
    if pending is not None:
        yield _host(pending[0]), pending[1]


def validate_seg(
    graph,
    variables,
    loader,
    sn_list: Optional[List[str]],
    num_mo: int,
    n_class: int,
    *,
    patch_size,
    overlap,
    mode: str = "fp",
    save_dir: Optional[str] = None,
    is_cc: bool = False,
    sn_fn_dict=None,
    restore_shape_func=None,
    restore_infokw=None,
    merge_label_func=None,
    multilabel_fusetype=None,
    patch_batch="auto",
    mesh=None,
    artifact=None,
    infer=None,
    compute_dtype=None,
    serve_grid="patch",
    stride_div=None,
    tune_serving="auto",
    serve_stem="direct",
    device="cuda",
) -> List[SegMetricMC]:
    """Evaluate on a loader of (N, C, D, H, W) NumPy batches on ``device``
    (the card unless told ``"cpu"``).

    Returns one SegMetricMC per head (index -1 = final output).  On a
    card the patch forward replays from CUDA graphs
    (``make_volume_inferencer``'s ``capture``).  ``patch_batch="auto"`` takes
    the autotuner's choice (``eval/autotune.py``, ``tune_serving``: a
    measured sweep on a card, 2 on the CPU, ``min(full grid, 8)`` with
    ``"off"``); with ``serve_grid="column"`` every column in one forward;
    with ``serve_stem="s2d"`` ``make_s2d_volume_inferencer``'s whole-grid
    rule with out-of-memory halving.  ``infer``: a prebuilt inferencer
    (``make_volume_inferencer(..., hard_pred=True, multilabel=...)``).

    ``artifact``: a loaded ``export.ServingArtifact``; the forward runs
    from its program and ``graph`` / ``variables`` may be None (pass
    ``num_mo=1``: it emits the final head only).  ``serve_grid="column"``:
    full-depth columns (``eval.sliding.column_grid_plan``), which needs
    ``stride_div`` (the D entry of the served model's
    ``models.min_input_divisor``).
    ``mesh`` (ROADMAP queue 1 item 9) raises ``NotImplementedError``."""
    _check_serving(artifact, mesh, serve_grid, stride_div, serve_stem,
                   num_mo)
    device = torch.device(device)
    if variables is not None:
        variables = nnir.to_device(variables, device)
    sm = [SegMetricMC(n_class, sn_list, is_cc=is_cc) for _ in range(num_mo)]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    state = {"infer": infer, "multilabel": None}

    def serve(x, masks):
        if state["multilabel"] is None:
            # label (N, C, D, H, W) -> per-class sigmoid path; (N, D, H, W)
            # -> argmax path (same rank rule as evaluate_append)
            state["multilabel"] = np.asarray(masks).ndim == 5
        if state["infer"] is None:
            state["infer"] = _build_infer(
                graph, variables, x, patch_size, overlap, mode=mode,
                patch_batch=patch_batch, multilabel=state["multilabel"],
                compute_dtype=compute_dtype, serve_stem=serve_stem,
                heads=None, device=device, artifact=artifact,
                serve_grid=serve_grid, stride_div=stride_div,
                tune_serving=tune_serving)
        return state["infer"](variables, x, tuple(ops.triple(patch_size)),
                              tuple(ops.triple(overlap)))

    sn_counter = -1
    for preds, masks in _pipeline(loader, device, serve):
        multilabel = state["multilabel"]
        for j in range(preds.shape[1]):  # (M, N, D, H, W[, C])
            sn_counter += 1
            for i in range(-num_mo, 0):
                if multilabel:
                    seg = np.moveaxis(preds[i, j], -1, 0)  # (C, D, H, W)
                else:
                    seg = preds[i, j]  # (D, H, W) class ids
                label = np.asarray(masks[j])
                pred = sm[i].evaluate_append_pred(
                    seg, label, multilabel,
                    multilabel_fusetype=multilabel_fusetype)
                if save_dir and i == -1:
                    _save_nii(pred, sn_list, sn_counter, sn_fn_dict, save_dir,
                              merge_label_func, multilabel_fusetype,
                              restore_shape_func, restore_infokw)
    return sm


def _save_nii(pred, sn_list, idx, sn_fn_dict, save_dir, merge_label_func,
              multilabel_fusetype, restore_shape_func, restore_infokw,
              suffix=""):
    from ..utils.nifti import load_nifti, save_nifti

    assert sn_fn_dict, "Please specify SN to filename mapping."
    sn = sn_list[idx]
    seg = pred
    if merge_label_func:
        seg = merge_label_func(seg, multilabel_fusetype)
    seg = np.asarray(seg)
    if restore_shape_func:
        seg = restore_shape_func(seg, **restore_infokw[sn])
    try:
        affine = load_nifti(sn_fn_dict[sn]).affine
    except Exception:
        affine = np.eye(4)
    save_nifti(P.join(save_dir, f"{sn}{suffix}.nii.gz"),
               seg.astype(np.uint16), affine)


def inference(graph, variables, loader, sn_list, *, save_dir, patch_size,
              overlap, sn_fn_dict=None, suffix="_seg", mode="fp",
              restore_shape_func=None, restore_infokw=None,
              merge_label_func=None, multilabel_fusetype=None,
              patch_batch="auto", artifact=None, compute_dtype=None,
              serve_grid="patch", stride_div=None, tune_serving="auto",
              serve_stem="direct", device="cuda"):
    """Label-free inference and NIfTI export (the reference's
    ``validate.py:266-303``), final head only, with ``validate_seg``'s
    pipeline and serving options (the JAX package's checks of
    ``inference``, with its messages)."""
    if serve_stem == "s2d" and (artifact is not None
                                or serve_grid == "column"):
        raise ValueError("--serve_stem s2d composes with the patch grid on "
                         "a single device only")
    if not save_dir:
        print("No save directory specified for final true test inference!")
        return
    if serve_grid == "column" and artifact is not None:
        raise ValueError("--serve_grid column does not compose with "
                         "--artifact serving")
    if serve_grid == "column" and not stride_div:
        # the JAX package's words (a parity test holds them); the divisor
        # is the served model's, UResQ's or SegResNet's
        raise ValueError("serve_grid='column' needs stride_div "
                         "(models.uresq.min_input_divisor's D entry)")
    os.makedirs(save_dir, exist_ok=True)
    device = torch.device(device)
    if variables is not None:
        variables = nnir.to_device(variables, device)
    final_head = slice(-1, None)  # the aux heads are never computed
    multilabel = merge_label_func is not None  # per-class sigmoid path
    state = {"infer": None}

    def serve(x, _masks):
        if state["infer"] is None:
            state["infer"] = _build_infer(
                graph, variables, x, patch_size, overlap, mode=mode,
                patch_batch=patch_batch, multilabel=multilabel,
                compute_dtype=compute_dtype, serve_stem=serve_stem,
                heads=final_head, device=device, artifact=artifact,
                serve_grid=serve_grid, stride_div=stride_div,
                tune_serving=tune_serving)
        return state["infer"](variables, x, tuple(ops.triple(patch_size)),
                              tuple(ops.triple(overlap)))

    sn_counter = -1
    for preds, _ in _pipeline(loader, device, serve):
        for j in range(preds.shape[1]):
            sn_counter += 1
            if multilabel:
                pred = np.moveaxis(preds[-1, j], -1, 0)  # (C, D, H, W)
            else:
                pred = preds[-1, j]  # (D, H, W) class ids
            _save_nii(pred, sn_list, sn_counter, sn_fn_dict, save_dir,
                      merge_label_func, multilabel_fusetype,
                      restore_shape_func, restore_infokw, suffix)


def true_test_inference(graph, variables, data, save_dir, mode="fp",
                        patch_batch="auto", multilabel_fusetype=None,
                        artifact=None, compute_dtype=None,
                        serve_grid="patch", stride_div=None,
                        tune_serving="auto", serve_stem="direct",
                        device="cuda"):
    """Label-free export of the true-test split, the reference's
    ``inference_final`` (suffix '' as its trainer passes it)."""
    if data.true_test_image_loader is None:
        print("No true-test split found (true_test.txt); skipping "
              "true-test inference.")
        return
    inference(graph, variables, data.true_test_image_loader,
              data.true_test_sn, save_dir=save_dir,
              patch_size=data.slide_patch_size, overlap=data.slide_overlap,
              mode=mode, suffix="", patch_batch=patch_batch,
              sn_fn_dict=data.sn_to_fn_map,
              restore_shape_func=data.restore_shape_func,
              restore_infokw=data.restore_infokw,
              merge_label_func=data.merge_label_func,
              multilabel_fusetype=multilabel_fusetype, artifact=artifact,
              compute_dtype=compute_dtype, serve_grid=serve_grid,
              stride_div=stride_div, tune_serving=tune_serving,
              serve_stem=serve_stem, device=device)


def restore_crop(crop, pmin, pmax, shape):
    """Undo a crop back to the original volume shape (misc.py:162-171)."""
    image = np.zeros(shape, dtype=crop.dtype)
    image[pmin[0]:pmax[0], pmin[1]:pmax[1], pmin[2]:pmax[2]] = crop
    return image
