"""Calibration-volume selection (``--lwq_select``).

Counterpart of the JAX package's ``ptq/select.py``: calibrate once per
candidate volume and keep the result with the best quantized dice on the
labeled candidate (train) volumes themselves; the validation split is
never touched.  The JAX package's study found train-volume dice picks the
best calibration draw at 2 bits where reconstruction-error proxies pick
the worst.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from .engine import run_ptq, run_ptq_mixed


def to_ndhwc(img) -> np.ndarray:
    """A loader's (N, C, D, H, W) NumPy batch as contiguous NDHWC."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(img), 1, -1))


def select_calibration(graph, variables, candidate_imgs: Sequence[np.ndarray],
                       candidate_labels: Sequence[np.ndarray], *, num_mo: int,
                       n_class: int, patch_size, overlap,
                       multilabel_fusetype=None, mixed_frac: float = 0.0,
                       mixed_qlvl: int = 16, mixed_tail: bool = True,
                       verbose: bool = False, device="cuda", **ptq_kw):
    """Run PTQ once per candidate calibration volume; keep the best.

    ``candidate_imgs`` / ``candidate_labels``: NCDHW NumPy volumes (one
    batch entry each, as the sequential train loader yields them).  Every
    calibrated net is scored by the final head's mean foreground dice over
    all the candidates (``validate_seg`` in quantized mode, 2 patches a
    forward).  With ``mixed_frac`` the sensitivity ranking is computed once,
    on the first candidate, and reused by every candidate's
    ``run_ptq_mixed``: 1 + K calibrations instead of 2K.

    The scoring is eager, also on a card: each calibrated net scores a
    few volumes, too few replays to repay a CUDA graph's capture
    (``PERF.md``, ``chip_smoke.py`` phase 11 (f)).

    Returns ``(fgraph, qvars, report, selection)`` of the winner, with
    ``selection = {"scores": [...], "picked": index, "seconds": {"ranking":
    s (with mixed_frac), "candidates": [(calibration s, scoring s), ...]}}``
    (host clock).  Only the best result so far is kept."""
    from ..eval.sliding import make_volume_inferencer
    from ..eval.validate import validate_seg

    if len(candidate_imgs) != len(candidate_labels):
        raise ValueError("candidate imgs/labels length mismatch")
    if len(candidate_imgs) < 2:
        raise ValueError("--lwq_select needs at least 2 candidates")

    score_pairs = list(zip(candidate_imgs, candidate_labels))
    multilabel = np.asarray(candidate_labels[0]).ndim == 5
    sn = [f"cand{i}" for i in range(len(candidate_imgs))]
    ranking = None
    seconds = {"candidates": []}
    if mixed_frac:
        t0 = time.perf_counter()
        _, _, rep1 = run_ptq(graph, variables, to_ndhwc(candidate_imgs[0]),
                             verbose=verbose, device=device, **ptq_kw)
        ranking = rep1.layer_rel_losses or rep1.layer_losses
        del rep1
        seconds["ranking"] = time.perf_counter() - t0
    best, scores = None, []
    for i, img in enumerate(candidate_imgs):
        t0 = time.perf_counter()
        calib_x = to_ndhwc(img)
        if mixed_frac:
            fg, fv, report = run_ptq_mixed(
                graph, variables, calib_x, mixed_frac=mixed_frac,
                mixed_qlvl=mixed_qlvl, mixed_tail=mixed_tail,
                verbose=verbose, ranking=ranking, device=device, **ptq_kw)
        else:
            fg, fv, report = run_ptq(graph, variables, calib_x,
                                     verbose=verbose, device=device, **ptq_kw)
        t1 = time.perf_counter()
        sm = validate_seg(fg, fv, score_pairs, sn, num_mo, n_class,
                          patch_size=patch_size, overlap=overlap,
                          mode="quantized", patch_batch=2,
                          multilabel_fusetype=multilabel_fusetype,
                          infer=make_volume_inferencer(
                              fg, patch_batch=2, mode="quantized",
                              hard_pred=True, multilabel=multilabel,
                              capture=False),
                          device=device)
        score = float(sm[-1].get_metric()["dsc"])
        seconds["candidates"].append((t1 - t0, time.perf_counter() - t1))
        if verbose:
            print(f"calib_select candidate {i}: train-volume dice "
                  f"{score:.4f}")
        scores.append(score)
        if best is None or score > scores[best[0]]:
            best = (i, fg, fv, report)
        del fg, fv, report

    picked, fg, fv, report = best
    return fg, fv, report, {"scores": scores, "picked": picked,
                            "seconds": seconds}
