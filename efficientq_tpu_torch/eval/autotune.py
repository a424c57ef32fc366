"""Serving-geometry autotuning: choose patch_batch per workload signature.

Counterpart of the JAX package's ``eval/autotune.py``.  The patch grid is
a batch axis, and the best chunk of patches per forward depends on the
volume and patch geometry, the deployment and the card's memory.
``choose_patch_batch`` times the candidates once per signature on the card,
each through the captured inferencer the serving path uses
(``eval/sliding.py::make_volume_inferencer``, ``capture=True``), and
caches the choice in memory and on disk, so a production eval pays the
sweep only on the first volume of a new geometry.

Off a CUDA device it returns the caller's default without measuring: the
sweep would time the CPU, which is not what serving runs on.  The disk
cache is ``~/.cache/effq_torch_tune.json`` (``EFFQ_TUNE_CACHE`` overrides
it), apart from the JAX package's.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import os.path as P
import time

import torch

from .. import ops

_MEM_CACHE = {}


def cache_path() -> str:
    """The disk cache: ``EFFQ_TUNE_CACHE``, read at each call."""
    return os.environ.get("EFFQ_TUNE_CACHE",
                          P.expanduser("~/.cache/effq_torch_tune.json"))


def _load_disk():
    try:
        with open(cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_disk(d):
    """Merge-before-write and an atomic replace: concurrent eval processes
    must not clobber each other's entries or expose truncated JSON."""
    path = cache_path()
    try:
        os.makedirs(P.dirname(path) or ".", exist_ok=True)
        merged = {**_load_disk(), **d}
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=0)
        os.replace(tmp, path)
    except OSError as e:
        print(f"# tune_serving: cache {path} not written ({e})", flush=True)


def _candidates(n_patches: int):
    cands = {n_patches}
    for c in (2, 4, 6, 9, 12, 18):
        if c < n_patches:
            cands.add(c)
    # half and quarter grid
    cands.add(max(1, n_patches // 2))
    cands.add(max(1, -(-n_patches // 4)))
    return sorted(cands)


def graph_signature(graph):
    """The deployment's signature: node count, the convs' widths, the int8
    nodes, and the nodes on each kernel (K1: flagged int8 3^3, K2: the s2d
    stem, K3: flagged int8 1x1, K4: flagged float 1x1), so a batch tuned
    for one deployment is not reused for another."""
    flagged = [n for n in graph.nodes if n.attrs.get("pallas")]
    k1 = sum(n.attrs.get("kernel_size") == (3, 3, 3) for n in flagged)
    k3 = sum(bool(n.attrs.get("int8")) for n in flagged) - k1
    return (len(graph.nodes),
            tuple(n.attrs.get("out_ch", 0) for n in graph.nodes
                  if n.op == "conv"),
            sum(bool(n.attrs.get("int8")) for n in graph.nodes),
            k1, sum(n.op == "stem_s2d" for n in graph.nodes), k3,
            len(flagged) - k1 - k3)


def _kernel_sources_hash() -> str:
    from ..kernels.build import CSRC

    h = hashlib.sha256()
    for path in sorted(glob.glob(P.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def tune_key(graph, vol_shape, n_patches, patch_size, overlap, mode,
             heads, compute_dtype, device_name) -> str:
    """The cache key of one workload: the toolchain (torch, CUDA, the
    card's name, a hash of ``csrc/*.cu``: a new kernel or compiler can move
    the optimum), the geometry with the loader's batch (in ``n_patches``),
    the mode, the deployment (``graph_signature``), the heads and the
    compute dtype."""
    return str(("torch-v1", torch.__version__, torch.version.cuda,
                device_name, _kernel_sources_hash(), tuple(vol_shape),
                n_patches, tuple(ops.triple(patch_size)),
                tuple(ops.triple(overlap)), mode, graph_signature(graph),
                (heads.start, heads.stop, heads.step)
                if heads is not None else None,
                str(compute_dtype) if compute_dtype is not None else None))


def choose_patch_batch(graph, variables, example_image, patch_size, overlap,
                       *, mode: str = "fp", default: int = 2, heads=None,
                       compute_dtype=None, tune: str = "auto") -> int:
    """Measured patch_batch for this (volume shape, patch, overlap, mode,
    graph signature) on the image's device.  ``example_image`` is one real
    (N, D, H, W, C) volume already on the device.

    ``tune`` (--tune_serving): 'auto' = sweep once per signature and cache;
    'force' = sweep even on a cache hit (and overwrite the entry); 'off' =
    never measure: ``min(full grid, 8)``.  Off a CUDA device 'auto' and
    'force' return ``default``.  A candidate that runs out of device
    memory is skipped; any other failure raises."""
    from .sliding import make_volume_inferencer, patch_grid

    vol_shape = tuple(example_image.shape[1:4])
    n_patches = (len(patch_grid(vol_shape, ops.triple(patch_size),
                                ops.triple(overlap)))
                 * example_image.shape[0])
    if tune == "off":
        # no measurement; at most 8 patches a forward, so an unswept choice
        # cannot run out of memory on the big LiTS grids
        return min(n_patches, 8)
    if tune not in ("auto", "force"):
        raise ValueError(f"tune_serving {tune!r}: auto, force or off")
    device = example_image.device
    if device.type != "cuda":
        return default
    key = tune_key(graph, vol_shape, n_patches, patch_size, overlap, mode,
                   heads, compute_dtype, torch.cuda.get_device_name(device))
    if tune != "force":
        if key in _MEM_CACHE:
            return _MEM_CACHE[key]
        disk = _load_disk()
        if key in disk:
            _MEM_CACHE[key] = int(disk[key])
            return _MEM_CACHE[key]
    else:
        disk = _load_disk()

    cands = _candidates(n_patches)
    # the sweep captures up to len(cands) inferencers inside the first
    # eval of a new geometry: said up front, the choice in one line after
    print(f"# tune_serving: sweeping patch_batch {cands} for volume "
          f"{vol_shape} (first eval of this geometry; cached after)",
          flush=True)
    args = (variables, example_image, tuple(ops.triple(patch_size)),
            tuple(ops.triple(overlap)))
    report = []
    best, best_t = default, float("inf")
    for cand in cands:
        infer = make_volume_inferencer(
            graph, patch_batch=cand, mode=mode, heads=heads,
            compute_dtype=compute_dtype, capture=True)
        try:
            for _ in range(2):  # eager, then (at the latest) the capture
                infer(*args)
            torch.cuda.synchronize(device)
            # best of 3 timed runs: one noisy time would be frozen into
            # the persistent cache
            dt = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                infer(*args)
                torch.cuda.synchronize(device)
                dt = min(dt, time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as e:
            report.append(f"{cand}:skip({type(e).__name__})")
            continue
        finally:
            del infer
            torch.cuda.empty_cache()
        report.append(f"{cand}:{dt * 1e3:.0f}ms")
        if dt < best_t:
            best, best_t = cand, dt
    _MEM_CACHE[key] = best
    disk[key] = best
    _save_disk(disk)
    print(f"# tune_serving: {' '.join(report)} -> patch_batch {best}",
          flush=True)
    return best
