"""Whole-volume sliding-window inference with overlap-average stitching.

Counterpart of the JAX package's ``eval/sliding.py``: the same patch grid
(the reference's ``l[0 : d-p : p-o] + [d-p]`` rule, duplicate terminal start
included), the same left-to-right patch sum, and the same visit-count
normalisation.  ``serve_volume`` is the one serving loop: the direct
inferencer (``make_volume_inferencer``), the s2d one
(``ptq/deploy.py::make_s2d_volume_inferencer``) and a serving artifact's
(``export.py::ServingArtifact.volume_inferencer``) all run it, each with
its own chunk forward.  ``make_volume_inferencer`` takes the place of the
JAX package's ``make_jitted_volume_inferencer``: on a card it replays each
chunk's patch forward from a CUDA graph (``CapturedForward``), so the
host's per-kernel launch time is paid once per capture instead of once per
call.  ``column_grid_plan`` and ``serve_grid="column"`` serve full-depth
columns in place of the patch grid's cubes.

Its spans (``utils/tracing.py``): ``volume.extract`` (the patch
extraction, and a column grid's pad), ``volume.stitch`` (from the
concatenation to the last patch added) and ``volume.decide`` (the hard
prediction), each with device marks, and ``volume.chunk`` (one chunk's
forward, with ``patches`` and ``kind``: ``eager``, or ``capture`` /
``replay`` as ``CapturedForward`` sets it).
"""
from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import nnir, ops
from ..kernels import COUNTERS
from ..utils.tracing import annotate, span


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
    counter = _counter(tuple(starts), (pd, ph, pw), tuple(vol_shape),
                       canvas.device)
    trailing = (1,) * (canvas.dim() - lead - 3)
    return canvas / counter.reshape(*vol_shape, *trailing)


@functools.lru_cache(maxsize=8)
def _counter(starts, patch_size, vol_shape, device) -> torch.Tensor:
    """``visit_counter`` on ``device``, uploaded once per geometry."""
    return torch.from_numpy(visit_counter(starts, patch_size,
                                          vol_shape)).to(device)


def sliding_window_inference(model_fn: Callable, image: torch.Tensor,
                             patch_size, overlap, patch_batch: int = 1,
                             normalize: bool = True,
                             channels_first: bool = False,
                             extract_fn: Callable = None) -> torch.Tensor:
    """Run ``model_fn`` ((B, pd, ph, pw, C) -> (M, B, pd, ph, pw, C_out))
    over the overlapped patch grid of ``image`` (N, D, H, W, C), in chunks
    of ``patch_batch`` patches, and stitch: (M, N, D, H, W, C_out).  Heads
    are selected by the model (``nnir.apply(heads=...)``), so unused heads
    are never computed.

    ``channels_first``: the model emits (M, B, C_out, pd, ph, pw) and the
    result is (M, N, C_out, D, H, W).  ``extract_fn(image, starts,
    patch_size)`` replaces the patch extraction with another model-input
    space: a tuple of tensors batched on a leading P*N axis (e.g.
    ``ptq.deploy.s2d_extract_fn``'s, the s2d patches of the volume), which
    ``model_fn`` takes as one tuple."""
    patch_size = ops.triple(patch_size)
    vol_shape = tuple(image.shape[1:4])
    starts = patch_grid(vol_shape, patch_size, overlap)
    P = len(starts)
    dev = image.device
    with span("volume.extract", device=dev):
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
    outs = []
    for s, c in zip(range(0, P * N, patch_batch), chunks):
        with span("volume.chunk", patches=min(patch_batch, P * N - s),
                  kind="eager"):
            outs.append(model_fn(c))
    with span("volume.stitch", device=dev):
        out = torch.cat(outs, dim=1)  # (M, P*N, ...)
        out = out.reshape(out.shape[0], P, N, *out.shape[2:]).movedim(1, 0)
        return stitch_patches(out, starts, vol_shape,
                              channels_first=channels_first,
                              normalize=normalize)


def column_grid_plan(vol_shape, patch_size, overlap, stride_div):
    """Full-depth column serving plan: (padded D, column patch, overlap).

    D pads up to the net's stride multiple ``stride_div`` (the D entry of
    the served model's ``models.min_input_divisor``) and each column spans
    it whole, with no D overlap; H and W keep the reference's patch and
    grid rule.  On a BraTS volume (155 x 240 x 240, 128^3 patches, overlap
    16) that is 4 columns of 160 x 128 x 128 in place of 8 cubes.  Not for
    tasks of unbounded depth: a column's activations grow with it."""
    d = vol_shape[0]
    pd = -(-d // stride_div) * stride_div
    patch_size = ops.triple(patch_size)
    overlap = ops.triple(overlap)
    return pd, (pd, patch_size[1], patch_size[2]), (0, overlap[1], overlap[2])


def _check_grid(serve_grid, stride_div):
    if serve_grid not in ("patch", "column"):
        raise ValueError(f"unknown serve_grid {serve_grid!r}")
    if serve_grid == "column" and not stride_div:
        # the JAX package's words (a parity test holds them); the divisor
        # is the served model's, UResQ's or SegResNet's
        raise ValueError("serve_grid='column' needs stride_div "
                         "(models.uresq.min_input_divisor)")


def serve_volume(model_fn: Callable, image: torch.Tensor, patch_size,
                 overlap, patch_batch: int, *, hard_pred: bool = False,
                 multilabel: bool = False, serve_grid: str = "patch",
                 stride_div=None, channels_first: bool = False,
                 extract_fn: Callable = None) -> torch.Tensor:
    """The serving loop every volume inferencer runs: one volume through
    ``model_fn`` on the patch grid (``sliding_window_inference``, with its
    ``channels_first`` and ``extract_fn``), or with ``serve_grid="column"``
    on full-depth columns (``column_grid_plan``: the volume zero-padded in
    D, the pad cropped off after the stitch), then the hard prediction
    (see ``make_volume_inferencer``).  The result is channels-last either
    way: (M, N, D, H, W) class ids or (M, N, D, H, W, C)."""
    d = image.shape[1]
    if serve_grid == "column":
        pd, patch_size, overlap = column_grid_plan(
            image.shape[1:4], patch_size, overlap, stride_div)
        if pd != d:
            with span("volume.extract", device=image.device):
                image = F.pad(image, (0, 0, 0, 0, 0, 0, 0, pd - d))
    # hard predictions are invariant to the overlap-average division (a
    # positive per-voxel count shared by all classes): skip it
    out = sliding_window_inference(model_fn, image, patch_size, overlap,
                                   patch_batch, normalize=not hard_pred,
                                   channels_first=channels_first,
                                   extract_fn=extract_fn)
    c = 2 if channels_first else -1  # the class axis
    out = out.narrow(3 if channels_first else 2, 0, d)  # the column pad
    if not hard_pred:
        return out.movedim(c, -1)
    with span("volume.decide", device=out.device):
        if multilabel:
            return (out >= 0).to(torch.uint8).movedim(c, -1)
        return torch.argmax(out, dim=c).to(torch.uint8)


def make_volume_inferencer(graph: nnir.Graph, patch_batch: int = 4,
                           mode: str = "fp", heads=None,
                           hard_pred: bool = False, multilabel: bool = False,
                           compute_dtype=None, serve_grid: str = "patch",
                           stride_div=None, kernels=None, capture=None):
    """Returns infer(variables, image, patch_size, overlap): the
    counterpart of the JAX package's jitted volume inferencer.

    ``heads``: the output heads to compute (e.g. ``slice(-1, None)`` for
    final-head-only serving; the aux heads are then never evaluated).
    ``hard_pred``: return uint8 hard predictions: (M, N, D, H, W, C)
    per-class binaries when ``multilabel`` (sigmoid(x) >= 0.5 <=> x >= 0),
    else (M, N, D, H, W) argmax class ids.  ``mode``: see ``nnir.apply``
    ('fp', 'quantized' or 'fq').  ``kernels``: the ``kernels.Kernels``
    record the graph runs on (by default the wrappers).  ``compute_dtype``:
    see ``nnir.apply``; with hard predictions the heads stay in it through
    the stitch and the decision (the canvas traffic halves), else the
    logits come back as float32.  ``serve_grid="column"``: full-depth
    column serving (``column_grid_plan``), which needs ``stride_div``; the
    predictions cover the original volume.

    ``capture``: replay each chunk's patch forward from a CUDA graph
    (``CapturedForward``, ``infer.captured``), so the host's per-kernel
    launch time is paid once per capture; by default (None) on a card and
    not elsewhere.  The patch extraction and the stitch stay eager; the
    forward of a full chunk of ``patch_batch`` patches is captured once it
    comes twice in a row, and a ragged last chunk runs eagerly.  A graph
    is replayed only on the variable tensors it was captured with,
    unchanged; a new set, or one changed in place, is captured again.
    With ``capture=True`` the image must be on a CUDA device
    (``ValueError`` otherwise); a capture that fails raises.  Kernels that
    read the card from the host cannot run inside a capture: serve them
    with ``capture=False``."""
    _check_grid(serve_grid, stride_div)
    forward = _patch_forward(graph, mode, heads, hard_pred, compute_dtype,
                             kernels)
    captured = CapturedForward(forward) if capture is not False else None

    def infer(variables, image, patch_size, overlap):
        model_fn = chunk_fn(forward, captured, capture, variables,
                            image.device)
        with torch.inference_mode():
            return serve_volume(model_fn, image, patch_size, overlap,
                                patch_batch, hard_pred=hard_pred,
                                multilabel=multilabel, serve_grid=serve_grid,
                                stride_div=stride_div)

    infer.captured = captured
    return infer


def _patch_forward(graph, mode, heads, hard_pred, compute_dtype, kernels):
    """forward(variables, *inputs): ``nnir.apply`` of one patch chunk (the
    inputs of an s2d graph are the pair of its patches and parities)."""
    keep_hd = bool(hard_pred and compute_dtype is not None)

    def forward(variables, *xb):
        return nnir.apply(graph, variables, xb[0] if len(xb) == 1 else xb,
                          mode=mode, heads=heads, kernels=kernels,
                          compute_dtype=compute_dtype,
                          keep_head_dtype=keep_hd)

    return forward


def chunk_fn(forward, captured, capture, variables, device) -> Callable:
    """``serve_volume``'s ``model_fn`` for one volume on ``device``:
    ``forward(variables, *chunk)``, replayed by ``captured`` (its
    ``CapturedForward``) where ``capture`` says so (None: on a card)."""
    if capture is None:
        capture = device.type == "cuda"
    if capture:
        if device.type != "cuda":
            raise ValueError(f"a captured inferencer serves CUDA tensors, "
                             f"got one on {device}")
        captured.use(variables)
        fn = captured
    else:
        fn = functools.partial(forward, variables)
    return lambda c: fn(*c) if isinstance(c, tuple) else fn(c)


def _leaf_key(v):
    """What identifies one variable leaf for replay: a tensor by object,
    storage address and version (its in-place writes); anything else by
    value."""
    if isinstance(v, torch.Tensor):
        if v.is_inference():
            raise ValueError("a captured forward cannot track in-place "
                             "writes to tensors made under "
                             "torch.inference_mode; make the variables "
                             "outside it")
        return (id(v), v.data_ptr(), v._version)
    return (type(v).__name__, repr(v))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class CapturedForward:
    """``forward(variables, *inputs)`` replayed from one CUDA graph.

    A signature (the inputs' shapes, dtypes and devices) is captured when
    two calls in a row have it, and replayed while later calls have it; a
    call of another signature runs eagerly and leaves the graph in place.
    So a serving loop captures its full chunk of patches once (at the
    second chunk, or at the second volume of a one-chunk grid) and runs
    each volume's ragged last chunk eagerly, whatever the volume's depth;
    a variable set or a column depth that serves a single chunk is never
    captured.  One graph at a time: capturing another signature drops the
    old graph and its memory pool first.  ``captures`` counts the
    captures.  Each call sets the enclosing span's ``kind``
    (``utils/tracing.py``): ``eager``, ``capture`` (which replays its new
    graph once) or ``replay``.

    ``use(variables)`` names the variables of the following calls.  A
    graph holds the addresses of the tensors it was captured with, so it
    is replayed only while they are the same tensors with the same
    versions; otherwise the graph is dropped and the calls start over.
    The captured tensors are held, so their memory cannot pass to another
    tensor meanwhile.

    The capture follows an eager call of the same signature, which warmed
    up the libraries.  Its own increments of the counters of
    ``kernels.COUNTERS`` (the kernel wrappers' launches, K1's prologue
    quantizations and overlapped launches, the GroupNorm elements) are
    taken back and added again at each replay, so the counts are those of
    the forwards that ran.  A replay's output is a copy of the graph's
    static output."""

    def __init__(self, forward: Callable):
        self.forward = forward
        # (signature, CUDA graph, static inputs, static output, launches)
        self.graph = None
        self.captures = 0
        self._last = None  # the previous call's signature
        self._held = None  # (variables, their leaves, their keys)

    def use(self, variables):
        leaves = _leaves(variables)
        keys = [_leaf_key(v) for v in leaves]
        if self._held is None or self._held[2] != keys:
            self.graph = self._last = None
            self._held = (variables, leaves, keys)

    def __call__(self, *inputs):
        if self._held is None:
            raise ValueError("CapturedForward.use(variables) comes first")
        sig = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
        last, self._last = self._last, sig
        if self.graph is None or self.graph[0] != sig:
            if sig != last:
                annotate(kind="eager")
                return self.forward(self._held[0], *inputs)
            self.graph = None  # its pool goes before the next one is made
            self.graph = self._capture(sig, inputs)
            annotate(kind="capture")
        else:
            annotate(kind="replay")
        _, graph, static_in, static_out, delta = self.graph
        for s, t in zip(static_in, inputs):
            s.copy_(t)
        graph.replay()
        for (owner, attr), n in zip(COUNTERS, delta):
            setattr(owner, attr, getattr(owner, attr) + n)
        return static_out.clone()

    def _capture(self, sig, inputs):
        static_in = [t.clone() for t in inputs]
        before = [getattr(owner, attr) for owner, attr in COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                static_out = self.forward(self._held[0], *static_in)
        finally:
            delta = [getattr(owner, attr) - b
                     for (owner, attr), b in zip(COUNTERS, before)]
            for (owner, attr), b in zip(COUNTERS, before):
                setattr(owner, attr, b)
        self.captures += 1
        return sig, graph, static_in, static_out, delta
