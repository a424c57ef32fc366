"""Hand-written CUDA kernels (sources in ../csrc) and the graph passes that
route the deployed graph to them.  Counterpart of the JAX package's
``pallas/``.

``Kernels`` is the one record of the kernels a graph runs on: K1-K7, each
entry a function with its wrapper's signature.  ``nnir.eval_node`` reads
its entries, and every inferencer takes one (``kernels=``).  It has three
instances: ``WRAPPERS`` (the default; each wrapper launches its kernel on
CUDA tensors and runs its plain version on CPU ones), ``REFERENCES`` (the
plain ``*_reference`` versions, on any device) and ``library.OPS`` (the
registered ``effq::*`` operators that an exported program carries).
``COUNTERS`` lists the counters that the wrappers keep, which a CUDA-graph
replay adds back (``eval/sliding.py::CapturedForward``).

The helpers ``on_device``, ``alpha_arg`` and ``vector_arg`` prepare the
arguments of a ctypes launch; every kernel module uses them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import ops as _ops

_F32 = dict(dtype=torch.float32)


class Kernels(NamedTuple):
    """The kernels of a serving graph, by the nodes they run."""

    conv3x3_int8: Callable  # K1: flagged int8 3^3 convs
    stem_conv: Callable  # K2: the s2d stem (``stem_s2d`` nodes)
    int8_matmul: Callable  # K3: flagged int8 1x1 convs
    qact_matmul: Callable  # K4: flagged fake-quant 1x1 convs
    upsample: Callable  # K5: ``upsample_k5`` nodes
    group_norm: Callable  # K6: ``group_norm_k6`` nodes
    window_attention: Callable  # K7: ``window_attention`` nodes


def on_device(index, fn, *args):
    """fn(*args, the current stream of CUDA device ``index``), with the
    device made current only when it is not."""
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def vector_arg(v, n, like, what):
    """A contiguous (n,) float32 vector on the device of tensor ``like``, or
    None: ``v`` itself when it is one already."""
    if v is None:
        return None
    if (isinstance(v, torch.Tensor) and v.dtype == torch.float32
            and v.get_device() == like.get_device() and v.shape == (n,)
            and v.is_contiguous()):
        return v
    v = torch.as_tensor(v, device=like.device, **_F32)
    if v.dim() == 0:
        v = v.expand(n)
    if tuple(v.shape) != (n,):
        raise ValueError(f"{what} {tuple(v.shape)} != ({n},)")
    return v.contiguous()


def alpha_arg(alpha, like):
    """(float32 tensor or None, value) of the activation clip: a one-element
    tensor on the device of tensor ``like`` passes by pointer (its value
    stays on the card), anything else by value, so no tensor is made from a
    number."""
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1:
            raise ValueError(f"alpha_act {tuple(alpha.shape)}: one value")
        if alpha.get_device() == like.get_device():
            return (alpha if alpha.dtype == torch.float32 else alpha.float(),
                    0.0)
    return None, float(alpha)


# the kernel modules import the helpers above from this package
from . import (groupnorm, qconv3d, qmatmul, stem, upsample,  # noqa: E402
               window_attention)
from .qmatmul import (fused_int8_matmul, fused_qact_matmul,  # noqa: E402,F401
                      qconv1x1_ndhwc, to_pallas_inference)

WRAPPERS = Kernels(qconv3d.qconv3x3_int8_ndhwc, stem.stem_s2d_conv,
                   qmatmul.fused_int8_matmul, qmatmul.fused_qact_matmul,
                   upsample.upsample_trilinear3d, groupnorm.group_norm,
                   window_attention.window_attention)
REFERENCES = Kernels(qconv3d.qconv3x3_int8_ndhwc_reference,
                     stem.stem_s2d_conv_reference,
                     qmatmul.fused_int8_matmul_reference,
                     qmatmul.fused_qact_matmul_reference,
                     upsample.upsample_trilinear3d_reference,
                     groupnorm.group_norm_reference,
                     window_attention.window_attention_reference)
# (owner, attribute) of every count the wrappers keep: each launch, K1's
# prologue quantizations and overlapped launches, the elements the
# GroupNorm and LayerNorm nodes normalize, the (sample, window, head)
# attentions of the window-attention nodes and K7's tiles' scores
COUNTERS = tuple((fn, "launches") for fn in WRAPPERS) + (
    (qconv3d.qconv3x3_int8_ndhwc, "prologue_quant_launches"),
    (qconv3d.qconv3x3_int8_ndhwc, "overlapped_launches"),
    (groupnorm.group_norm, "elements"),
    (_ops.layer_norm, "elements"),
    (window_attention.window_attention, "window_heads"),
    (window_attention.window_attention, "tile_scores"))
