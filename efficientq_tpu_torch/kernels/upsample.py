"""K5: trilinear upsampling by integer factors, with the skip add fused in.

``upsample_trilinear3d(x, scale_factor, skip, channels_first)`` is
``ops.upsample3d`` (or ``ops.upsample3d_cf`` for an NCDHW tensor) followed
by ``+ skip`` where a skip is given: half-pixel centres
(``align_corners=False``), the factors integers per axis.  It replaces no
Pallas kernel (the JAX package resizes with ``jax.image.resize``); in the
port it takes the place of aten's ``upsample_trilinear3d`` and of the
elementwise add after it on the serving path, where
``ptq/deploy.py::upsample_serving`` routes the graph's upsamples to it.

For CUDA tensors it launches the hand-written kernel
``csrc/upsample3d.cu`` (its header says what bounds it and how its grid is
laid out) or raises; for tensors on the CPU it takes the plain PyTorch
version ``upsample_trilinear3d_reference``.  Each launch adds one to
``upsample_trilinear3d.launches``.  The kernel rounds as the plain pair
does: the interpolation in float32, rounded once to x's type, then the skip
added and the sum rounded to the promoted type.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import ops
from . import on_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)


def upsample_trilinear3d_reference(x, scale_factor, skip=None,
                                   channels_first: bool = False):
    """Plain K5: ``F.interpolate(mode="trilinear", align_corners=False)``
    through ``ops.upsample3d`` (NDHWC) or ``ops.upsample3d_cf`` (NCDHW),
    then ``+ skip``."""
    up = (ops.upsample3d_cf if channels_first else ops.upsample3d)(
        x, scale_factor)
    return up if skip is None else up + skip


def upsample_trilinear3d(x, scale_factor, skip=None,
                         channels_first: bool = False):
    """Trilinear upsampling of x by the integer ``scale_factor`` (one int or
    a (D, H, W) triple), plus ``skip`` if given, in one kernel.

    x: (N, D, H, W, C), or (N, C, D, H, W) with ``channels_first``;
    float32 or bfloat16.  skip: None or a float32 / bfloat16 tensor of the
    output's shape.  Returns the upsampled tensor (plus skip) in x's
    layout, of x's type promoted with the skip's."""
    if x.device.type == "cpu":
        return upsample_trilinear3d_reference(x, scale_factor, skip,
                                              channels_first)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    return _launch(x, ops.triple(scale_factor), skip, bool(channels_first))


upsample_trilinear3d.launches = 0


class _Div(ctypes.Structure):
    """A divisor as ``Div`` of ``csrc/upsample3d.cu``: n / d =
    (umulhi(n, magic) + n) >> shift for n, d < 2**31."""
    _fields_ = [("magic", ctypes.c_uint), ("shift", ctypes.c_uint),
                ("d", ctypes.c_uint)]


def _divider(d: int) -> _Div:
    shift = max(0, (d - 1).bit_length())
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return _Div(magic, shift, d)


class _K5Call(ctypes.Structure):
    """One K5 call's shape, laid out as ``K5Call`` of
    ``csrc/upsample3d.cu``."""
    _fields_ = [("planes", ctypes.c_uint), ("plane", ctypes.c_uint),
                ("di", _I), ("hi", _I), ("wi", _I), ("ho", _I), ("wo", _I),
                ("c", _I), ("sd", ctypes.c_float), ("sh", ctypes.c_float),
                ("sw", ctypes.c_float), ("copy", _I), ("groups", _Div),
                ("wout", _Div), ("dout", _Div)]


@functools.lru_cache(maxsize=None)
def _lib():
    from . import build

    fn = build.load("upsample3d.cu").upsample3d_launch
    fn.argtypes = [_P, _P, _P, ctypes.POINTER(_K5Call), _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=1024)
def _k5_call(shape, f, cf: bool, vec: int) -> _K5Call:
    """The launch's ``_K5Call`` for input ``shape`` (in its layout), factors
    ``f`` and ``vec`` elements a thread.  Each scale is float32(in) /
    float32(out), as aten's ``compute_scales_value`` divides.  The
    planes' count, a plane's threads and the elements of an input or
    output plane stay below 2**31 (the kernel's offsets across planes are
    64-bit)."""
    if cf:
        n, c, d, h, w = shape
        planes, channels = n * c * d * f[0], 1
    else:
        n, d, h, w, c = shape
        planes, channels = n * d * f[0], c
    out = (d * f[0], h * f[1], w * f[2])
    groups = (out[2] if cf else c) // vec
    plane = out[1] * groups * (1 if cf else out[2])
    sizes = (planes, plane, h * w * channels, out[1] * out[2] * channels)
    if max(sizes) >= 2 ** 31:
        raise ValueError(f"K5: input {shape} x {f} has a count past 2**31 "
                         f"(planes, a plane's threads, an input plane, an "
                         f"output plane: {sizes})")
    scales = [float(np.float32(i) / np.float32(o))
              for i, o in zip((d, h, w), out)]
    return _K5Call(planes, plane, d, h, w, out[1], out[2], channels, *scales,
                   int(f == (1, 1, 1)), _divider(groups), _divider(out[2]),
                   _divider(out[0]))


def _vec(units: int, tensors, out_dtype, cf: bool) -> int:
    """Elements a thread along C (NDHWC) or W_out (NCDHW): 16 bytes of a
    bfloat16 output (8), 4, then, along C, 3 or 2 (the head's 3 classes),
    or 1, as ``units`` and the pointers' 16-byte alignment allow."""
    if any(t.data_ptr() % 16 for t in tensors):
        return 1
    if out_dtype == torch.bfloat16 and units % 8 == 0:
        return 8
    for v in (4,) if cf else (4, 3, 2):
        if units % v == 0:
            return v
    return 1


def _launch(x, f, skip, cf: bool):
    """K5 on the card.  Lean on the host, so a call can be captured in a
    CUDA graph: the shape passed as one cached struct, the output allocated
    here, nothing read back."""
    if x.dim() != 5 or x.dtype not in _DTYPES:
        raise ValueError(f"K5 takes a 5-d float32 or bfloat16 x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if min(f) < 1:
        raise ValueError(f"K5 upsamples by integer factors >= 1, got {f}")
    x = x.contiguous()
    index = x.get_device()
    if cf:
        n, c, d, h, w = x.shape
        out_shape = (n, c, d * f[0], h * f[1], w * f[2])
    else:
        n, d, h, w, c = x.shape
        out_shape = (n, d * f[0], h * f[1], w * f[2], c)
    out_dtype = x.dtype
    skip_kind = 0
    if skip is not None:
        if (skip.dtype not in _DTYPES or tuple(skip.shape) != out_shape
                or skip.get_device() != index):
            raise ValueError(f"skip {skip.dtype} {tuple(skip.shape)} on "
                             f"{skip.device} does not fit the upsampled "
                             f"{out_shape} on {x.device}")
        skip = skip.contiguous()
        skip_kind = 1 if skip.dtype == torch.float32 else 2
        out_dtype = torch.promote_types(x.dtype, skip.dtype)
    y = torch.empty(out_shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    operands = [t for t in (x, skip, y) if t is not None]
    vec = _vec(out_shape[4] if cf else c, operands, out_dtype, cf)
    call = _k5_call(tuple(x.shape), f, cf, vec)
    rc = on_device(index, _lib(), x.data_ptr(),
                    None if skip is None else skip.data_ptr(), y.data_ptr(),
                    call, int(cf), int(x.dtype == torch.bfloat16), skip_kind,
                    vec)
    if rc != 0:
        raise RuntimeError(
            f"K5 launch failed: cudaError_t {rc} (x {x.dtype} "
            f"{tuple(x.shape)}, factors {f}, channels_first {cf}, skip "
            f"{skip_kind}, vec {vec})")
    upsample_trilinear3d.launches += 1
    return y
