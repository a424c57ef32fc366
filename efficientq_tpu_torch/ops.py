"""3D NN primitives in NDHWC layout (PyTorch).

Counterpart of the JAX package's ``ops.py``.  Every op takes and returns
``(N, D, H, W, C)`` tensors, and conv kernels are DHWIO, as in the JAX
package.  A contiguous NDHWC tensor is exactly a logical NCDHW tensor in
``torch.channels_last_3d`` memory format, so ``x.permute(0, 4, 1, 2, 3)``
hands it to ``F.conv3d`` / ``F.max_pool3d`` / ``F.interpolate`` without a
copy.

Float convs run in full float32: ``exact_f32`` turns TF32 off for cuDNN
convs and cuBLAS matmuls (cuDNN's f32 conv defaults to TF32; the JAX
reference on the CPU is exact f32).  ``conv_precision(tf32=True)`` allows
TF32 instead: the FP train step's choice (README), the counterpart of the
JAX trainer's default precision, which leaves the passes to the backend.

The training ops (``batch_norm_train``, ``dropout3d``) and ``relu`` pass
gradients as the JAX package's do: ``relu`` is ``maximum(x, 0)``, whose
gradient at a tie is 0.5 (``torch.clamp_min`` would pass 1).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IntOr3 = Union[int, Sequence[int]]


def triple(v: IntOr3) -> Tuple[int, int, int]:
    if isinstance(v, (int, np.integer)):
        return (int(v),) * 3
    t = tuple(int(x) for x in v)
    if len(t) == 1:
        return t * 3
    assert len(t) == 3, f"expected 3-tuple, got {v}"
    return t


@contextlib.contextmanager
def conv_precision(tf32: bool):
    """Float32 convs and matmuls inside the block with TF32 allowed or not,
    restoring the caller's settings on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def exact_f32():
    """Full-float32 convs and matmuls inside the block (TF32 off)."""
    return conv_precision(False)


def ndhwc_to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def ncdhw_to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def oidhw_to_dhwio(k):
    """torch conv3d kernel (O, I, kD, kH, kW) -> DHWIO."""
    return k.permute(2, 3, 4, 1, 0)


def dhwio_to_oidhw(k):
    return k.permute(4, 3, 0, 1, 2)


def _ndhwc_out(y_ncdhw):
    # a channels_last_3d result comes back as a contiguous NDHWC view
    return ncdhw_to_ndhwc(y_ncdhw).contiguous()


def conv3d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: IntOr3 = 1,
           padding: IntOr3 = 0, dilation: IntOr3 = 1,
           groups: int = 1) -> torch.Tensor:
    """3D convolution, NDHWC activations x DHWIO kernel -> NDHWC, in the
    dtype of the operands (callers wrap it in ``exact_f32`` for float32).
    At a compute dtype (bfloat16 operands) this is cuDNN's bf16 conv on a
    card: float32 accumulation, one rounding to bfloat16, as the JAX
    package's conv at ``compute_dtype``; the caller adds the bias in that
    dtype."""
    y = F.conv3d(ndhwc_to_ncdhw(x), dhwio_to_oidhw(kernel), None,
                 triple(stride), triple(padding), triple(dilation), groups)
    y = _ndhwc_out(y)
    if bias is not None:
        y = y + bias
    return y


def conv3d_ncdhw_out(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1x1x1 conv of NDHWC activations with a DHWIO kernel, emitted as a
    contiguous NCDHW tensor (the channels-first serving head)."""
    return F.conv3d(ndhwc_to_ncdhw(x), dhwio_to_oidhw(kernel)).contiguous()


def _pool(pool, x: torch.Tensor, kernel: IntOr3, stride) -> torch.Tensor:
    """A VALID 3-D pool of NDHWC ``x``; an extent below its window gives an
    empty output, as XLA's reduce_window does (torch raises)."""
    k = triple(kernel)
    s = triple(stride) if stride is not None else k
    if any(e < w for e, w in zip(x.shape[1:4], k)):
        out = [max(0, (e - w) // t + 1)
               for e, w, t in zip(x.shape[1:4], k, s)]
        return x.new_empty((x.shape[0], *out, x.shape[-1]))
    return _ndhwc_out(pool(ndhwc_to_ncdhw(x), k, s))


def max_pool3d(x: torch.Tensor, kernel: IntOr3,
               stride: Optional[IntOr3] = None) -> torch.Tensor:
    """Max pooling over D, H, W (VALID, like torch MaxPool3d padding=0)."""
    return _pool(F.max_pool3d, x, kernel, stride)


def avg_pool3d(x: torch.Tensor, kernel: IntOr3,
               stride: Optional[IntOr3] = None) -> torch.Tensor:
    """Mean over each D, H, W window (VALID, no padding)."""
    return _pool(F.avg_pool3d, x, kernel, stride)


def upsample3d(x: torch.Tensor, scale_factor: IntOr3) -> torch.Tensor:
    """Trilinear upsampling by integer factors, half-pixel centres
    (``align_corners=False``), as ``jax.image.resize`` does it."""
    f = triple(scale_factor)
    n, d, h, w, c = x.shape
    y = F.interpolate(ndhwc_to_ncdhw(x), size=(d * f[0], h * f[1], w * f[2]),
                      mode="trilinear", align_corners=False)
    return _ndhwc_out(y)


def upsample3d_cf(x: torch.Tensor, scale_factor: IntOr3) -> torch.Tensor:
    """Trilinear upsampling of an NCDHW tensor (the channels-first serving
    tail, see nnir ``upsample_cf``); same half-pixel convention as
    ``upsample3d``."""
    f = triple(scale_factor)
    n, c, d, h, w = x.shape
    return F.interpolate(x, size=(d * f[0], h * f[1], w * f[2]),
                         mode="trilinear", align_corners=False)


def batch_norm(x, scale, bias, mean, var, eps: float = 1e-5):
    """Inference-mode batch norm over the channel (last) axis."""
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * scale + bias


def batch_norm_train(x, scale, bias, running_mean, running_var,
                     momentum: float = 0.1, eps: float = 1e-5):
    """Training-mode batch norm over N, D, H, W: normalize with the biased
    batch variance, update the running stats with the unbiased one (torch
    semantics), in the JAX version's order of operations (the mean, then
    the mean of squared deviations).  Returns (y, new_running_mean,
    new_running_var)."""
    axes = (0, 1, 2, 3)
    batch_mean = x.mean(dim=axes)
    batch_var = (x - batch_mean).square().mean(dim=axes)
    count = x.shape[0] * x.shape[1] * x.shape[2] * x.shape[3]
    unbiased = batch_var * (count / max(count - 1, 1))
    y = (x - batch_mean) * torch.rsqrt(batch_var + eps) * scale + bias
    new_mean = (1.0 - momentum) * running_mean + momentum * batch_mean
    new_var = (1.0 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


def dropout3d(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """Channelwise (Dropout3d) dropout of NDHWC ``x``: whole (sample,
    channel) volumes zeroed with probability ``rate``, survivors scaled by
    1/(1-rate).  The (N, 1, 1, 1, C) keep mask is drawn on the host from
    ``generator`` (a CPU ``torch.Generator``), so a seed gives the same
    mask on every device."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0], 1, 1, 1, x.shape[-1]), generator=generator)
    mask = (u < keep).to(x.device, non_blocking=True)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def relu(x: torch.Tensor) -> torch.Tensor:
    """``maximum(x, 0)``: the JAX package's relu, value and gradient (0.5
    at a tie).  The zero is a 0-d CPU tensor, a scalar to a CUDA op, so no
    fill is launched."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype))


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5):
    """LayerNorm over the channels of each voxel, in float32 with K6's
    arithmetic: float64 statistics (the mean and the biased variance)
    rounded once to float32, as the mean and the channel scales gamma /
    sqrt(var + eps) (1 / sqrt(var + eps) without an affine), then ((x -
    mean) * a) + beta step by step in float32.  Adds the elements it
    normalizes to ``layer_norm.elements``."""
    layer_norm.elements += x.numel()
    xd = x.to(torch.float64)
    var, mean = torch.var_mean(xd, dim=-1, correction=0, keepdim=True)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    a = (rstd if scale is None else scale.to(torch.float64) * rstd).to(
        torch.float32)
    y = (x.to(torch.float32) - mean.to(torch.float32)) * a
    return y if bias is None else y + bias.to(torch.float32)


layer_norm.elements = 0


def depth_to_space(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(N, D, H, W, f^3 C) -> (N, fD, fH, fW, C): channel t C + o of voxel
    (z, y, x) to voxel (f z + a, f y + b, f x + c), t = (a f + b) f + c."""
    n, d, h, w, c = x.shape
    f = int(factor)
    o = c // f ** 3
    y = x.reshape(n, d, h, w, f, f, f, o).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(n, d * f, h * f, w * f, o)


# MONAI's v0.9 PatchMerging sub-grids, x0 ... x7 in its source's order:
# (d, h, w) offsets, (0, 1, 0) and (0, 0, 1) twice and (1, 1, 0), (0, 1,
# 1) never
PATCH_MERGE_OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
                       (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))


def patch_merge(x: torch.Tensor) -> torch.Tensor:
    """MONAI's v0.9 ``PatchMerging`` gather of (N, D, H, W, C): odd extents
    padded with zeros at their end, then the sub-grids of
    ``PATCH_MERGE_OFFSETS`` joined along the channels: (N, D/2, H/2, W/2,
    8C)."""
    d, h, w = x.shape[1:4]
    if d % 2 or h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    return torch.cat([x[:, a::2, b::2, c::2, :]
                      for a, b, c in PATCH_MERGE_OFFSETS], dim=-1)
