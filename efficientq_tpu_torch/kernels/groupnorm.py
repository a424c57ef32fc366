"""K6: GroupNorm for serving, with the ReLU and the next conv's activation
quantizer fused in.

``group_norm(x, gamma, beta, num_groups, eps, relu, quant_alpha,
quant_qlvl)`` normalizes NDHWC ``x`` per (sample, group) over the group's
channels and every voxel, with the affine ``gamma``, ``beta``, and writes
either the consuming conv's int8 activation codes
``round(clip(y / quant_alpha, 0, 1) * (quant_qlvl - 1))`` (the clip at 0
is the ReLU), or y, ReLU'd with ``relu``, in x's type.  It replaces no
Pallas kernel (the JAX package has no GroupNorm); in the port it serves
SegResNet's GN -> ReLU -> conv, where ``ptq/deploy.py::group_norm_serving``
routes the graph's ``group_norm`` nodes to it.

The statistics are float64: the mean and the biased variance of the
group, rounded once to float32 as ``mean`` and as the channel scales
``a_c = gamma_c / sqrt(var + eps)``, then ``y = ((x - mean) * a_c) +
beta_c`` step by step in float32.  The plain version
``group_norm_reference`` is that arithmetic in PyTorch (two float64
passes), on any device; it is also what an undeployed ``group_norm`` node
computes (``nnir.eval_node``), so deployment changes no value.  The kernel
(``csrc/groupnorm.cu``, its header says what bounds it) combines per-block
float64 statistics in another order, and equals the plain version where
the float64 values do not straddle a float32 rounding boundary.

One channel a group (``num_groups`` = C: InstanceNorm, as SwinUNETR's
UnetResBlocks have it, with gamma 1 and beta 0 where the norm has no
affine) takes a statistics pass of its own (``effq_group_norm_ch_launch``)
for any C up to 1024, powers of two or not; the other calls take powers of
two, at most 32 groups.

For CUDA tensors ``group_norm`` launches the kernel or raises; for tensors
on the CPU it takes the plain version.  Each launch adds one to
``group_norm.launches``.  ``group_norm.elements`` counts the elements that
the graph's GroupNorm nodes normalized, whichever implementation ran
(``nnir.eval_node`` adds to it; a CUDA-graph replay adds its forward's
count, as ``eval/sliding.py::CapturedForward`` does for the launches).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import on_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's block (csrc/groupnorm.cu): threads, and vectors a thread
# holds in the statistics pass
_THREADS, _ITEMS, _GMAX = 256, 8, 32
_CMAX = 1024  # channels of a one-channel-a-group call


def group_norm_reference(x, gamma, beta, num_groups: int, eps: float = 1e-5,
                         relu: bool = False, quant_alpha=None,
                         quant_qlvl: int = 0):
    """Plain K6, with the wrapper's signature, on any device: float64
    statistics (two passes, the biased variance), rounded to float32 as
    the mean and the channel scales gamma / sqrt(var + eps), then ((x -
    mean) * a) + beta in float32; the codes of that (``quant_qlvl``) or
    it, ReLU'd with ``relu``, in x's type.  Differentiable (the training
    forward)."""
    n, c = x.shape[0], x.shape[-1]
    g = int(num_groups)
    xd = x.reshape(n, -1, g, c // g).to(torch.float64)
    mean = xd.mean(dim=(1, 3))
    var = (xd - mean[:, None, :, None]).square().mean(dim=(1, 3))
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    a = (gamma.to(torch.float64).reshape(1, g, c // g)
         * rstd[:, :, None]).to(torch.float32)
    xg = x.to(torch.float32).reshape(n, -1, g, c // g)
    y = ((xg - mean.to(torch.float32)[:, None, :, None]) * a[:, None]
         + beta.to(torch.float32).reshape(g, c // g)).reshape(x.shape)
    if quant_qlvl:
        alpha = torch.as_tensor(quant_alpha, dtype=torch.float32,
                                device=x.device)
        return torch.round(torch.clamp(y / alpha, 0.0, 1.0)
                           * (quant_qlvl - 1)).to(torch.int8)
    if relu:
        y = torch.maximum(y, torch.zeros((), dtype=y.dtype))
    return y.to(x.dtype)


def group_norm(x, gamma, beta, num_groups: int, eps: float = 1e-5,
               relu: bool = False, quant_alpha=None, quant_qlvl: int = 0):
    """GroupNorm of NDHWC ``x`` (float32 or bfloat16) over ``num_groups``
    groups of its channels, the affine ``gamma``, ``beta`` (C,), in one
    kernel: the int8 codes of the ReLU'd result on the ``quant_qlvl``-level
    grid of range ``quant_alpha`` when ``quant_qlvl``, else the result
    (ReLU'd with ``relu``) in x's type."""
    if x.device.type == "cpu":
        return group_norm_reference(x, gamma, beta, num_groups, eps, relu,
                                    quant_alpha, quant_qlvl)
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    return _launch(x, gamma, beta, int(num_groups), float(eps), bool(relu),
                   quant_alpha, int(quant_qlvl))


group_norm.launches = 0
group_norm.elements = 0


@functools.lru_cache(maxsize=None)
def _lib():
    from . import build

    lib = build.load("groupnorm.cu")
    fn = lib.effq_group_norm_launch
    fn.argtypes = [_P] * 8 + [_L, _L, _I, _I, ctypes.c_double] + [_I] * 4 \
        + [_P]
    fn.restype = _I
    ch = lib.effq_group_norm_ch_launch
    ch.argtypes = [_P] * 8 + [_L, _L, _I, ctypes.c_double] + [_I] * 4 + [_P]
    ch.restype = _I
    return fn, ch


def _pow2(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def _plan(shape, num_groups: int):
    """(vector width, statistics blocks a sample, one channel a group) of
    a call on NDHWC ``shape``: V channels a thread, the most of 4, 2, 1
    that divides the group's channels (of C, one channel a group); a
    ValueError for a shape the kernel does not take."""
    n, c = shape[0], shape[-1]
    g = num_groups
    per = 1
    for s in shape[1:]:
        per *= int(s)
    pow2 = _pow2(c) and g > 0 and c % g == 0 and _pow2(c // g)
    if g == c and not (pow2 and g <= _GMAX):
        vec = 4 if c % 4 == 0 else (2 if c % 2 == 0 else 1)
        if c > _CMAX or c // vec > _THREADS:
            raise ValueError(f"K6 takes at most {_CMAX} channels at one a "
                             f"group, got {c}")
        if not 1 <= n <= 65535:
            raise ValueError(f"K6 takes 1 to 65535 samples, got {n}")
        rows = _THREADS // (c // vec) * _ITEMS
        return vec, -(-(per // c) // rows), True
    if not pow2:
        raise ValueError(f"K6 takes channels and channels a group that are "
                         f"powers of two, got C = {c}, G = {g}")
    if g > _GMAX:
        raise ValueError(f"K6 takes at most {_GMAX} groups, got {g}")
    if not 1 <= n <= 65535:
        raise ValueError(f"K6 takes 1 to 65535 samples, got {n}")
    cg = c // g
    vec = 4 if cg % 4 == 0 else (2 if cg % 2 == 0 else 1)
    if c > _THREADS * vec:
        raise ValueError(f"K6 takes at most {_THREADS * vec} channels at "
                         f"{c // g} a group, got {c}")
    span = _THREADS * vec * _ITEMS
    return vec, -(-per // span), False


def _launch(x, gamma, beta, g, eps, relu, quant_alpha, qlvl):
    """K6 on the card.  Lean on the host, so a call can be captured in a
    CUDA graph: outputs and scratch allocated here, nothing read back."""
    if x.dim() < 3 or x.dtype not in _DTYPES:
        raise ValueError(f"K6 takes an (N, ..., C) float32 or bfloat16 x, "
                         f"got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    n, c = x.shape[0], x.shape[-1]
    vec, blocks, per_channel = _plan(tuple(x.shape), g)
    per = x[0].numel()
    if x.data_ptr() % (vec * x.element_size()):
        x = x.clone()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    gamma = gamma.to(**f32).contiguous()
    beta = beta.to(**f32).contiguous()
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} must be ({c},)")
    alpha = None
    if qlvl:
        alpha = (quant_alpha.to(**f32).reshape(1)
                 if isinstance(quant_alpha, torch.Tensor)
                 else torch.full((1,), float(quant_alpha), **f32))
    out = torch.empty(x.shape, device=dev,
                      dtype=torch.int8 if qlvl else x.dtype)
    part = torch.empty((n, blocks, g, 3), dtype=torch.float64, device=dev)
    mean = torch.empty((n, g), **f32)
    scale = torch.empty((n, c), **f32)
    if x.numel() == 0:
        return out
    ptrs = (x.data_ptr(), out.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if alpha is None else alpha.data_ptr(), part.data_ptr(),
            mean.data_ptr(), scale.data_ptr(), n, per)
    flags = (int(relu), qlvl, int(x.dtype == torch.bfloat16), vec)
    if per_channel:
        rc = on_device(x.get_device(), _lib()[1], *ptrs, c, eps, *flags)
    else:
        rc = on_device(x.get_device(), _lib()[0], *ptrs, c, g, eps, *flags)
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError_t {rc} (x {x.dtype} "
                           f"{tuple(x.shape)}, groups {g}, vec {vec}, codes "
                           f"{qlvl})")
    group_norm.launches += 1
    return out
