"""K1-K7 as registered operators (``torch.library.custom_op``), so that an
exported program (``torch.export``, ``export.py``) can carry them.

    effq::qconv3x3_int8         K1, kernels/qconv3d.py
    effq::stem_s2d_conv         K2, kernels/stem.py
    effq::fused_int8_matmul     K3, kernels/qmatmul.py
    effq::fused_qact_matmul     K4, kernels/qmatmul.py
    effq::upsample_trilinear3d  K5, kernels/upsample.py
    effq::group_norm            K6, kernels/groupnorm.py
    effq::window_attention      K7, kernels/window_attention.py

Each op's CUDA implementation is its kernel's wrapper (which counts the
launch) and its CPU implementation the plain PyTorch version; a fake
(meta) implementation gives the outputs' shapes and dtypes, so export can
trace through them without running them.  An op schema takes tensors,
numbers and flags only: the wrappers' optional epilogue arguments are
flattened into tensors, ints and bools, and a thin adapter of the
wrapper's own signature (``qconv3x3_int8`` ...) calls the op; ``OPS`` is
the ``Kernels`` record of these adapters.  The eager serving path keeps
calling the wrappers directly (no dispatcher between them and the card).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor

from . import (Kernels, groupnorm, qconv3d, qmatmul, stem, upsample,
               window_attention as wattn)

_F32 = torch.float32


def _dtype(bf16: bool):
    return torch.bfloat16 if bf16 else _F32


def _scalar(v, like: Tensor) -> Tensor:
    """A number or tensor as a float32 tensor on ``like``'s device."""
    if isinstance(v, Tensor):
        return v.to(device=like.device, dtype=_F32)
    return torch.full((), float(v), dtype=_F32, device=like.device)


# K1 -------------------------------------------------------------------

def _k1_args(x, w_codes, bias, alpha_act, scale, qlvl_act, dilation,
             residual, quant_alpha, quant_qlvl, x_quantized, residual_relu,
             pool, out_bf16, act_k):
    """The K1 wrapper's keyword arguments from the operator's."""
    return dict(x=x, w_codes=w_codes, bias=bias, alpha_act=alpha_act,
                scale=scale, qlvl_act=qlvl_act, dilation=dilation,
                residual=residual,
                quant_alpha=quant_alpha if quant_qlvl else None,
                quant_qlvl=quant_qlvl, x_quantized=x_quantized,
                residual_relu=residual_relu, pool=pool,
                out_dtype=_dtype(out_bf16), act_k=act_k)


def _k1_out(res, pool: bool, y_like: Tensor):
    if pool:
        return res[0], res[1]
    return res, y_like.new_empty((0,))


@torch.library.custom_op("effq::qconv3x3_int8", mutates_args=(),
                         device_types="cuda")
def _qconv3x3_int8(x: Tensor, w_codes: Tensor, bias: Optional[Tensor],
                   alpha_act: Tensor, scale: Tensor, qlvl_act: int,
                   dilation: int, residual: Optional[Tensor],
                   quant_alpha: Tensor, quant_qlvl: int, x_quantized: bool,
                   residual_relu: bool, pool: bool,
                   w_packed: Optional[Tensor], out_bf16: bool,
                   act_k: int = 0) -> Tuple[Tensor, Tensor]:
    res = qconv3d.qconv3x3_int8_ndhwc(
        w_packed=w_packed,
        **_k1_args(x, w_codes, bias, alpha_act, scale, qlvl_act, dilation,
                   residual, quant_alpha, quant_qlvl, x_quantized,
                   residual_relu, pool, out_bf16, act_k))
    return _k1_out(res, pool, x)


@_qconv3x3_int8.register_kernel("cpu")
def _(x, w_codes, bias, alpha_act, scale, qlvl_act, dilation, residual,
      quant_alpha, quant_qlvl, x_quantized, residual_relu, pool, w_packed,
      out_bf16, act_k=0):
    res = qconv3d.qconv3x3_int8_ndhwc_reference(
        **_k1_args(x, w_codes, bias, alpha_act, scale, qlvl_act, dilation,
                   residual, quant_alpha, quant_qlvl, x_quantized,
                   residual_relu, pool, out_bf16, act_k))
    return _k1_out(res, pool, x)


@_qconv3x3_int8.register_fake
def _(x, w_codes, bias, alpha_act, scale, qlvl_act, dilation, residual,
      quant_alpha, quant_qlvl, x_quantized, residual_relu, pool, w_packed,
      out_bf16, act_k=0):
    n, d, h, w, _ = x.shape
    o = w_codes.shape[-1]
    dt = torch.int8 if quant_qlvl else _dtype(out_bf16)
    y = x.new_empty((n, d, h, w, o), dtype=dt)
    if pool:
        return y, x.new_empty((n, d // 2, h // 2, w // 2, o),
                              dtype=_dtype(out_bf16))
    return y, x.new_empty((0,), dtype=x.dtype)


def qconv3x3_int8(x, w_codes, bias, alpha_act, scale, qlvl_act: int,
                  dilation: int = 1, residual=None, quant_alpha=None,
                  quant_qlvl: int = 0, x_quantized: bool = False,
                  residual_relu: bool = False, pool: bool = False,
                  w_packed=None, out_dtype=torch.float32, act_k: int = 0):
    """``effq::qconv3x3_int8`` with the K1 wrapper's signature (``OPS``'s
    ``conv3x3_int8``; the unsigned grid of the quant epilogue)."""
    y, pooled = torch.ops.effq.qconv3x3_int8(
        x, w_codes, bias, _scalar(alpha_act, x), _scalar(scale, x),
        int(qlvl_act), int(dilation), residual,
        _scalar(quant_alpha if quant_qlvl else 0.0, x), int(quant_qlvl),
        bool(x_quantized), bool(residual_relu), bool(pool), w_packed,
        out_dtype == torch.bfloat16, int(act_k))
    return (y, pooled) if pool else y


# K2 -------------------------------------------------------------------

@torch.library.custom_op("effq::stem_s2d_conv", mutates_args=(),
                         device_types="cuda")
def _stem_s2d_conv(x: Tensor, parities: Tensor, w_even: Tensor,
                   w_odd: Tensor, bias: Tensor, alpha_next: Tensor,
                   qlvl_next: int, out_bf16: bool,
                   w_packed: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    return stem.stem_s2d_conv(x, parities, w_even, w_odd, bias, alpha_next,
                              qlvl_next, _dtype(out_bf16), w_packed)


@_stem_s2d_conv.register_kernel("cpu")
def _(x, parities, w_even, w_odd, bias, alpha_next, qlvl_next, out_bf16,
      w_packed):
    return stem.stem_s2d_conv_reference(x, parities, w_even, w_odd, bias,
                                        alpha_next, qlvl_next,
                                        _dtype(out_bf16))


@_stem_s2d_conv.register_fake
def _(x, parities, w_even, w_odd, bias, alpha_next, qlvl_next, out_bf16,
      w_packed):
    b, d1, h, w, _ = x.shape
    shape = (b, d1 - 1, h, w, w_even.shape[-1])
    return (x.new_empty(shape, dtype=_dtype(out_bf16)),
            x.new_empty(shape, dtype=torch.int8))


def stem_s2d_conv(x, parities, w_even, w_odd, bias, alpha_next,
                  qlvl_next: int, out_dtype=torch.float32, w_packed=None):
    """``effq::stem_s2d_conv`` with the K2 wrapper's signature."""
    return torch.ops.effq.stem_s2d_conv(
        x, parities, w_even, w_odd, bias, _scalar(alpha_next, x),
        int(qlvl_next), out_dtype == torch.bfloat16, w_packed)


# K3 -------------------------------------------------------------------

@torch.library.custom_op("effq::fused_int8_matmul", mutates_args=(),
                         device_types="cuda")
def _fused_int8_matmul(x: Tensor, w_codes: Tensor, bias: Optional[Tensor],
                       alpha_act: Tensor, scale: Tensor, qlvl_act: int,
                       w_packed: Optional[Tensor], act_k: int = 0) -> Tensor:
    return qmatmul.fused_int8_matmul(x, w_codes, bias, alpha_act, scale,
                                     qlvl_act, w_packed, act_k)


@_fused_int8_matmul.register_kernel("cpu")
def _(x, w_codes, bias, alpha_act, scale, qlvl_act, w_packed, act_k=0):
    return qmatmul.fused_int8_matmul_reference(x, w_codes, bias, alpha_act,
                                               scale, qlvl_act, act_k=act_k)


@_fused_int8_matmul.register_fake
def _(x, w_codes, bias, alpha_act, scale, qlvl_act, w_packed, act_k=0):
    return x.new_empty((x.shape[0], w_codes.shape[1]), dtype=_F32)


def fused_int8_matmul(x, w_codes, bias, alpha_act, scale, qlvl_act: int,
                      w_packed=None, act_k: int = 0):
    """``effq::fused_int8_matmul`` with the K3 wrapper's signature."""
    return torch.ops.effq.fused_int8_matmul(
        x, w_codes, bias, _scalar(alpha_act, x), _scalar(scale, x),
        int(qlvl_act), w_packed, int(act_k))


# K4 -------------------------------------------------------------------

@torch.library.custom_op("effq::fused_qact_matmul", mutates_args=(),
                         device_types="cuda")
def _fused_qact_matmul(x: Tensor, w: Tensor, bias: Optional[Tensor],
                       alpha_act: Tensor, qlvl_act: int) -> Tensor:
    return qmatmul.fused_qact_matmul(x, w, bias, alpha_act, qlvl_act)


@_fused_qact_matmul.register_kernel("cpu")
def _(x, w, bias, alpha_act, qlvl_act):
    return qmatmul.fused_qact_matmul_reference(x, w, bias, alpha_act,
                                               qlvl_act)


@_fused_qact_matmul.register_fake
def _(x, w, bias, alpha_act, qlvl_act):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=_F32)


def fused_qact_matmul(x, w, bias, alpha_act, qlvl_act: int):
    """``effq::fused_qact_matmul`` with the K4 wrapper's signature."""
    return torch.ops.effq.fused_qact_matmul(x, w, bias,
                                            _scalar(alpha_act, x),
                                            int(qlvl_act))


# K5 -------------------------------------------------------------------

@torch.library.custom_op("effq::upsample_trilinear3d", mutates_args=(),
                         device_types="cuda")
def _upsample_trilinear3d(x: Tensor, scale_factor: List[int],
                          skip: Optional[Tensor],
                          channels_first: bool) -> Tensor:
    return upsample.upsample_trilinear3d(x, scale_factor, skip,
                                         channels_first)


@_upsample_trilinear3d.register_kernel("cpu")
def _(x, scale_factor, skip, channels_first):
    return upsample.upsample_trilinear3d_reference(x, scale_factor, skip,
                                                   channels_first)


@_upsample_trilinear3d.register_fake
def _(x, scale_factor, skip, channels_first):
    f = list(scale_factor)
    if channels_first:
        n, c, d, h, w = x.shape
        shape = (n, c, d * f[0], h * f[1], w * f[2])
    else:
        n, d, h, w, c = x.shape
        shape = (n, d * f[0], h * f[1], w * f[2], c)
    dt = x.dtype if skip is None else torch.promote_types(x.dtype,
                                                          skip.dtype)
    return x.new_empty(shape, dtype=dt)


def upsample_trilinear3d(x, scale_factor, skip=None,
                         channels_first: bool = False):
    """``effq::upsample_trilinear3d`` with the K5 wrapper's signature."""
    from ..ops import triple

    return torch.ops.effq.upsample_trilinear3d(
        x, list(triple(scale_factor)), skip, bool(channels_first))


# K6 -------------------------------------------------------------------

@torch.library.custom_op("effq::group_norm", mutates_args=(),
                         device_types="cuda")
def _group_norm(x: Tensor, gamma: Tensor, beta: Tensor, num_groups: int,
                eps: float, relu: bool, quant_alpha: Tensor,
                quant_qlvl: int) -> Tensor:
    return groupnorm.group_norm(x, gamma, beta, num_groups, eps, relu,
                                quant_alpha, quant_qlvl)


@_group_norm.register_kernel("cpu")
def _(x, gamma, beta, num_groups, eps, relu, quant_alpha, quant_qlvl):
    return groupnorm.group_norm_reference(x, gamma, beta, num_groups, eps,
                                          relu, quant_alpha, quant_qlvl)


@_group_norm.register_fake
def _(x, gamma, beta, num_groups, eps, relu, quant_alpha, quant_qlvl):
    return x.new_empty(x.shape,
                       dtype=torch.int8 if quant_qlvl else x.dtype)


def group_norm(x, gamma, beta, num_groups: int, eps: float = 1e-5,
               relu: bool = False, quant_alpha=None, quant_qlvl: int = 0):
    """``effq::group_norm`` with the K6 wrapper's signature."""
    return torch.ops.effq.group_norm(
        x, gamma, beta, int(num_groups), float(eps), bool(relu),
        _scalar(quant_alpha if quant_qlvl else 0.0, x), int(quant_qlvl))


# K7 -------------------------------------------------------------------

@torch.library.custom_op("effq::window_attention", mutates_args=(),
                         device_types="cuda")
def _window_attention(qkv: Tensor, table: Tensor, qkv_bias: Optional[Tensor],
                      num_heads: int, window: List[int],
                      shift: List[int]) -> Tensor:
    return wattn.window_attention(qkv, table, qkv_bias, num_heads, window,
                                  shift)


@_window_attention.register_kernel("cpu")
def _(qkv, table, qkv_bias, num_heads, window, shift):
    return wattn.window_attention_reference(qkv, table, qkv_bias, num_heads,
                                            window, shift)


@_window_attention.register_fake
def _(qkv, table, qkv_bias, num_heads, window, shift):
    return qkv.new_empty((*qkv.shape[:-1], qkv.shape[-1] // 3),
                         dtype=_F32)


def window_attention(qkv, table, qkv_bias, num_heads: int, window, shift):
    """``effq::window_attention`` with the K7 wrapper's signature."""
    return torch.ops.effq.window_attention(
        qkv, table, qkv_bias, int(num_heads), [int(v) for v in window],
        [int(v) for v in shift])


# the kernel record of an exported program (kernels/__init__.py), op-backed
OPS = Kernels(qconv3x3_int8, stem_s2d_conv, fused_int8_matmul,
              fused_qact_matmul, upsample_trilinear3d, group_norm,
              window_attention)
