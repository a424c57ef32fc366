"""K1: the int8 3x3x3 conv with fused epilogues.

Counterpart of the JAX package's ``pallas/qconv3d.py::qconv3x3_int8_ndhwc``
(a Pallas TPU kernel).  Here the conv is the hand-written CUDA kernel
``csrc/qconv3d_int8.cu`` (int32 accumulation with ``__dp4a``; its header
says what bounds it), built with nvcc and bound with ctypes
(kernels/build.py).  Beside it, ``qconv3x3_int8_ndhwc_reference`` is the
plain PyTorch version of the same function, op for op the JAX package's
``_xla_qconv3x3``.

``qconv3x3_int8_ndhwc`` takes the plain version for tensors on the CPU
only; for CUDA tensors it launches the kernel or raises.  Each launch adds
one to ``qconv3x3_int8_ndhwc.launches``.

The act-quant prologue of a float input stays a torch op, as in the JAX
package (its kernel too reads int8 codes produced outside it).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import ops
from ..quant import act_codes


def pack_weights(w_codes: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, O) int8 DHWIO codes -> the kernel's (27, ceil(C/4), O)
    int32 layout: four consecutive input channels per word, channel 4k+b
    in byte b (little-endian), zero-padded to a multiple of 4."""
    *taps, c, o = w_codes.shape
    assert tuple(taps) == (3, 3, 3), taps
    c4 = -(-c // 4)
    w = w_codes.reshape(27, c, o)
    if c4 * 4 != c:
        w = torch.cat([w, w.new_zeros(27, c4 * 4 - c, o)], dim=1)
    w = w.reshape(27, c4, 4, o).permute(0, 1, 3, 2).contiguous()
    return w.view(torch.int32).reshape(27, c4, o)


def qconv3x3_int8_ndhwc_reference(x, w_codes, bias, alpha_act, scale,
                                  qlvl_act: int, dilation: int = 1,
                                  residual: Optional[torch.Tensor] = None,
                                  quant_alpha=None, quant_qlvl: int = 0,
                                  x_quantized: bool = False,
                                  residual_relu: bool = False,
                                  pool: bool = False, w_packed=None,
                                  out_dtype=torch.float32):
    """Plain PyTorch K1, on any device, with the wrapper's signature
    (``w_packed`` is ignored).  Op for op the JAX package's act-quant
    prologue and ``_xla_qconv3x3``: the integer conv accumulates exactly in
    float64 (float32 is not exact once 27*C*(na-1)*(nw-1) > 2**24, e.g.
    C >= 39 at 8 bits) and is rounded to float32 as an int32 -> float32
    conversion rounds; scale, bias and the epilogues follow in order, in
    float32: the residual is converted to float32 and added, the quant
    epilogue quantizes that float32 y, otherwise y is rounded to
    ``out_dtype`` and the pool takes the max of the rounded values."""
    qa = x if x_quantized else act_codes(x, alpha_act, qlvl_act)
    dil = int(dilation)
    f32 = dict(dtype=torch.float32, device=qa.device)
    y = ops.conv3d(qa.to(torch.float64), w_codes.to(torch.float64), None,
                   1, dil, dil).to(torch.float32)
    if bias is None:
        bias = torch.zeros(w_codes.shape[-1], **f32)
    y = y * torch.as_tensor(scale, **f32) + bias
    if residual is not None:
        r = residual.to(torch.float32)
        if residual_relu:
            r = torch.clamp_min(r, 0.0)
        y = y + r
    if quant_qlvl:
        q = (torch.clamp(y / torch.as_tensor(quant_alpha, **f32), 0.0, 1.0)
             * (quant_qlvl - 1))
        return torch.round(q).to(torch.int8)
    y = y.to(out_dtype)
    if pool:
        return y, ops.max_pool3d(y, 2, 2)
    return y


def qconv3x3_int8_ndhwc(x, w_codes, bias, alpha_act, scale, qlvl_act: int,
                        dilation: int = 1,
                        residual: Optional[torch.Tensor] = None,
                        quant_alpha=None, quant_qlvl: int = 0,
                        x_quantized: bool = False,
                        residual_relu: bool = False, pool: bool = False,
                        w_packed: Optional[torch.Tensor] = None,
                        out_dtype=torch.float32):
    """y = conv3d(int8_codes(x), w_codes) * scale + bias, stride 1,
    padding = dilation, computed in float32 and stored as ``out_dtype``
    (float32 or bfloat16, rounded to nearest even).

    x: (N, D, H, W, C) float (float32 or bfloat16; the codes are taken in
    float32), or int8 codes when ``x_quantized``;
    w_codes: (3, 3, 3, C, O) int8; scale: () or (O,) = alpha_act * alpha_w
    / ((na-1)(nw-1)); w_packed: ``pack_weights(w_codes)``, made at deploy
    time (packed here when None).

    Epilogues: ``residual`` (N, D, H, W, O), float32 or bfloat16, added to
    y in float32 (relu'd first with ``residual_relu``);
    ``quant_alpha``/``quant_qlvl`` emit the next conv's int8 codes of
    relu(y), from the float32 y, instead of y; ``pool`` also returns
    maxpool_2x2x2 of the stored y, as (y, pool).  pool and quant are never
    combined.
    """
    assert not (pool and quant_qlvl), \
        "pool and quant epilogues have different consumers"
    if x.device.type == "cpu":
        return qconv3x3_int8_ndhwc_reference(
            x, w_codes, bias, alpha_act, scale, qlvl_act, dilation, residual,
            quant_alpha, quant_qlvl, x_quantized, residual_relu, pool,
            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    qa = x if x_quantized else act_codes(x, alpha_act, qlvl_act)
    if w_packed is None:
        w_packed = pack_weights(w_codes)
    return _launch(qa, w_packed, w_codes.shape[-1], bias, scale, dilation,
                   residual, residual_relu, quant_alpha, quant_qlvl, pool,
                   out_dtype)


qconv3x3_int8_ndhwc.launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from . import build

    lib = build.load("qconv3d_int8.cu")
    fn = lib.qconv3d_int8_launch
    if fn.argtypes is None:  # ctypes would pass ints as 32-bit
        fn.argtypes = [_P] * 9 + [_I] * 11 + [_P]
        fn.restype = _I
    return fn


_FLOAT_OUT = (torch.float32, torch.bfloat16)


def _launch(qa, w_packed, o, bias, scale, dilation, residual, residual_relu,
            quant_alpha, quant_qlvl, pool, out_dtype):
    dev = qa.device
    qa = qa.contiguous()
    n, d, h, w, c = qa.shape
    if qa.dtype != torch.int8 or qa.numel() == 0:
        raise ValueError(f"K1 needs non-empty int8 codes, got {qa.dtype} "
                         f"{tuple(qa.shape)}")
    if (w_packed.dtype != torch.int32 or w_packed.device != dev
            or tuple(w_packed.shape) != (27, -(-c // 4), o)
            or not w_packed.is_contiguous()):
        raise ValueError(f"packed weights {w_packed.dtype} "
                         f"{tuple(w_packed.shape)} on {w_packed.device} do "
                         f"not fit codes {tuple(qa.shape)} -> {o} channels")
    dil = int(dilation)
    if dil < 1:
        raise ValueError(f"dilation {dil}")
    if out_dtype not in _FLOAT_OUT:
        raise ValueError(f"K1 stores float32 or bfloat16, not {out_dtype}")
    f32 = dict(dtype=torch.float32, device=dev)
    scale_v = torch.as_tensor(scale, **f32).expand(o).contiguous()
    bias_v = (torch.zeros(o, **f32) if bias is None
              else bias.to(**f32).contiguous())
    res = None
    if residual is not None:
        res = residual.to(device=dev, dtype=(
            residual.dtype if residual.dtype in _FLOAT_OUT
            else torch.float32)).contiguous()
        if tuple(res.shape) != (n, d, h, w, o):
            raise ValueError(f"residual {tuple(res.shape)} != output "
                             f"{(n, d, h, w, o)}")
    qalpha = (torch.as_tensor(quant_alpha, **f32).reshape(1).contiguous()
              if quant_qlvl else None)
    out = torch.empty((n, d, h, w, o), device=dev,
                      dtype=torch.int8 if quant_qlvl else out_dtype)
    pooled = (torch.empty((n, d // 2, h // 2, w // 2, o), device=dev,
                          dtype=out_dtype) if pool else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        rc = _lib()(ptr(qa), ptr(w_packed), ptr(scale_v), ptr(bias_v),
                    ptr(res), ptr(qalpha),
                    None if quant_qlvl else ptr(out),
                    ptr(out) if quant_qlvl else None, ptr(pooled),
                    n, d, h, w, c, o, dil, int(bool(residual_relu)),
                    int(quant_qlvl),
                    int(res is not None and res.dtype == torch.bfloat16),
                    int(out_dtype == torch.bfloat16),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {rc}")
    qconv3x3_int8_ndhwc.launches += 1
    return (out, pooled) if pool else out
