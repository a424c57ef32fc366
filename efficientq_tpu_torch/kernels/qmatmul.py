"""K3 and K4, the fused 1x1 matmul kernels, and the graph pass that flags
convs for the fused kernels.

Counterpart of the JAX package's ``pallas/qmatmul.py``:

- K3, ``fused_int8_matmul``: the activation codes of x times int8 weight
  codes, int32 sums, then ``* scale + bias`` in float32 (an int8 1x1x1 conv
  of the int8 deployment).  The hand-written CUDA kernel
  ``csrc/qmatmul_int8.cu`` (int8 tensor cores) reads the (K, N) codes as
  they are: the deployment packs weights only for the K1 convs it flags, so
  K3 needs no layout of its own.
- K4, ``fused_qact_matmul``: fake-quantized x times float32 weights, full
  float32 (no TF32), plus bias (the activation-quantized 1x1x1 convs off the
  int8 path: the mixed deployment and fq mode), run by
  ``qconv1x1_ndhwc``.  Its kernel is ``csrc/qmatmul_f32.cu`` (a
  register-tiled SGEMM with the fake-quant prologue).
- ``to_pallas_inference``: flags the convs that the fused kernels run
  (attribute ``pallas``, the JAX package's name, so the graphs compare node
  for node).

Each wrapper takes its plain PyTorch version (``*_reference``, op for op
the JAX semantics) for tensors on the CPU only; for CUDA tensors it
launches its kernel or raises.  Each launch adds one to the wrapper's
``launches``.  Both kernels emit float32, whatever the input's dtype.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import ops
from ..quant import act_codes, fake_quant_act

_P = ctypes.c_void_p
_I = ctypes.c_int
_F32 = dict(dtype=torch.float32)
_X_DTYPES = (torch.float32, torch.bfloat16)


def fused_int8_matmul_reference(x, w_codes, bias, alpha_act, scale,
                                qlvl_act: int):
    """Plain K3: ``act_codes`` of x, an exact integer matmul in the float
    type that ``nnir.int_conv_dtype`` picks for codes of at most 127, then
    ``* scale`` and ``+ bias`` rounded separately in float32 (the port's
    int8 1x1 route of ``nnir._eval_conv``)."""
    from ..nnir import int_conv_dtype

    qa = act_codes(x, alpha_act, qlvl_act)
    dt = int_conv_dtype(1, w_codes.shape[0], qlvl_act, 128)
    with ops.exact_f32():
        y = torch.matmul(qa.to(dt), w_codes.to(dt)).to(torch.float32)
    y = y * torch.as_tensor(scale, device=y.device, **_F32)
    return y if bias is None else y + bias


def fused_int8_matmul(x, w_codes, bias, alpha_act, scale, qlvl_act: int):
    """y = (int8_codes(x) @ w_codes) * scale + bias, one kernel.

    x: (M, K) float32 or bfloat16 (codes taken in float32); w_codes: (K, N)
    int8; scale: () or (N,) float32, alpha_act * alpha_w / ((na-1)(nw-1));
    bias: (N,) or None.  Returns (M, N) float32."""
    if x.device.type == "cpu":
        return fused_int8_matmul_reference(x, w_codes, bias, alpha_act,
                                           scale, qlvl_act)
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    return _launch_int8(x, w_codes, bias, alpha_act, scale, qlvl_act)


fused_int8_matmul.launches = 0


def fused_qact_matmul_reference(x, w, bias, alpha_act, qlvl_act: int):
    """Plain K4: ``fake_quant_act`` of x (in float32), a float32 matmul with
    TF32 off, then ``+ bias``."""
    xq = fake_quant_act(x, alpha_act, qlvl_act)
    with ops.exact_f32():
        y = torch.matmul(xq, w.to(torch.float32))
    return y if bias is None else y + bias


def fused_qact_matmul(x, w, bias, alpha_act, qlvl_act: int):
    """y = fake_quant_act(x) @ w + bias in full float32, one kernel.

    x: (M, K) float32 or bfloat16; w: (K, N) float32 (post-PTQ quantized
    values, or fake-quantized in fq mode); bias: (N,) or None.  Returns
    (M, N) float32."""
    if x.device.type == "cpu":
        return fused_qact_matmul_reference(x, w, bias, alpha_act, qlvl_act)
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    return _launch_f32(x, w, bias, alpha_act, qlvl_act)


fused_qact_matmul.launches = 0


def qconv1x1_ndhwc(x, kernel_dhwio, bias, alpha_act, qlvl_act: int,
                   matmul=None):
    """Quantized-inference 1x1x1 conv through K4 (or ``matmul``, a function
    with K4's signature such as its plain version).

    x: (N, D, H, W, C); kernel: (1, 1, 1, C, O).  Returns (N, D, H, W, O)
    float32."""
    n, d, h, w, c = x.shape
    o = kernel_dhwio.shape[-1]
    y = (matmul or fused_qact_matmul)(x.reshape(-1, c),
                                      kernel_dhwio.reshape(c, o), bias,
                                      alpha_act, qlvl_act)
    return y.reshape(n, d, h, w, o)


def to_pallas_inference(graph, include_1x1: bool = False):
    """Flag the convs that the fused kernels run in ``nnir._eval_conv``
    (modes 'quantized' and 'fq'): every int8 3^3 conv of stride 1 and
    'same' padding (after ``ptq.deploy.to_int8_inference`` set ``int8``)
    for K1, and with ``include_1x1`` every activation-quantized 1x1x1 conv
    of stride 1, for K3 (int8) or K4 (float).  Offset-grid (``act_k``)
    convs keep the unfused path.  Off by default, as in the JAX package;
    whether K3 and K4 beat the unfused 1x1 routes on the card is measured
    in ``PERF.md``."""
    from ..nnir import Graph, _pallas_1x1_eligible, _pallas_3x3_int8_eligible

    new_nodes = []
    for node in graph.nodes:
        qcfg = node.attrs.get("qcfg")
        if (node.op == "conv" and qcfg is not None and qcfg.q_act
                and not node.attrs.get("act_k")
                and ((include_1x1 and _pallas_1x1_eligible(node.attrs))
                     or (node.attrs.get("int8")
                         and _pallas_3x3_int8_eligible(node.attrs)))):
            attrs = dict(node.attrs)
            attrs["pallas"] = True
            new_nodes.append(dataclasses.replace(node, attrs=attrs))
        else:
            new_nodes.append(node)
    return Graph(new_nodes, list(graph.outputs), graph.input_name)


def _lib(source, name, argtypes):
    from . import build

    fn = getattr(build.load(source), name)
    if fn.argtypes is None:  # ctypes would pass ints as 32-bit
        fn.argtypes = argtypes
        fn.restype = _I
    return fn


def _int8_lib():
    return _lib("qmatmul_int8.cu", "qmatmul_int8_launch",
                [_P] * 6 + [_I] * 5 + [_P])


def _f32_lib():
    return _lib("qmatmul_f32.cu", "qmatmul_f32_launch",
                [_P] * 5 + [_I] * 3 + [ctypes.c_float, _I, _P])


def _check_x(x, what):
    """x as a contiguous, 16-byte aligned 2-d float32/bfloat16 tensor."""
    if x.dim() != 2 or x.dtype not in _X_DTYPES or x.numel() == 0:
        raise ValueError(f"{what} needs a non-empty (M, K) float32 or "
                         f"bfloat16 x, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _vector(v, n, dev, what):
    """A contiguous (n,) float32 vector on ``dev``, or None."""
    if v is None:
        return None
    v = torch.as_tensor(v, device=dev, **_F32)
    if v.dim() == 0:
        v = v.expand(n)
    if tuple(v.shape) != (n,):
        raise ValueError(f"{what} {tuple(v.shape)} != ({n},)")
    return v.contiguous()


def _launch_int8(x, w_codes, bias, alpha_act, scale, qlvl_act):
    dev = x.device
    x = _check_x(x, "K3")
    m, k = x.shape
    if (w_codes.dtype != torch.int8 or w_codes.dim() != 2
            or w_codes.shape[0] != k or w_codes.device != dev):
        raise ValueError(f"weight codes {w_codes.dtype} "
                         f"{tuple(w_codes.shape)} on {w_codes.device} do not "
                         f"fit x {tuple(x.shape)}")
    n = w_codes.shape[1]
    w_codes = w_codes.contiguous()
    scale_v = _vector(scale, n, dev, "scale")
    bias_v = _vector(bias, n, dev, "bias")
    if not 2 <= int(qlvl_act) <= 128:
        raise ValueError(f"qlvl_act {qlvl_act}: int8 codes need 2..128")
    alpha = torch.as_tensor(alpha_act, device=dev, **_F32).reshape(1)
    y = torch.empty((m, n), device=dev, **_F32)
    with torch.cuda.device(dev):
        rc = _int8_lib()(x.data_ptr(), w_codes.data_ptr(), scale_v.data_ptr(),
                         None if bias_v is None else bias_v.data_ptr(),
                         alpha.data_ptr(), y.data_ptr(), m, k, n,
                         int(qlvl_act), int(x.dtype == torch.bfloat16),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError_t {rc}")
    fused_int8_matmul.launches += 1
    return y


def _launch_f32(x, w, bias, alpha_act, qlvl_act):
    dev = x.device
    x = _check_x(x, "K4")
    m, k = x.shape
    if (w.dtype != torch.float32 or w.dim() != 2 or w.shape[0] != k
            or w.device != dev):
        raise ValueError(f"weights {w.dtype} {tuple(w.shape)} on {w.device} "
                         f"do not fit x {tuple(x.shape)}")
    n = w.shape[1]
    w = w.contiguous()
    bias_v = _vector(bias, n, dev, "bias")
    if int(qlvl_act) < 2:
        raise ValueError(f"qlvl_act {qlvl_act}: need at least 2 levels")
    alpha = torch.as_tensor(alpha_act, device=dev, **_F32).reshape(1)
    y = torch.empty((m, n), device=dev, **_F32)
    with torch.cuda.device(dev):
        # delta rounded once, from the double 1 / (n - 1), as the JAX
        # kernel's Python float enters its float32 arithmetic
        rc = _f32_lib()(x.data_ptr(), w.data_ptr(),
                        None if bias_v is None else bias_v.data_ptr(),
                        alpha.data_ptr(), y.data_ptr(), m, k, n,
                        1.0 / (int(qlvl_act) - 1),
                        int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError_t {rc}")
    fused_qact_matmul.launches += 1
    return y
