"""K1: the int8 3x3x3 conv with fused epilogues.

Counterpart of the JAX package's ``pallas/qconv3d.py::qconv3x3_int8_ndhwc``
(a Pallas TPU kernel).  Here the conv is the hand-written CUDA kernel
``csrc/qconv3d_int8.cu``: an implicit GEMM on the int8 tensor cores
(``mma.sync`` m16n8k32, int32 accumulation) over a shared-memory halo tile
that all 27 taps read, loaded with ``cp.async`` in two stages; its header
says what bounds it.  It is built with nvcc and bound with ctypes
(kernels/build.py).  ``_tile_plan`` picks its brick and grid per call,
and its pipeline: where every block walks two or more 4 x 8 x 8 bricks,
four epilogue warps of the block run one brick's epilogue while its eight
MMA warps run the next brick's taps, and four producer warps issue the
loads of both (``TilePlan.sums`` > 0), so a call takes about the longer of
the two phases; elsewhere the block's warps take turns.  What bounds K1
then is its tap loop, which reloads the weights' fragments from shared
memory for every warp and tap, and the four epilogue warps (the csrc
header).  Beside it, ``qconv3x3_int8_ndhwc_reference`` is the plain
PyTorch version of the same function, op for op the JAX package's
``_xla_qconv3x3``.

``qconv3x3_int8_ndhwc`` takes the plain version for tensors on the CPU
only; for CUDA tensors it launches the kernel or raises.  Each launch adds
one to ``qconv3x3_int8_ndhwc.launches``.

A float32 or bfloat16 input is quantized by K1 itself, in a pass of its
own on the card (``qconv3d_int8_kernel_quantize``, in the same source and
the same launch call) that reads x once and writes its int8 codes once for
the convolution; the JAX package's kernel reads codes that one XLA fusion
makes before it, and ``act_codes`` in eager PyTorch is five full-size
passes.  Each such launch also adds one to
``qconv3x3_int8_ndhwc.prologue_quant_launches``, and each launch on the
overlapped pipeline one to ``qconv3x3_int8_ndhwc.overlapped_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..quant import act_codes
from .build import SMEM_BLOCK, SMEM_SM, SMS

# the kernel's fixed tile sizes (csrc/qconv3d_int8.cu): output channels per
# block, input channels per staged chunk, brick extent along x
_BN, _CK, _BX = 32, 32, 8
_HS = 48  # bytes per staged halo row: 32 channels + 16 (no bank conflicts)
# brick extents (z, y) the kernel is built for, largest first; one warp
# per 2 x 2 x 8 sub-brick; the overlapped pipeline is built for the first
_BRICKS = ((4, 8), (4, 4), (2, 4), (2, 2))
# threads an SM holds at the kernel's launch bounds (<= 128 registers each)
_THREADS_SM = 512
_MBAR_BYTES = 128  # the overlapped pipeline's stage mbarriers
# the overlapped pipeline's epilogue and producer warps beside its 8 MMA
# warps (csrc/qconv3d_int8.cu, EPI_WARPS and LOAD_WARPS)
_EPI_WARPS, _LOAD_WARPS = 4, 4


def pack_weights(w_codes: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, O) int8 DHWIO codes -> the kernel's (27, O, Cp) int8
    layout, ``packed[tap, o, c] = w_codes[tap, c, o]``: input channels
    contiguous (the mma's B fragment runs along k), zero-padded to
    Cp = 32 * ceil(C / 32), one mma depth."""
    *taps, c, o = w_codes.shape
    assert tuple(taps) == (3, 3, 3), taps
    cp = -(-c // _CK) * _CK
    w = w_codes.reshape(27, c, o).permute(0, 2, 1)
    if cp != c:
        w = torch.cat([w, w.new_zeros(27, o, cp - c)], dim=2)
    return w.contiguous()


def qconv3x3_int8_ndhwc_reference(x, w_codes, bias, alpha_act, scale,
                                  qlvl_act: int, dilation: int = 1,
                                  residual: Optional[torch.Tensor] = None,
                                  quant_alpha=None, quant_qlvl: int = 0,
                                  x_quantized: bool = False,
                                  residual_relu: bool = False,
                                  pool: bool = False, w_packed=None,
                                  out_dtype=torch.float32, act_k: int = 0,
                                  quant_k: int = 0):
    """Plain PyTorch K1, on any device, with the wrapper's signature
    (``w_packed`` is ignored).  Op for op the JAX package's act-quant
    prologue and ``_xla_qconv3x3``: the integer conv accumulates exactly in
    float64 (float32 is not exact once 27*C*(na-1)*(nw-1) > 2**24, e.g.
    C >= 39 at 8 bits) and is rounded to float32 as an int32 -> float32
    conversion rounds; scale, bias and the epilogues follow in order, in
    float32: the residual is converted to float32 and added, the quant
    epilogue quantizes that float32 y, otherwise y is rounded to
    ``out_dtype`` and the pool takes the max of the rounded values.  The
    codes of a float x, and the quant epilogue's, are ``act_codes``' on the
    offset grid ``act_k`` (``quant_k``) where it is not 0."""
    qa = x if x_quantized else act_codes(x, alpha_act, qlvl_act, act_k)
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
        if quant_k:
            return act_codes(y, torch.as_tensor(quant_alpha, **f32),
                             quant_qlvl, quant_k)
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
                        out_dtype=torch.float32, act_k: int = 0,
                        quant_k: int = 0):
    """y = conv3d(int8_codes(x), w_codes) * scale + bias, stride 1,
    padding = dilation, computed in float32 and stored as ``out_dtype``
    (float32 or bfloat16, rounded to nearest even).

    x: (N, D, H, W, C) float (float32 or bfloat16; the codes
    ``act_codes(x, alpha_act, qlvl_act)`` are taken in float32, on a card
    by K1's own pass, with one alpha), or int8 codes when ``x_quantized``;
    w_codes: (3, 3, 3, C, O) int8; scale: () or (O,) = alpha_act * alpha_w
    / ((na-1)(nw-1)); w_packed: ``pack_weights(w_codes)``, made at deploy
    time (packed here when None).

    Epilogues: ``residual`` (N, D, H, W, O), float32 or bfloat16, added to
    y in float32 (relu'd first with ``residual_relu``);
    ``quant_alpha``/``quant_qlvl`` emit the next conv's int8 codes of
    relu(y), from the float32 y, instead of y; ``pool`` also returns
    maxpool_2x2x2 of the stored y, as (y, pool).  pool and quant are never
    combined.  ``act_k`` (``quant_k``): the offset grid's shift of x's codes
    (of the quant epilogue's), ``act_codes(..., k)``; 0 is the unsigned
    grid.
    """
    assert not (pool and quant_qlvl), \
        "pool and quant epilogues have different consumers"
    if x.device.type == "cpu":
        return qconv3x3_int8_ndhwc_reference(
            x, w_codes, bias, alpha_act, scale, qlvl_act, dilation, residual,
            quant_alpha, quant_qlvl, x_quantized, residual_relu, pool,
            out_dtype=out_dtype, act_k=act_k, quant_k=quant_k)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    if w_packed is None:
        w_packed = pack_weights(w_codes)
    return _launch(x, None if x_quantized else (alpha_act, int(qlvl_act),
                                                int(act_k)),
                   w_packed, w_codes.shape[-1], bias, scale, dilation,
                   residual, residual_relu, quant_alpha, quant_qlvl, pool,
                   out_dtype, int(quant_k))


qconv3x3_int8_ndhwc.launches = 0
qconv3x3_int8_ndhwc.prologue_quant_launches = 0
qconv3x3_int8_ndhwc.overlapped_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from . import build

    fn = build.load("qconv3d_int8.cu").qconv3d_int8_launch
    fn.argtypes = [_P] * 11 + [_I] * 21 + [_P]  # else ints pass as 32-bit
    fn.restype = _I
    return fn


def _smem_bytes(brick, c, dil, sums=0):
    """Dynamic shared memory of one block, as the launch computes it: two
    pipeline stages, each the halo ((bz + 2s) x (by + 2s) x (8 + 2s) rows
    of 48 bytes, s = min(dil, extent) per axis) and, when C spans more
    than one 32-channel chunk, the chunk's 27 x 32 x 32 bytes of weights.
    With one chunk the weights stay resident after the two stages.  The
    brick's int32 sums (rows of 32 x 4 + 16 bytes) go to a spent stage,
    which must hold them, or on the overlapped pipeline to ``sums`` buffers
    of their own after the rest, each with a tile of the brick's residual
    (32 channels of float32), followed by the pipeline's mbarriers."""
    rows = 1
    for b in brick:
        rows *= b + 2 * min(dil, b)
    up = lambda n: -(-n // 128) * 128  # noqa: E731
    weights = 27 * _BN * _CK
    loads = up(rows * _HS) + (weights if c > _CK else 0)
    staged = brick[0] * brick[1] * brick[2] * (_BN * 4 + 16)
    stage = loads if sums else up(max(loads, staged))
    tile = brick[0] * brick[1] * brick[2] * _BN * 4
    return (2 * stage + (0 if c > _CK else weights) + sums * (staged + tile)
            + (_MBAR_BYTES if sums else 0))


class TilePlan(NamedTuple):
    brick: Tuple[int, int, int]   # output voxels per brick, (z, y, x)
    bn: int                       # output channels per block
    grid: Tuple[int, int]         # (blocks over bricks, column tiles)
    bricks: Tuple[int, int, int, int]  # bricks per axis: n, z, y, x
    n_bricks: int
    threads: int                  # per block
    smem: int                     # dynamic shared memory per block, bytes
    sums: int                     # the overlapped pipeline's sums buffers
                                  # (1 or 2), or 0: warps take turns


@functools.lru_cache(maxsize=1024)
def _tile_plan(n, d, h, w, c, o, dil) -> TilePlan:
    """K1's tiling of one call, as the launch takes it.

    Each block owns ``bn`` = 32 output channels (``grid[1]`` column tiles)
    and walks bricks of ``brick`` = (bz, by, 8) output voxels: block x takes
    bricks x, x + grid[0], x + 2 grid[0], ... (``_brick_origin`` numbers
    them).  The brick is the largest of ``_BRICKS`` whose shared memory
    fits a block and that still gives every SM a block (larger bricks
    reload the weights for more voxels), else the smallest; ``grid[0]`` is
    as many blocks as the SMs hold at once (persistent blocks), at most
    one per brick.

    The 4 x 8 x 8 brick takes the overlapped pipeline where every block of
    its grid then walks two or more bricks (``n_bricks >= 2 * grid[0]``)
    and the block's shared memory holds two sums buffers (with their
    residual tiles), else one: 8 MMA, 4 epilogue and 4 producer warps, one
    block an SM.  Where blocks walk fewer there is little to overlap, and
    the blocks that take turns are twice as many an SM."""
    gy = -(-o // _BN)
    for bz, by in _BRICKS:
        brick = (bz, by, _BX)
        smem = _smem_bytes(brick, c, dil)
        per_axis = (n, -(-d // bz), -(-h // by), -(-w // _BX))
        n_bricks = per_axis[0] * per_axis[1] * per_axis[2] * per_axis[3]
        if smem <= SMEM_BLOCK and n_bricks * gy >= SMS:
            break
    threads = bz * by * _BX
    if (bz, by) == _BRICKS[0]:
        gx = min(n_bricks, max(1, SMS // gy))  # one block an SM
        fits = [s for s in (2, 1)
                if _smem_bytes(brick, c, dil, s) <= SMEM_BLOCK]
        if n_bricks >= 2 * gx and fits:
            return TilePlan(brick, _BN, (gx, gy), per_axis, n_bricks,
                            threads + 32 * (_EPI_WARPS + _LOAD_WARPS),
                            _smem_bytes(brick, c, dil, fits[0]), fits[0])
    # blocks per SM: shared memory (1 KB reserved per block) and registers
    per_sm = max(1, min(SMEM_SM // (smem + 1024), _THREADS_SM // threads))
    gx = min(n_bricks, max(1, SMS * per_sm // gy))
    return TilePlan(brick, _BN, (gx, gy), per_axis, n_bricks, threads,
                    smem, 0)


def _brick_origin(plan, b):
    """(n, z0, y0, x0) of brick b: x fastest, then y, z and n, as the
    kernel numbers them."""
    _, nbz, nby, nbx = plan.bricks
    bz, by, bx = plan.brick
    t, xi = divmod(b, nbx)
    t, yi = divmod(t, nby)
    ni, zi = divmod(t, nbz)
    return ni, zi * bz, yi * by, xi * bx


_FLOAT_OUT = (torch.float32, torch.bfloat16)


def _aligned(t, nbytes):
    """t, or a copy of it whose data starts on an nbytes boundary (the
    kernel's vector accesses)."""
    return t if t is None or t.data_ptr() % nbytes == 0 else t.clone()


def _on_card(v, dev) -> torch.Tensor:
    """``v`` as a float32 tensor on ``dev``: a tensor converted there, a
    number filled in there (no host-to-device copy, so a launch can be
    captured in a CUDA graph)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32)
    if isinstance(v, (int, float, np.number)):
        return torch.full((), float(v), dtype=torch.float32, device=dev)
    return torch.as_tensor(np.asarray(v, np.float32), device=dev)


def _launch(x, x_quant, w_packed, o, bias, scale, dilation, residual,
            residual_relu, quant_alpha, quant_qlvl, pool, out_dtype,
            quant_k=0):
    """K1 on the card: ``x`` int8 codes (``x_quant`` None), or float32 /
    bfloat16 activations that K1's pass quantizes with ``x_quant`` =
    (alpha, levels, offset-grid shift) into a scratch tensor of codes
    first."""
    dev = x.device
    x = _aligned(x.contiguous(), 16)
    n, d, h, w, c = x.shape
    if x_quant is None and (x.dtype != torch.int8 or x.numel() == 0):
        raise ValueError(f"K1 needs non-empty int8 codes, got {x.dtype} "
                         f"{tuple(x.shape)}")
    x_alpha, x_qlvl, x_k = None, 0, 0
    if x_quant is not None:
        if x.dtype not in _FLOAT_OUT or x.numel() == 0:
            raise ValueError(f"K1 quantizes a non-empty float32 or bfloat16 "
                             f"input, got {x.dtype} {tuple(x.shape)}")
        x_alpha = _on_card(x_quant[0], dev).reshape(-1).contiguous()
        x_qlvl, x_k = x_quant[1], x_quant[2]
        if x_alpha.numel() != 1 or x_qlvl < 2 or not 0 <= x_k < x_qlvl:
            raise ValueError(f"K1's input quantizer takes one alpha, 2 or "
                             f"more levels and a shift below them, got "
                             f"{x_alpha.numel()} alphas, {x_qlvl} levels, "
                             f"shift {x_k}")
    if (w_packed.dtype != torch.int8 or w_packed.device != dev
            or tuple(w_packed.shape) != (27, o, -(-c // _CK) * _CK)
            or not w_packed.is_contiguous()):
        raise ValueError(f"packed weights {w_packed.dtype} "
                         f"{tuple(w_packed.shape)} on {w_packed.device} do "
                         f"not fit input {tuple(x.shape)} -> {o} channels")
    w_packed = _aligned(w_packed, 16)
    dil = int(dilation)
    if dil < 1:
        raise ValueError(f"dilation {dil}")
    if out_dtype not in _FLOAT_OUT:
        raise ValueError(f"K1 stores float32 or bfloat16, not {out_dtype}")
    scale_v = _on_card(scale, dev)
    if scale_v.numel() not in (1, o):
        raise ValueError(f"scale {tuple(scale_v.shape)}: one value or {o}")
    scale_v = scale_v.reshape(-1).contiguous()
    bias_v = None if bias is None else _on_card(bias, dev).contiguous()
    res = None
    if residual is not None:
        res = _aligned(residual.to(device=dev, dtype=(
            residual.dtype if residual.dtype in _FLOAT_OUT
            else torch.float32)).contiguous(), 16)
        if tuple(res.shape) != (n, d, h, w, o):
            raise ValueError(f"residual {tuple(res.shape)} != output "
                             f"{(n, d, h, w, o)}")
    qalpha = (_on_card(quant_alpha, dev).reshape(1).contiguous()
              if quant_qlvl else None)
    # the prologue's codes of a float x, which the convolution then reads
    codes = (torch.empty(x.shape, device=dev, dtype=torch.int8)
             if x_qlvl else None)
    out = torch.empty((n, d, h, w, o), device=dev,
                      dtype=torch.int8 if quant_qlvl else out_dtype)
    pooled = (torch.empty((n, d // 2, h // 2, w // 2, o), device=dev,
                          dtype=out_dtype) if pool else None)
    plan = _tile_plan(n, d, h, w, c, o, dil)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        rc = _lib()(ptr(x), ptr(x_alpha), ptr(codes), ptr(w_packed),
                    ptr(scale_v), ptr(bias_v), ptr(res), ptr(qalpha),
                    None if quant_qlvl else ptr(out),
                    ptr(out) if quant_qlvl else None, ptr(pooled),
                    n, d, h, w, c, o, dil, x_qlvl,
                    int(x.dtype == torch.bfloat16), int(bool(residual_relu)),
                    int(quant_qlvl),
                    int(res is not None and res.dtype == torch.bfloat16),
                    int(out_dtype == torch.bfloat16),
                    int(scale_v.numel() > 1), *plan.brick[:2], *plan.grid,
                    plan.sums, x_k, quant_k,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {rc}")
    qconv3x3_int8_ndhwc.launches += 1
    qconv3x3_int8_ndhwc.prologue_quant_launches += x_quant is not None
    qconv3x3_int8_ndhwc.overlapped_launches += plan.sums > 0
    return (out, pooled) if pool else out
