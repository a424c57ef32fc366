"""K3 and K4, the fused 1x1 matmul kernels, and the graph pass that flags
convs for the fused kernels.

Counterpart of the JAX package's ``pallas/qmatmul.py``:

- K3, ``fused_int8_matmul``: the activation codes of x times int8 weight
  codes, int32 sums, then ``* scale + bias`` in float32 (an int8 1x1x1 conv
  of the int8 deployment).  Its kernel is ``csrc/qmatmul_int8.cu``: int8
  tensor cores in persistent blocks that keep a column chunk's weights,
  packed k-contiguous by ``pack_weights_1x1`` (once, at deploy time), in
  shared memory and quantize each x element once, with ``cp.async`` loads
  of the next tile of x under the mma steps; ``_k3_plan`` picks its
  tiling and grid per call.
- K4, ``fused_qact_matmul``: fake-quantized x times float32 weights, full
  float32 (no TF32), plus bias (the activation-quantized 1x1x1 convs off the
  int8 path: the mixed deployment and fq mode), run by
  ``qconv1x1_ndhwc``.  Its kernel is ``csrc/qmatmul_f32.cu``: a
  register-tiled SGEMM whose persistent blocks keep a column chunk's
  weights in shared memory and fake-quantize each x element once, with
  ``cp.async`` loads of the next slice of x under the FMAs;
  ``_k4_plan`` picks its tiling and grid per call.
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
import functools
from typing import NamedTuple, Tuple

import torch

from .. import ops
from ..quant import act_codes, fake_quant_act
from . import alpha_arg, on_device, vector_arg
from .build import SMEM_BLOCK, SMEM_SM, SMS

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_F32 = dict(dtype=torch.float32)
_X_DTYPES = (torch.float32, torch.bfloat16)


def fused_int8_matmul_reference(x, w_codes, bias, alpha_act, scale,
                                qlvl_act: int, w_packed=None,
                                act_k: int = 0):
    """Plain K3: ``act_codes`` of x (on the offset grid ``act_k`` where it
    is not 0), an exact integer matmul in the float type that
    ``nnir.int_conv_dtype`` picks for codes of at most 127, then ``*
    scale`` and ``+ bias`` rounded separately in float32 (the port's int8
    1x1 route of ``nnir._eval_conv``).  ``w_packed`` is ignored."""
    from ..nnir import int_conv_dtype

    qa = act_codes(x, alpha_act, qlvl_act, act_k)
    dt = int_conv_dtype(1, w_codes.shape[0], qlvl_act, 128)
    with ops.exact_f32():
        y = torch.matmul(qa.to(dt), w_codes.to(dt)).to(torch.float32)
    y = y * torch.as_tensor(scale, device=y.device, **_F32)
    return y if bias is None else y + bias


def fused_int8_matmul(x, w_codes, bias, alpha_act, scale, qlvl_act: int,
                      w_packed=None, act_k: int = 0):
    """y = (int8_codes(x) @ w_codes) * scale + bias, one kernel.

    x: (M, K) float32 or bfloat16 (codes taken in float32, on the offset
    grid ``act_k`` where it is not 0); w_codes: (K, N) int8; scale: () or
    (N,) float32, alpha_act * alpha_w / ((na-1)(nw-1)); bias: (N,) or None;
    w_packed: ``pack_weights_1x1(w_codes)``, made at deploy time (packed
    here when None).  Returns (M, N) float32.  One launch for any K: a K
    whose rows do not fit a block's shared memory at once is walked in
    chunks inside the kernel (``K3Plan.kc``)."""
    if x.device.type == "cpu":
        return fused_int8_matmul_reference(x, w_codes, bias, alpha_act,
                                           scale, qlvl_act, act_k=act_k)
    if x.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    return _launch_int8(x, w_codes, bias, alpha_act, scale, qlvl_act,
                        w_packed, act_k=act_k)


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
    if x.is_cuda:
        return _launch_f32(x, w, bias, alpha_act, qlvl_act)
    if x.device.type == "cpu":
        return fused_qact_matmul_reference(x, w, bias, alpha_act, qlvl_act)
    raise ValueError(f"K4 runs on CUDA or (plain) CPU tensors, got "
                     f"{x.device}")


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


class _K4Call(ctypes.Structure):
    """One K4 call's shape and plan, laid out as ``K4Call`` of
    ``csrc/qmatmul_f32.cu``."""
    _fields_ = [("M", _I), ("K", _I), ("N", _I), ("delta", _F),
                ("x_bf16", _I), ("nc", _I), ("rn", _I), ("grid_x", _I)]


@functools.lru_cache(maxsize=None)
def _f32_lib():
    return _lib("qmatmul_f32.cu", "qmatmul_f32_launch",
                [_P] * 4 + [_F, _P, ctypes.POINTER(_K4Call), _P])


# K4's fixed sizes (csrc/qmatmul_f32.cu): threads per block, K per step
_K4_THREADS, _K4_BK = 256, 32
# a thread's tile of y, 4 rows by RN quads of columns, and its FMA rate
# relative to 4 x 8 (fewer FMAs per float4 operand read from shared
# memory).  An 8 x 4 tile measured 1-4 % slower than 4 x 8 at the flagship
# shapes (scripts/k4_timing.py --sweep) and was dropped.
_K4_TILES = {2: 1.0, 1: 0.8}


class K4Plan(NamedTuple):
    nc: int                 # columns of y per block (a column chunk)
    rn: int                 # column quads per thread
    bm: int                 # rows per tile
    grid: Tuple[int, int]   # (persistent blocks per chunk, column chunks)
    threads: int            # per block
    smem: int               # dynamic shared memory per block, bytes


def _k4_smem(k, nc, bm, elt):
    """Shared memory of one K4 block, as the launch computes it: the
    chunk's weights (K rounded up to 32 rows), two fake-quantized k-major
    tiles and two slices of raw x rows (32 elements + 16 bytes each)."""
    kp = -(-k // _K4_BK) * _K4_BK
    raw = -(-(bm * (_K4_BK * elt + 16)) // 128) * 128
    return 4 * kp * nc + 8 * _K4_BK * bm + 2 * raw


def _k4_candidates(m, k, n, bf16):
    """Every tiling K4 takes for one call, as ((work, column chunks,
    -quads), K4Plan) pairs: ``nc`` a power of two from 32 to 256 no wider
    than N needs, each thread tile of ``_K4_TILES``, shared memory within
    a block.  Work is the busiest SM's: the waves of tiles times chunks
    over the SMs (two blocks at once per SM where shared memory allows),
    each tile's bm x nc x K FMAs at the tile's rate."""
    elt = 2 if bf16 else 4
    kp = -(-k // _K4_BK) * _K4_BK
    widest = max(32, 1 << (n - 1).bit_length())
    for nc in (32, 64, 128, 256):
        if nc > widest:
            break
        chunks = -(-n // nc)
        for rn, rate in _K4_TILES.items():
            tx = nc // (4 * rn)
            bm = (_K4_THREADS // tx) * 4
            smem = _k4_smem(k, nc, bm, elt)
            if smem > SMEM_BLOCK:
                continue
            tiles = -(-m // bm)
            per_sm = max(1, min(2, SMEM_SM // (smem + 1024)))
            # an SM needs two blocks to hide its latencies: one block alone
            # runs a wave in the time two take together
            waves = -(-tiles * chunks // (SMS * per_sm))
            work = waves * bm * nc * kp / rate
            gx = min(tiles, max(1, SMS * per_sm // chunks))
            yield ((work, chunks, -rn),
                   K4Plan(nc, rn, bm, (gx, chunks), _K4_THREADS, smem))


@functools.lru_cache(maxsize=1024)
def _k4_plan(m, k, n, bf16) -> K4Plan:
    """K4's tiling of one call, as the launch takes it.

    A block owns ``nc`` columns and walks row tiles of ``bm`` rows; each
    thread holds 4 x (4 rn) sums.  Of ``_k4_candidates``, the one with
    the least work on the busiest SM wins, then the one with fewer column
    chunks (x read fewer times), then the larger thread tile.  ``grid[0]``
    is as many blocks per chunk as the SMs hold at once (persistent
    blocks), at most one per tile.  Raises when even a 32-column chunk's
    weights do not fit a block."""
    best = min(_k4_candidates(m, k, n, bf16), key=lambda c: c[0],
               default=None)
    if best is None:
        raise ValueError(f"K4 keeps a block's weights in shared memory: "
                         f"K = {k} rows of 32 columns do not fit")
    return best[1]


# K3's fixed sizes (csrc/qmatmul_int8.cu): warps per block, the mma depth
_K3_WARPS, _K3_BK = 8, 32


def pack_weights_1x1(w_codes: torch.Tensor) -> torch.Tensor:
    """(K, N) (or (1, 1, 1, K, N)) int8 weight codes -> K3's (N, Kp) int8
    layout, ``packed[n, k] = w_codes[k, n]``: k contiguous (the mma's B
    fragment runs along k), zero-padded to Kp = 32 * ceil(K / 32), one mma
    depth."""
    w = w_codes.reshape(-1, w_codes.shape[-1])
    k, n = w.shape
    out = w.new_zeros((n, -(-k // _K3_BK) * _K3_BK))
    out[:, :k] = w.t()
    return out


class K3Plan(NamedTuple):
    bm: int                 # rows per tile
    nc: int                 # columns of y per block (a column chunk)
    mt: int                 # 16-row mma tiles per warp
    nt: int                 # 8-column mma tiles per warp
    wn: int                 # warps along the columns
    stages: int             # raw x slices in the cp.async ring
    grid: Tuple[int, int]   # (persistent blocks per chunk, column chunks)
    threads: int            # per block
    smem: int               # dynamic shared memory per block, bytes
    kc: int = 0             # K per chunk of a tile's steps; 0: all of K


def _k3_smem(k, bm, nc, stages, elt, kc=0):
    """Shared memory of one K3 block, as the launch computes it: the
    column chunk's packed weights (rows of Kp + 16 bytes), the code tile
    (rows of kc + 16 bytes), the ring of raw x slices (rows of kc elements
    + 16 bytes), scale and bias; ``kc`` 0 is all of Kp."""
    kp = -(-k // _K3_BK) * _K3_BK
    kc = kc or kp
    raw = -(-(bm * (kc * elt + 16)) // 128) * 128
    return (-(-(nc * (kp + 16) + bm * (kc + 16)) // 128) * 128
            + stages * raw + 8 * nc)


# K3's cost model (_k3_candidates), in ns and bytes/ns, set by hand from
# the device times of every tiling that scripts/k3_timing.py --sweep gave
# at the twelve phase-5 shapes on an H100 (PERF.md section 6, PR 7): one
# SM's rate of device-memory traffic (x and y), a tile's least time, a
# block's fixed time, and the rate at which a block stages its weights
_K3_SM_RATE, _K3_TILE_NS, _K3_BLOCK_NS, _K3_W_RATE = 15.0, 2500.0, 1000.0, 25.0


def _k3_candidates(m, k, n, bf16, kc=0):
    """Every tiling K3 takes for one call with chunks of ``kc`` (0: all
    of K), as ((work, column chunks, -rows, -mt, stages), K3Plan) pairs:
    the 8 warps as wm x wn, a warp's mt x nt mma tiles (at most 8), nc = 8
    wn nt up to 256 and, with nt > 1, less than twice N (rounded up to 8),
    a ring of 2-4 raw slices, shared memory within a block (up to three
    blocks an SM).  Work is the busiest block's time: its tiles, each the
    longer of its bytes at the SM's rate (shared by the blocks on the SM)
    and the least tile time; plus its fixed time and weights."""
    elt = 2 if bf16 else 4
    kp = -(-k // _K3_BK) * _K3_BK
    n8 = -(-n // 8) * 8
    for wn in (1, 2, 4, 8):
        wm = _K3_WARPS // wn
        for nt in (1, 2, 4, 8):
            nc = 8 * wn * nt
            if nc > 256 or (nt > 1 and nc >= 2 * n8):
                continue
            chunks = -(-n // nc)
            for mt in (1, 2):
                bm = 16 * wm * mt
                if mt * nt > 8:
                    continue
                for stages in (2, 3, 4):
                    smem = _k3_smem(k, bm, nc, stages, elt, kc)
                    if smem > SMEM_BLOCK:
                        continue
                    tiles = -(-m // bm)
                    per_sm = max(1, min(3, SMEM_SM // (smem + 1024)))
                    gx = min(tiles, -(-SMS * per_sm // chunks))
                    # blocks sharing an SM's memory rate
                    busy = min(per_sm, -(-gx * chunks // SMS))
                    tile_bytes = bm * k * elt + bm * min(nc, n) * 4
                    tile = max(tile_bytes * busy / _K3_SM_RATE, _K3_TILE_NS)
                    work = (_K3_BLOCK_NS + nc * kp / _K3_W_RATE
                            + -(-tiles // gx) * tile)
                    yield ((work, chunks, -bm, -mt, stages),
                           K3Plan(bm, nc, mt, nt, wn, stages, (gx, chunks),
                                  32 * _K3_WARPS, smem, kc))


# the chunks of K that a plan tries, largest first, where a block's rows
# of all of K do not fit its shared memory
_K3_CHUNKS = (1024, 512, 256, 128, 64, 32)


@functools.lru_cache(maxsize=1024)
def _k3_plan(m, k, n, bf16) -> K3Plan:
    """K3's tiling of one call, as the launch takes it: of
    ``_k3_candidates``, the least work on the busiest block, then fewer
    column chunks (x read fewer times), larger tiles, taller warp tiles
    (measured faster at every B = 8 shape) and fewer raw slices.
    ``grid[0]`` is as many blocks per chunk as the SMs hold at once
    (persistent blocks), at most one per tile.  All of K at once where
    some tiling fits a block, else the largest chunk of ``_K3_CHUNKS``
    that does.  Raises when a block cannot hold the weights of all of K
    for 8 columns."""
    kp = -(-k // _K3_BK) * _K3_BK
    for kc in (0, *(c for c in _K3_CHUNKS if c < kp)):
        best = min(_k3_candidates(m, k, n, bf16, kc), key=lambda c: c[0],
                   default=None)
        if best is not None:
            return best[1]
    raise ValueError(f"K3 keeps a block's weights in shared memory: K = "
                     f"{k} does not fit")


class _K3Call(ctypes.Structure):
    """One K3 call's shape and plan, laid out as ``K3Call`` of
    ``csrc/qmatmul_int8.cu``."""
    _fields_ = [(f, _I) for f in ("M", "K", "N", "qlvl", "x_bf16", "bm",
                                  "nc", "mt", "nt", "wn", "stages", "grid_x",
                                  "act_k", "kc")]


@functools.lru_cache(maxsize=1024)
def _k3_call(m, k, n, bf16, qlvl, plan=None, act_k=0):
    """The launch's ``_K3Call``: the shape, qlvl, x_bf16, ``plan`` (by
    default ``_k3_plan``'s, its chunk of K included) and the offset grid's
    shift ``act_k``."""
    if not act_k and not 2 <= qlvl <= 128:
        raise ValueError(f"qlvl_act {qlvl}: int8 codes need 2..128")
    if not (2 <= qlvl and 0 <= act_k <= 128 and qlvl - 1 - act_k <= 127):
        raise ValueError(f"qlvl_act {qlvl}, act_k {act_k}: offset codes "
                         f"-act_k..qlvl-1-act_k need -128..127")
    p = plan or _k3_plan(m, k, n, bf16)
    return _K3Call(m, k, n, qlvl, int(bf16), p.bm, p.nc, p.mt, p.nt, p.wn,
                   p.stages, p.grid[0], act_k, p.kc)


@functools.lru_cache(maxsize=None)
def _int8_lib():
    return _lib("qmatmul_int8.cu", "qmatmul_int8_launch",
                [_P, _P, _P, _F, _I, _P, _P, _F, _P,
                 ctypes.POINTER(_K3Call), _P])


def _check_x(x, what, aligned=True):
    """x as a contiguous 2-d float32/bfloat16 tensor; with ``aligned``, one
    whose data starts on a 16-byte boundary (a copy if it does not)."""
    if x.dim() != 2 or x.dtype not in _X_DTYPES or x.numel() == 0:
        raise ValueError(f"{what} needs a non-empty (M, K) float32 or "
                         f"bfloat16 x, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    return x.clone() if aligned and x.data_ptr() % 16 else x


def _scale(scale, n, like):
    """(float32 tensor or None, value, stride) of K3's scale: one value on
    the device of tensor ``like`` passes by pointer with stride 0 (not
    expanded), one elsewhere (or a number) by value, an (n,) vector by
    pointer with stride 1; nothing is copied to the card for a number."""
    t = scale if isinstance(scale, torch.Tensor) else torch.as_tensor(scale)
    if t.numel() == 1:
        if t is not scale or t.get_device() != like.get_device():
            return None, float(t), 0
        return (t if t.dtype == torch.float32 else t.float()), 0.0, 0
    return vector_arg(t, n, like, "scale"), 0.0, 1


def _launch_int8(x, w_codes, bias, alpha_act, scale, qlvl_act,
                 w_packed=None, plan=None, act_k=0):
    """K3 on the card, with ``plan`` (by default ``_k3_plan``'s).  Lean on
    the host: device indices, not device objects; the shape and plan
    passed as one cached struct; the weights packed at deploy time; alpha,
    scale and bias taken as they are when they are already on the card as
    float32, a one-value scale by pointer with stride 0, numbers by value;
    so a call can be captured in a CUDA graph."""
    x = _check_x(x, "K3", aligned=False)  # the kernel stages any alignment
    index = x.get_device()
    m, k = x.shape
    if (w_codes.dtype != torch.int8 or w_codes.dim() != 2
            or w_codes.shape[0] != k or w_codes.get_device() != index):
        raise ValueError(f"weight codes {w_codes.dtype} "
                         f"{tuple(w_codes.shape)} on {w_codes.device} do not "
                         f"fit x {tuple(x.shape)} on {x.device}")
    n = w_codes.shape[1]
    if w_packed is None:
        w_packed = pack_weights_1x1(w_codes)
    kp = -(-k // _K3_BK) * _K3_BK
    # (a packed copy that is not 16-byte aligned the launch refuses)
    if (w_packed.dtype != torch.int8 or w_packed.shape != (n, kp)
            or w_packed.get_device() != index
            or not w_packed.is_contiguous()):
        raise ValueError(f"packed weights {w_packed.dtype} "
                         f"{tuple(w_packed.shape)} on {w_packed.device}: "
                         f"pack_weights_1x1 gives ({n}, {kp}) int8 on "
                         f"{x.device}")
    scale_t, scale_v, scale_stride = _scale(scale, n, x)
    bias_v = vector_arg(bias, n, x, "bias")
    alpha, alpha_v = alpha_arg(alpha_act, x)
    call = _k3_call(m, k, n, x.dtype == torch.bfloat16, int(qlvl_act), plan,
                    int(act_k))
    y = x.new_empty((m, n), dtype=torch.float32)
    rc = on_device(index, _int8_lib(), x.data_ptr(), w_packed.data_ptr(),
                    None if scale_t is None else scale_t.data_ptr(), scale_v,
                    scale_stride,
                    None if bias_v is None else bias_v.data_ptr(),
                    None if alpha is None else alpha.data_ptr(), alpha_v,
                    y.data_ptr(), call)
    if rc != 0:
        raise RuntimeError(
            f"K3 launch failed: cudaError_t {rc} ("
            + ", ".join(f"{f} {getattr(call, f)}" for f, _ in call._fields_)
            + ")")
    fused_int8_matmul.launches += 1
    return y


@functools.lru_cache(maxsize=1024)
def _k4_call(m, k, n, bf16, qlvl, plan=None):
    """The launch's ``_K4Call``: the shape, delta, x_bf16 and ``plan`` (by
    default ``_k4_plan``'s).  delta is rounded once, from the double
    1 / (qlvl - 1), as the JAX kernel's Python float enters its float32
    arithmetic."""
    if qlvl < 2:
        raise ValueError(f"qlvl_act {qlvl}: need at least 2 levels")
    plan = plan or _k4_plan(m, k, n, bf16)
    return _K4Call(m, k, n, 1.0 / (qlvl - 1), int(bf16), plan.nc, plan.rn,
                   plan.grid[0])


def _launch_f32(x, w, bias, alpha_act, qlvl_act, plan=None):
    """K4 on the card, with ``plan`` (by default ``_k4_plan``'s).  Lean on
    the host: device indices, not device objects; the shape and plan passed
    as one cached struct; alpha and bias taken as they are when they are
    already on the card as float32."""
    x = _check_x(x, "K4", aligned=False)  # the kernel stages any alignment
    index = x.get_device()
    m, k = x.shape
    if (w.dtype != torch.float32 or w.dim() != 2 or w.shape[0] != k
            or w.get_device() != index):
        raise ValueError(f"weights {w.dtype} {tuple(w.shape)} on {w.device} "
                         f"do not fit x {tuple(x.shape)} on {x.device}")
    n = w.shape[1]
    w = w.contiguous()
    bias_v = vector_arg(bias, n, x, "bias")
    alpha, alpha_v = alpha_arg(alpha_act, x)
    call = _k4_call(m, k, n, x.dtype == torch.bfloat16, int(qlvl_act), plan)
    y = x.new_empty((m, n), dtype=torch.float32)
    rc = on_device(index, _f32_lib(), x.data_ptr(), w.data_ptr(),
                    None if bias_v is None else bias_v.data_ptr(),
                    None if alpha is None else alpha.data_ptr(), alpha_v,
                    y.data_ptr(), call)
    if rc != 0:
        raise RuntimeError(
            f"K4 launch failed: cudaError_t {rc} ("
            + ", ".join(f"{f} {getattr(call, f)}" for f, _ in call._fields_)
            + ")")
    fused_qact_matmul.launches += 1
    return y
