"""K2: the space-to-depth stem conv, and its host-side helpers.

Counterpart of the JAX package's ``pallas/stem.py``.  The network's init
conv is a 3x3x3 stride-2 conv on the raw C-channel volume.  It equals a
stride-1 2x2x2 conv on the space-to-depth transform of the input (each
2x2x2 phase block becomes 8C channels, the kernel taps redistributed over
the phases; 27 of the 64 slots of the dense 2^3 kernel are nonzero).  The
chain

    s2d(volume) -> patches -> conv + bias + relu -> (activation, int8 codes)

runs as one transform, one patch extraction and the fused kernel
``stem_s2d_conv``, whose dual output feeds the residual stream (the
activation at the compute dtype) and the first int8 conv (its codes).

Grid alignment: H/W patch starts must be even; z starts may be odd.
Odd-start patches read the same s2d volume with the z taps' phase roles
swapped (a second weight layout, chosen per patch by a parity) plus a
phase-lane mask on the first output plane; even-start patches carry a
physical zero plane there.  The patch grid stays the reference's rule.

``stem_s2d_conv`` launches the hand-written CUDA kernel ``csrc/stem_s2d.cu``
for CUDA tensors (bf16 ``mma.sync``, float32 accumulation; blocks own a
band of output rows of one patch and walk its planes through a
shared-memory ring, so each s2d plane is read once per band; the weights
come packed by ``pack_stem_weights`` at deploy time and ``_k2_plan``
picks the bands and z chunks; its header says what bounds it), and takes
the plain PyTorch version ``stem_s2d_conv_reference`` for tensors on the
CPU only.  Each launch adds one to ``stem_s2d_conv.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from . import alpha_arg, on_device, vector_arg
from .build import SMEM_BLOCK, SMEM_SM, SMS

# (tap, phase) -> original kernel index along one axis, for a patch whose
# start is even / odd on that axis.  Output voxel z' taps original offsets
# 2z'+k-1 (k in 0..2); in (plane u, phase p) coordinates, with a leading
# zero plane for the even case, both cases read planes {t, t+1} at t = z'.
# A missing key is a structurally zero slot.
_MAP_EVEN = {(0, 1): 0, (1, 0): 1, (1, 1): 2}
_MAP_ODD = {(0, 0): 0, (0, 1): 1, (1, 0): 2}


def s2d_stem_weights(w3: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(3, 3, 3, C, O) stem kernel -> two (2, 32C, O) s2d-space weight
    matrices (even- and odd-z-start patch variants), NumPy in and out.

    Row order within a kd2 tap: (kh2, kw2, pz, py, px, c); the s2d channel
    index is ((pz*2+py)*2+px)*C + c."""
    w3 = np.asarray(w3)
    kd, kh, kw, c, o = w3.shape
    if (kd, kh, kw) != (3, 3, 3):
        raise ValueError(f"stem kernel {w3.shape} is not 3x3x3")

    def build(mz):
        w2 = np.zeros((2, 2, 2, 2, 2, 2, c, o), w3.dtype)
        for (kd2, pz), k0 in mz.items():
            for (kh2, py), k1 in _MAP_EVEN.items():
                for (kw2, px), k2 in _MAP_EVEN.items():
                    w2[kd2, kh2, kw2, pz, py, px] = w3[k0, k1, k2]
        return w2.reshape(2, 2 * 2 * 8 * c, o)

    return build(_MAP_EVEN), build(_MAP_ODD)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16, rounded to nearest even, with JAX's bits for
    NaN: the quiet NaN of the same sign (0x7FC0 / 0xFFC0), where PyTorch's
    own cast gives 0xFFFF on the CPU and 0x7FFF on a card.  Infinities and
    finite values are the cast's."""
    y = x.to(torch.bfloat16)
    nan = _nan_bits(x.device)
    return torch.where(torch.isnan(x),
                       torch.where(torch.signbit(x), nan[1], nan[0]), y)


@functools.lru_cache(maxsize=None)
def _nan_bits(device) -> torch.Tensor:
    """JAX's bfloat16 quiet NaNs (+, -) on ``device``, uploaded once."""
    return torch.tensor([0x7FC0, -0x40], dtype=torch.int16,
                        device=device).view(torch.bfloat16)


def s2d_volume(image: torch.Tensor, min_planes: int = 0,
               dtype=torch.bfloat16) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, ceil(D/2), H/2, W/2, 8C) space-to-depth, on
    the image's device, zero-padding D to even (and to ``min_planes``
    planes, for odd-start patches whose last tap reaches one plane past
    ceil(D/2)).  The cast comes first (it is elementwise, so the bits are
    those of casting after the shuffle) to halve the shuffled bytes."""
    n, d, h, w, c = image.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d needs even H and W, got {(h, w)}")
    x = to_bf16(image) if dtype == torch.bfloat16 else image.to(dtype)
    dp = max(d + d % 2, 2 * min_planes)
    if dp != d:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, dp - d))
    x = x.reshape(n, dp // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(n, dp // 2, h // 2, w // 2, 8 * c)


def s2d_supported(starts, patch_size, vol_shape, attrs) -> bool:
    """The s2d path covers the standard stem geometry: 3^3 stride-2 pad-1
    dense conv, even patch dims, even H/W extents and grid starts."""
    pd, ph, pw = patch_size
    return (attrs["kernel_size"] == (3, 3, 3)
            and attrs["stride"] == (2, 2, 2)
            and attrs["padding"] == (1, 1, 1)
            and attrs["dilation"] == (1, 1, 1) and attrs["groups"] == 1
            and pd % 2 == 0 and ph % 2 == 0 and pw % 2 == 0
            and vol_shape[1] % 2 == 0 and vol_shape[2] % 2 == 0
            and all(j % 2 == 0 and k % 2 == 0 for (_, j, k) in starts))


def s2d_need_planes(starts, patch_size) -> int:
    """s2d planes this grid reads (odd-z-start patches read one plane past
    ceil(D/2)): the ``min_planes`` of the transform."""
    pd = patch_size[0]
    return max(((i - 1) // 2 + pd // 2 + 1) for (i, _, _) in starts)


def extract_pre_s2d_patches(svol: torch.Tensor, starts, patch_size
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``extract_s2d_patches`` for a volume already in s2d space (made by
    ``s2d_volume(image, s2d_need_planes(starts, patch_size))``)."""
    need = s2d_need_planes(starts, patch_size)
    if svol.shape[1] < need:
        raise ValueError(f"s2d volume {tuple(svol.shape)} has fewer than "
                         f"the {need} planes this grid reads: pass "
                         f"min_planes=s2d_need_planes(...) to s2d_volume")
    return _slice_s2d(svol, starts, patch_size)


def extract_s2d_patches(image: torch.Tensor, starts, patch_size
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patch grid extracted directly in s2d space.

    Returns (patches (P*N, pd/2+1, ph/2, pw/2, 8C) bfloat16, parities
    (P*N,) int32).  Each patch carries pd/2+1 planes: planes t and t+1 are
    the z taps of output plane t.  Even-z-start patches begin with a
    physical zero plane (their kd=0 tap at z'=0 is the conv's zero
    padding); odd-z-start patches start one plane early in real data, which
    the kernel masks.  The serving loop's s2d extraction
    (``ptq.deploy.s2d_extract_fn``)."""
    svol = s2d_volume(image, min_planes=s2d_need_planes(starts, patch_size))
    return _slice_s2d(svol, starts, patch_size)


def _slice_s2d(svol: torch.Tensor, starts, patch_size
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    pd, ph, pw = patch_size
    n = svol.shape[0]
    out = svol.new_empty((len(starts), n, pd // 2 + 1, ph // 2, pw // 2,
                          svol.shape[-1]))
    for p, (i, j, k) in enumerate(starts):
        js, ks = j // 2, k // 2
        if i % 2 == 0:
            out[p, :, 0] = 0
            out[p, :, 1:] = svol[:, i // 2:i // 2 + pd // 2,
                                 js:js + ph // 2, ks:ks + pw // 2]
        else:
            out[p] = svol[:, (i - 1) // 2:(i - 1) // 2 + pd // 2 + 1,
                          js:js + ph // 2, ks:ks + pw // 2]
    parities = _parities(tuple(i % 2 for (i, _, _) in starts), n,
                         svol.device)
    return out.reshape(-1, *out.shape[2:]), parities


@functools.lru_cache(maxsize=16)
def _parities(parity, n, device) -> torch.Tensor:
    """The (P*N,) int32 z-start parities of a grid on ``device``, made
    once per grid (read-only: every volume of the grid shares them)."""
    return torch.tensor(np.repeat(parity, n), dtype=torch.int32,
                        device=device)


def pack_stem_weights(w_even: torch.Tensor,
                      w_odd: torch.Tensor) -> torch.Tensor:
    """The two (2, 4 C8, O) s2d weight matrices of ``s2d_stem_weights``
    -> K2's shared-memory layout, (2, O, 8 C8p) bfloat16 on their device:
    ``packed[p, o, tap * C8p + c8] = w_p[kd2][(kh2 * 2 + kw2) * C8 + c8][o]``
    with tap = (kd2 * 2 + kh2) * 2 + kw2 and parity p (0 even, 1 odd); k
    contiguous (the mma's B fragment runs along k), each tap zero-padded
    from C8 to C8p = 16 * ceil(C8 / 16), one mma depth."""
    _, k4, o = w_even.shape
    c8 = k4 // 4
    out = w_even.new_zeros((2, o, 8, -(-c8 // 16) * 16),
                           dtype=torch.bfloat16)
    for p, w in enumerate((w_even, w_odd)):
        out[p, :, :, :c8] = w.reshape(8, c8, o).permute(2, 0, 1)
    return out.reshape(2, o, -1)


def stem_s2d_conv_reference(x, parities, w_even, w_odd, bias, alpha_next,
                            qlvl_next: int, out_dtype=torch.float32,
                            w_packed=None):
    """Plain PyTorch K2, on any device, with the wrapper's signature
    (``w_packed`` is ignored).

    The odd-parity mask, then the zero-padded 2^3 conv of each s2d patch
    with its parity's weights, accumulated in float64 and rounded once to
    float32; then + bias, relu, the cast to ``out_dtype`` and the int8
    codes of the cast value, in float32 as the Pallas kernel does."""
    b, d1, h, w, c8 = x.shape
    o = w_even.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    xs = x.to(torch.float64)
    odd = parities.to(x.device) != 0
    # odd patches: plane 0 is read only by output plane 0's kd2 = 0 tap,
    # whose pz = 0 phase lanes fall on the conv's zero padding
    xs[odd, 0, :, :, :c8 // 2] = 0
    # the leading zero row and column that taps kh2 = 0 / kw2 = 0 of
    # output row 0 / column 0 read
    xs = F.pad(xs, (0, 0, 1, 0, 1, 0))
    acc = torch.zeros((b, d1 - 1, h, w, o), dtype=torch.float64,
                      device=x.device)
    for sel, wts in ((~odd, w_even), (odd, w_odd)):
        idx = torch.nonzero(sel).flatten()
        if idx.numel():
            k = wts.to(device=x.device, dtype=torch.float64)
            acc[idx] = ops.conv3d(xs[idx], k.reshape(2, 2, 2, c8, o))
    y = torch.clamp_min(acc.to(torch.float32) + bias.to(**f32), 0.0)
    yd = y.to(out_dtype)
    q = torch.clamp(yd.to(torch.float32) / torch.as_tensor(alpha_next, **f32),
                    0.0, 1.0) * (qlvl_next - 1)
    return yd, torch.round(q).to(torch.int8)


def stem_s2d_conv(x, parities, w_even, w_odd, bias, alpha_next,
                  qlvl_next: int, out_dtype=torch.float32, w_packed=None):
    """Fused s2d stem: (relu(conv(x) + bias) as ``out_dtype``, the int8
    codes of that value for the consumer conv).

    x: (B, D+1, H, W, 8C) bfloat16 s2d patches from ``extract_s2d_patches``;
    parities: (B,) int32 z-start parity per patch; w_even / w_odd:
    (2, 32C, O) bfloat16 from ``s2d_stem_weights``; bias: (O,);
    alpha_next / qlvl_next: the consumer conv's activation quantizer;
    w_packed: ``pack_stem_weights(w_even, w_odd)``, made at deploy time
    (packed here when None).  Returns two (B, D, H, W, O) tensors."""
    if x.device.type == "cpu":
        return stem_s2d_conv_reference(x, parities, w_even, w_odd, bias,
                                       alpha_next, qlvl_next, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    return _launch(x, parities, w_even, w_odd, bias, alpha_next, qlvl_next,
                   out_dtype, w_packed)


stem_s2d_conv.launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int

# K2's fixed sizes (csrc/stem_s2d.cu): warps per block, planes in the ring,
# output channels per chunk of O
_K2_WARPS, _K2_SLOTS, _K2_BN = 8, 3, 32
# K2's cost model (_k2_candidates), in ns and bytes/ns, set by hand from
# the device times of every tiling that scripts/k2_timing.py --sweep gave
# at the flagship on an H100 (PERF.md section 6): a plane's latency
# per round of 32-voxel groups over the block's 8 warps (and per 32
# output channels), the rate at which one SM moves a plane's bytes (shared
# by the blocks on it), and a block's fixed time (its weights and first
# planes)
_K2_PLANE_NS, _K2_SM_RATE, _K2_BLOCK_NS = 3200.0, 38.0, 2000.0


class K2Plan(NamedTuple):
    rows: int               # output rows per band
    zc: int                 # output planes per z chunk
    grid: Tuple[int, int]   # (bands x z chunks, patches)
    threads: int            # per block
    smem: int               # dynamic shared memory per block, bytes


def _k2_smem(w, c8, o, rows):
    """Shared memory of one K2 block, as the launch computes it: the
    parity's weights (rows of 8 C8p + 8 bf16), the bias and the ring of
    three plane tiles of (rows + 1) x (W + 1) voxels of C8p + 8 bf16."""
    c8p = -(-c8 // 16) * 16
    op = -(-o // _K2_BN) * _K2_BN

    def up(v):
        return -(-v // 128) * 128

    off_ring = up(up(op * (8 * c8p + 8) * 2) + 4 * op)
    return off_ring + _K2_SLOTS * up((rows + 1) * (w + 1) * (c8p + 8) * 2)


def _k2_candidates(b, d, h, w, c8, o, out_bytes=2, sms=SMS):
    """Every tiling K2 takes for one call, as ((work, blocks, -rows),
    K2Plan) pairs: bands of 1, 2, 4, 8 or 16 rows (at most H), z chunks
    of ceil(D / n) planes for n in 1, 2, 3, 4, 6, 8, 12, 16 (each chunk
    count once), shared memory within a block.  Work is the busiest SM's
    time: its waves of blocks (two at once where shared memory allows),
    each block's fixed time plus, per plane, its warps' latency and its
    bytes at the SM's rate, shared by the blocks on the SM."""
    seen = set()
    for rows in (1, 2, 4, 8, 16):
        if rows > h and rows != 1:
            break
        smem = _k2_smem(w, c8, o, rows)
        if smem > SMEM_BLOCK:
            break
        per_sm = max(1, min(2, SMEM_SM // (smem + 1024)))
        bands = -(-h // rows)
        groups = -(-(rows * w) // 32)  # 32-voxel groups of a band
        rounds = -(-groups // _K2_WARPS) * -(-o // _K2_BN)
        plane_bytes = (rows + 1) * w * c8 * 2 + rows * w * o * (out_bytes + 1)
        for n in (1, 2, 3, 4, 6, 8, 12, 16):
            zc = -(-d // n)
            chunks = -(-d // zc)
            if (rows, chunks) in seen:
                continue
            seen.add((rows, chunks))
            blocks = b * bands * chunks
            busy = min(per_sm, -(-blocks // sms))
            waves = -(-blocks // (sms * per_sm))
            plane_ns = (rounds * _K2_PLANE_NS
                        + plane_bytes * busy / _K2_SM_RATE)
            work = waves * (_K2_BLOCK_NS + (zc + 1) * plane_ns)
            yield ((work, blocks, -rows),
                   K2Plan(rows, zc, (bands * chunks, b), 32 * _K2_WARPS,
                          smem))


@functools.lru_cache(maxsize=1024)
def _k2_plan(b, d, h, w, c8, o, sm_count=SMS, out_bytes=2) -> K2Plan:
    """K2's tiling of one call, as the launch takes it: of
    ``_k2_candidates``, the least work on the busiest SM, then fewer
    blocks, then taller bands.  Raises when even a one-row band does not
    fit a block's shared memory."""
    best = min(_k2_candidates(b, d, h, w, c8, o, out_bytes, sm_count),
               key=lambda c: c[0], default=None)
    if best is None:
        raise ValueError(f"K2 keeps a block's weights and three plane tiles "
                         f"in shared memory: W = {w}, C8 = {c8}, O = {o} "
                         f"do not fit")
    return best[1]


class _K2Call(ctypes.Structure):
    """One K2 call's shape and plan, laid out as ``K2Call`` of
    ``csrc/stem_s2d.cu``."""
    _fields_ = [(f, _I) for f in ("B", "D", "H", "W", "C8", "O", "qlvl",
                                  "out_bf16", "rows", "zc")]


@functools.lru_cache(maxsize=1024)
def _k2_call(b, d, h, w, c8, o, qlvl, out_bf16, plan=None):
    """The launch's ``_K2Call`` for one shape (checked once per shape):
    the shape, qlvl, the output type and ``plan`` (by default
    ``_k2_plan``'s)."""
    if c8 % 8 or d < 1:
        raise ValueError(f"s2d patches with {d + 1} planes and {c8} "
                         f"channels: need 8C channels and at least 2 planes")
    if not 2 <= qlvl <= 128:
        raise ValueError(f"qlvl_next {qlvl}: int8 codes need 2..128")
    p = plan or _k2_plan(b, d, h, w, c8, o, out_bytes=2 if out_bf16 else 4)
    return _K2Call(b, d, h, w, c8, o, qlvl, int(out_bf16), p.rows, p.zc)


@functools.lru_cache(maxsize=None)
def _lib():
    from . import build

    fn = build.load("stem_s2d.cu").stem_s2d_launch
    if fn.argtypes is None:  # ctypes would pass ints as 32-bit
        fn.argtypes = [_P] * 5 + [ctypes.c_float, _P, _P,
                                  ctypes.POINTER(_K2Call), _P]
        fn.restype = _I
    return fn


def _launch(x, parities, w_even, w_odd, bias, alpha_next, qlvl_next,
            out_dtype, w_packed=None, plan=None):
    """K2 on the card, with ``plan`` (by default ``_k2_plan``'s).  Lean on
    the host: the shape checked once and passed with the plan as one
    cached struct; the weights packed at deploy time; parities, bias and
    alpha taken as they are when they are already on the card in the
    kernel's types (alpha by value otherwise); so a call can be captured
    in a CUDA graph."""
    if x.dtype != torch.bfloat16 or x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"K2 needs non-empty 5-d bfloat16 patches, got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    index = x.get_device()
    b, d1, h, w, c8 = x.shape
    o = w_even.shape[-1]
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K2 stores float32 or bfloat16, not {out_dtype}")
    call = _k2_call(b, d1 - 1, h, w, c8, o, int(qlvl_next),
                    out_dtype == torch.bfloat16, plan)
    if w_packed is None:
        for name, wt in (("w_even", w_even), ("w_odd", w_odd)):
            if (wt.dtype != torch.bfloat16 or wt.get_device() != index
                    or tuple(wt.shape) != (2, 4 * c8, o)):
                raise ValueError(f"{name} {wt.dtype} {tuple(wt.shape)} on "
                                 f"{wt.device} does not fit patches "
                                 f"{tuple(x.shape)} -> {o} channels")
        w_packed = pack_stem_weights(w_even, w_odd)
    kp = 8 * (-(-c8 // 16) * 16)
    # (a packed copy that is not 16-byte aligned the launch refuses)
    if (w_packed.dtype != torch.bfloat16 or w_packed.shape != (2, o, kp)
            or w_packed.get_device() != index
            or not w_packed.is_contiguous()):
        raise ValueError(f"packed weights {w_packed.dtype} "
                         f"{tuple(w_packed.shape)} on {w_packed.device}: "
                         f"pack_stem_weights gives (2, {o}, {kp}) bfloat16 "
                         f"on {x.device}")
    if tuple(parities.shape) != (b,):
        raise ValueError(f"parities {tuple(parities.shape)} != ({b},)")
    if (parities.dtype != torch.int32 or parities.get_device() != index
            or not parities.is_contiguous()):
        parities = parities.to(device=x.device, dtype=torch.int32)
    bias_v = vector_arg(bias, o, x, "bias")
    alpha, alpha_v = alpha_arg(alpha_next, x)
    y = x.new_empty((b, d1 - 1, h, w, o), dtype=out_dtype)
    q = x.new_empty((b, d1 - 1, h, w, o), dtype=torch.int8)
    rc = on_device(index, _lib(), x.data_ptr(), parities.data_ptr(),
                    w_packed.data_ptr(), bias_v.data_ptr(),
                    None if alpha is None else alpha.data_ptr(), alpha_v,
                    y.data_ptr(), q.data_ptr(), call)
    if rc != 0:
        raise RuntimeError(
            f"K2 launch failed: cudaError_t {rc} ("
            + ", ".join(f"{f} {getattr(call, f)}" for f, _ in call._fields_)
            + ")")
    stem_s2d_conv.launches += 1
    return y, q
