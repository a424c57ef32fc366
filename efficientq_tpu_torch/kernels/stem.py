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
(bf16 ``mma.sync``, float32 accumulation; its header says what bounds it)
for CUDA tensors, and takes the plain PyTorch version
``stem_s2d_conv_reference`` for tensors on the CPU only.  Each launch adds
one to ``stem_s2d_conv.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops

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
    nan = torch.tensor([0x7FC0, -0x40], dtype=torch.int16,
                       device=x.device).view(torch.bfloat16)
    return torch.where(torch.isnan(x),
                       torch.where(torch.signbit(x), nan[1], nan[0]), y)


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
    ``s2d_volume(image, s2d_need_planes(starts, patch_size))``).  Use with
    ``sliding_window_inference(extract_fn=..., vol_shape=<original>)``."""
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
    the kernel masks."""
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
    parities = torch.tensor(np.repeat([i % 2 for (i, _, _) in starts], n),
                            dtype=torch.int32, device=svol.device)
    return out.reshape(-1, *out.shape[2:]), parities


def stem_s2d_conv_reference(x, parities, w_even, w_odd, bias, alpha_next,
                            qlvl_next: int, out_dtype=torch.float32):
    """Plain PyTorch K2, on any device, with the wrapper's signature.

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
                  qlvl_next: int, out_dtype=torch.float32):
    """Fused s2d stem: (relu(conv(x) + bias) as ``out_dtype``, the int8
    codes of that value for the consumer conv).

    x: (B, D+1, H, W, 8C) bfloat16 s2d patches from ``extract_s2d_patches``;
    parities: (B,) int32 z-start parity per patch; w_even / w_odd:
    (2, 32C, O) bfloat16 from ``s2d_stem_weights``; bias: (O,);
    alpha_next / qlvl_next: the consumer conv's activation quantizer.
    Returns two (B, D, H, W, O) tensors."""
    if x.device.type == "cpu":
        return stem_s2d_conv_reference(x, parities, w_even, w_odd, bias,
                                       alpha_next, qlvl_next, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or (plain) CPU tensors, got "
                         f"{x.device}")
    return _launch(x, parities, w_even, w_odd, bias, alpha_next, qlvl_next,
                   out_dtype)


stem_s2d_conv.launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from . import build

    lib = build.load("stem_s2d.cu")
    fn = lib.stem_s2d_launch
    if fn.argtypes is None:  # ctypes would pass ints as 32-bit
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        fn.restype = _I
    return fn


def _launch(x, parities, w_even, w_odd, bias, alpha_next, qlvl_next,
            out_dtype):
    dev = x.device
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    if x.dtype != torch.bfloat16 or x.dim() != 5 or x.numel() == 0:
        raise ValueError(f"K2 needs non-empty 5-d bfloat16 patches, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, d1, h, w, c8 = x.shape
    o = w_even.shape[-1]
    if c8 % 8 or d1 < 2:
        raise ValueError(f"s2d patches {tuple(x.shape)}: need 8C channels "
                         f"and at least 2 planes")
    for name, wt in (("w_even", w_even), ("w_odd", w_odd)):
        if (wt.dtype != torch.bfloat16 or wt.device != dev
                or tuple(wt.shape) != (2, 4 * c8, o)
                or not wt.is_contiguous()):
            raise ValueError(f"{name} {wt.dtype} {tuple(wt.shape)} on "
                             f"{wt.device} does not fit patches "
                             f"{tuple(x.shape)} -> {o} channels")
    if tuple(parities.shape) != (b,):
        raise ValueError(f"parities {tuple(parities.shape)} != ({b},)")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K2 stores float32 or bfloat16, not {out_dtype}")
    if not 2 <= int(qlvl_next) <= 128:
        raise ValueError(f"qlvl_next {qlvl_next}: int8 codes need 2..128")
    f32 = dict(dtype=torch.float32, device=dev)
    par = parities.to(device=dev, dtype=torch.int32).contiguous()
    bias_v = bias.to(**f32).contiguous()
    if tuple(bias_v.shape) != (o,):
        raise ValueError(f"bias {tuple(bias_v.shape)} != ({o},)")
    alpha = torch.as_tensor(alpha_next, **f32).reshape(1).contiguous()
    y = torch.empty((b, d1 - 1, h, w, o), dtype=out_dtype, device=dev)
    q = torch.empty((b, d1 - 1, h, w, o), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = _lib()(x.data_ptr(), par.data_ptr(), w_even.data_ptr(),
                    w_odd.data_ptr(), bias_v.data_ptr(), alpha.data_ptr(),
                    y.data_ptr(), q.data_ptr(), b, d1 - 1, h, w, c8, o,
                    int(qlvl_next), int(out_dtype == torch.bfloat16),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {rc}")
    stem_s2d_conv.launches += 1
    return y, q
