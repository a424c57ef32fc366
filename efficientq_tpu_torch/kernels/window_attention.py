"""K7: 3D shifted-window self-attention for serving.

``window_attention(qkv, table, qkv_bias, num_heads, window, shift)`` is
the attention of one Swin block of MONAI's SwinUNETR
(``monai/networks/nets/swin_unetr.py``: ``SwinTransformerBlock``'s
``forward_part1`` after its qkv linear, and ``WindowAttention``'s forward
before its proj): from the qkv linear's output on the unpadded NDHWC token
grid, (N, D, H, W, 3C) with channels [q | k | v] of ``num_heads`` heads,
to the attention's output (N, D, H, W, C).

The window and shift are the block's configured ones; MONAI's
``get_window_size`` turns them into the call's (``window_geometry``): an
axis whose extent is at most the window takes the extent as its window
and no shift.  The grid is zero-padded to a multiple of the window (a
padded token's key and value are the qkv bias, the linear of zero, and it
is not masked), rolled by -shift when the block shifts, and cut into
windows; in each, for each head, ``softmax(q k^T hd^-0.5 + B + M) v``,
with B gathered from ``table`` ((2f-1)^3 rows, one column a head: MONAI's
``relative_position_bias_table``) by MONAI's ``relative_position_index``
of the configured window f, sliced to the call's n x n, and M MONAI's
``compute_mask``: -100 between tokens of different shift regions.

The plain version ``window_attention_reference`` is those steps in
PyTorch, in float64, rounded once to float32, on any device (in slices of
windows, to bound its memory).  The kernel (``csrc/window_attention.cu``;
its header says what bounds it and why its tiles) computes in float64 too,
rounded once: q k^T and p v as float64 MMAs on the tensor cores, tiles of
16 queries of a window's real rows against tiles of 16 or 32 of its keys,
each score's accumulator starting at its bias and mask, an online softmax
rescaled once a tile of keys with CUDA's float64 exp (its fast path
written out, bit for bit, so a thread's exps interleave); the roll, the
padding and the windows are index arithmetic.  It equals the plain version
but where a float64 value lies within its rounding error of a float32
rounding boundary.  It takes a head dimension of 16 and windows of at
most 384 tokens, every size up to that on one path: the tiles follow the
window (``tile_scores``).

For CUDA tensors ``window_attention`` launches the kernel or raises; for
tensors on the CPU it takes the plain version.  Each launch adds one to
``window_attention.launches`` and its tiles' scores, padding included
(``tile_scores``), to ``window_attention.tile_scores``;
``window_attention.window_heads`` counts the (sample, window, head)
attentions that the graph's window-attention nodes computed, padding
included, whichever implementation ran (``nnir.eval_node`` adds to it).
A CUDA-graph replay adds its forward's counts.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import on_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_I3 = ctypes.c_int * 3
_HD = 16  # the kernel's head dimension
_NMAX = 384  # the kernel's tokens a window
_TILE = 16  # the kernel's queries a tile, and its keys' granularity
THREADS = 256  # the kernel's threads a block


def window_geometry(extent: Sequence[int], window: Sequence[int],
                    shift: Sequence[int]) -> Tuple[tuple, tuple]:
    """MONAI's ``get_window_size``: (window, shift) of a grid of
    ``extent``; an axis no longer than its window takes the extent as its
    window and does not shift."""
    w, s = list(window), list(shift)
    for i, e in enumerate(extent):
        if e <= window[i]:
            w[i] = int(e)
            s[i] = 0
    return tuple(w), tuple(s)


def relative_position_index(window: Sequence[int]) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of a 3D window: (n, n) int64,
    n the window's tokens."""
    f0, f1, f2 = window
    coords = torch.stack(torch.meshgrid(
        torch.arange(f0), torch.arange(f1), torch.arange(f2),
        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([f0 - 1, f1 - 1, f2 - 1])
    rel = rel * torch.tensor([(2 * f1 - 1) * (2 * f2 - 1), 2 * f2 - 1, 1])
    return rel.sum(-1)


def _window_labels(padded, w, s, device) -> torch.Tensor:
    """MONAI's ``compute_mask`` labels of the rolled padded grid, (nW, n):
    the region of each token of each window, by the same slices."""
    d, h, wd = padded
    img = torch.zeros((d, h, wd), device=device)
    cnt = 0
    for sd in (slice(-w[0]), slice(-w[0], -s[0]), slice(-s[0], None)):
        for sh in (slice(-w[1]), slice(-w[1], -s[1]), slice(-s[1], None)):
            for sw in (slice(-w[2]), slice(-w[2], -s[2]),
                       slice(-s[2], None)):
                img[sd, sh, sw] = cnt
                cnt += 1
    img = img.view(d // w[0], w[0], h // w[1], w[1], wd // w[2], w[2])
    return img.permute(0, 2, 4, 1, 3, 5).reshape(-1, w[0] * w[1] * w[2])


def window_attention_reference(qkv, table, qkv_bias, num_heads: int,
                               window: Sequence[int], shift: Sequence[int],
                               max_scores: int = 1 << 26):
    """Plain K7, with the wrapper's signature, on any device: MONAI's
    steps in float64 (the scale hd^-0.5 a float64, the mask -100),
    rounded once to float32 at the output.  ``max_scores``: the float64
    scores one slice of windows may hold."""
    n_, d, h, wd, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    w, s = window_geometry((d, h, wd), window, shift)
    pad = tuple(-(-e // k) * k for e, k in zip((d, h, wd), w))
    n = w[0] * w[1] * w[2]
    dev = qkv.device
    f64 = torch.float64
    b = (torch.zeros(c3, dtype=f64, device=dev) if qkv_bias is None
         else qkv_bias.to(f64))
    idx = relative_position_index(window)[:n, :n].reshape(-1).to(dev)
    bias = table.to(f64)[idx].reshape(n, n, num_heads).permute(2, 0, 1)
    shifted = any(s)
    labels = _window_labels(pad, w, s, dev) if shifted else None
    out = torch.empty((n_, d, h, wd, c), dtype=torch.float32, device=dev)
    nwin = (pad[0] // w[0]) * (pad[1] // w[1]) * (pad[2] // w[2])
    step = max(1, max_scores // (num_heads * n * n))
    for i in range(n_):
        x = b.expand(*pad, c3).clone()
        x[:d, :h, :wd] = qkv[i].to(f64)
        if shifted:
            x = torch.roll(x, shifts=(-s[0], -s[1], -s[2]), dims=(0, 1, 2))
        x = x.view(pad[0] // w[0], w[0], pad[1] // w[1], w[1],
                   pad[2] // w[2], w[2], c3)
        x = x.permute(0, 2, 4, 1, 3, 5, 6).reshape(nwin, n, c3)
        y = torch.empty((nwin, n, c), dtype=f64, device=dev)
        for w0 in range(0, nwin, step):
            t = x[w0:w0 + step].reshape(-1, n, 3, num_heads, hd)
            q, k, v = t.permute(2, 0, 3, 1, 4)
            attn = (q * hd ** -0.5) @ k.transpose(-2, -1) + bias
            if shifted:
                lab = labels[w0:w0 + step]
                attn = attn + torch.where(
                    lab[:, None, :, None] != lab[:, None, None, :],
                    -100.0, 0.0).to(f64)
            y[w0:w0 + step] = (torch.softmax(attn, dim=-1) @ v).transpose(
                1, 2).reshape(-1, n, c)
        y = y.view(pad[0] // w[0], pad[1] // w[1], pad[2] // w[2], w[0],
                   w[1], w[2], c).permute(0, 3, 1, 4, 2, 5, 6)
        y = y.reshape(*pad, c)
        if shifted:
            y = torch.roll(y, shifts=s, dims=(0, 1, 2))
        out[i] = y[:d, :h, :wd].to(torch.float32)
    return out


def window_count(extent: Sequence[int], window: Sequence[int],
                 shift: Sequence[int]) -> int:
    """Windows of one sample's grid of ``extent``, padding included."""
    w, _ = window_geometry(extent, window, shift)
    out = 1
    for e, k in zip(extent, w):
        out *= -(-e // k)
    return out


def _real_counts(extent: int, w: int, s: int) -> collections.Counter:
    """{real positions: windows} along one axis of ``extent`` cut into
    windows of ``w`` after the roll by -``s``."""
    padded = -(-extent // w) * w
    return collections.Counter(
        sum((wi * w + l + s) % padded < extent for l in range(w))
        for wi in range(padded // w))


@functools.lru_cache(maxsize=256)
def _tile_scores(extent, window, shift) -> int:
    w, s = window_geometry(extent, window, shift)
    keys = -(-(w[0] * w[1] * w[2]) // _TILE) * _TILE
    axes = [_real_counts(e, k, sh) for e, k, sh in zip(extent, w, s)]
    rows = sum(mz * my * mx * -(-(cz * cy * cx) // _TILE) * _TILE
               for cz, mz in axes[0].items() for cy, my in axes[1].items()
               for cx, mx in axes[2].items())
    return rows * keys


def tile_scores(extent: Sequence[int], window: Sequence[int],
                shift: Sequence[int], n: int, heads: int) -> int:
    """Scores that K7's tensor-core tiles compute over ``n`` samples of a
    grid of ``extent`` with ``heads`` heads: per (sample, window, head)
    the window's real queries (its tokens on the unpadded grid) rounded
    up to the 16 of a query tile, times its tokens rounded up to 16 (the
    keys of the tiles it walks)."""
    return n * heads * _tile_scores(tuple(int(e) for e in extent),
                                    tuple(window), tuple(shift))


def window_attention(qkv, table, qkv_bias, num_heads: int,
                     window: Sequence[int], shift: Sequence[int]):
    """The window attention of (N, D, H, W, 3C) float32 ``qkv`` with the
    bias ``table`` (T, heads) and the qkv linear's bias ``qkv_bias`` (3C,)
    or None, in one kernel: (N, D, H, W, C) float32."""
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, table, qkv_bias, num_heads,
                                          window, shift)
    if qkv.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA or (plain) CPU tensors, got "
                         f"{qkv.device}")
    return _launch(qkv, table, qkv_bias, int(num_heads), tuple(window),
                   tuple(shift))


window_attention.launches = 0
window_attention.window_heads = 0
window_attention.tile_scores = 0


@functools.lru_cache(maxsize=None)
def _lib():
    from . import build

    fn = build.load("window_attention.cu").effq_window_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * 6 + [_P] * 3 + [ctypes.c_double, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=256)
def _geometry(extent, window, shift):
    """(window, configured window, shift) as ctypes triples."""
    w, s = window_geometry(extent, window, shift)
    return _I3(*w), _I3(*window), _I3(*s)


def _launch(qkv, table, qkv_bias, heads, window, shift):
    """K7 on the card.  Lean on the host, so a call can be captured in a
    CUDA graph: the output allocated here, nothing read back."""
    if qkv.dim() != 5 or qkv.dtype != torch.float32:
        raise ValueError(f"K7 takes (N, D, H, W, 3C) float32 qkv, got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    n, d, h, w, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c != heads * _HD:
        raise ValueError(f"K7 takes heads of {_HD} dimensions: {c3 // 3} "
                         f"channels, {heads} heads")
    win, full, sh = _geometry((d, h, w), window, shift)
    if win[0] * win[1] * win[2] > _NMAX:
        raise ValueError(f"K7 takes windows of at most {_NMAX} tokens, got "
                         f"{tuple(win)}")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:
        qkv = qkv.clone()
    dev = qkv.device
    table = table.to(device=dev, dtype=torch.float32).contiguous()
    rows = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
    if tuple(table.shape) != (rows, heads):
        raise ValueError(f"bias table {tuple(table.shape)} != ({rows}, "
                         f"{heads})")
    bias = None
    if qkv_bias is not None:
        bias = qkv_bias.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(bias.shape) != (c3,):
            raise ValueError(f"qkv bias {tuple(bias.shape)} != ({c3},)")
        if bias.data_ptr() % 16:
            bias = bias.clone()
    out = torch.empty((n, d, h, w, c), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = on_device(qkv.get_device(), _lib(), qkv.data_ptr(),
                   None if bias is None else bias.data_ptr(),
                   table.data_ptr(), out.data_ptr(), n, d, h, w, c, heads,
                   win, full, sh, float((c // heads) ** -0.5))
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: cudaError_t {rc} (qkv "
                           f"{tuple(qkv.shape)}, heads {heads}, window "
                           f"{tuple(win)}, shift {tuple(sh)})")
    window_attention.launches += 1
    window_attention.tile_scores += tile_scores((d, h, w), window, shift, n,
                                                heads)
    return out
