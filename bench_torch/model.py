"""The plain reference of a configuration: the UResQ network as its file
describes it, its weights made from the seed, and its whole-volume forward.

Plain PyTorch, float32, NCDHW, no kernel, cache or batching of the program
(it imports nothing of the program).  The network follows the EfficientQ
reference's UResQ with the 'mid' block ordering (ReLU, conv, BN), batch
norm already folded into each conv (a PTQ export holds folded convs), a
residual unit that adds ReLU(x) (the reference's in-place ReLU), max-pool
plus 1x1 transitions down, 1x1 plus trilinear transitions up with a
sum fusion, 'simple' deep-supervision heads and a final 1x1 classifier
upsampled by the init stride.  A quantized conv takes its input on the
activation grid ``round(clip(x / alpha_act, 0, 1) * (n - 1))`` times
``alpha_act / (n - 1)``; its weights are stored on their grid already
(``Reference.conv`` computes it on the two grids' codes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: Tuple[int, int, int]
    bias: bool
    qlvl_w: int  # 0: float weights
    qlvl_act: int  # 0: float input
    head: bool  # an auxiliary head's classifier (all-heads runs only)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)


def _levels(spec) -> Tuple[int, int]:
    """(weight levels, activation levels) of a [qlvl_w, qlvl_act] edge
    override; a level <= 0 leaves that side in float."""
    return max(int(spec[0]), 0), max(int(spec[1]), 0)


def convs(cfg: Dict) -> List[Conv]:
    """Every conv of the network in the order the forward runs them."""
    w = list(cfg["widths"])
    n, nd = len(w), len(w) // 2
    qw, qa = int(cfg["qlvl_w"]), int(cfg["qlvl_act"])
    one = (1, 1, 1)
    fw, fa = _levels(cfg["q_first"])
    out = [Conv("conv0.conv", cfg["num_mod"], w[0], cfg["init_kernel"],
                _triple(cfg["init_stride"]), True, fw, fa, False)]
    for i in range(n):
        for j in range(cfg["depths"][i]):
            pre = f"u_blocks.UResBlock{i + 1}.Layer{j + 1}"
            out += [Conv(f"{pre}.block1.conv", w[i], w[i], 3, one, True, qw,
                         qa, False),
                    Conv(f"{pre}.block2.conv", w[i], w[i], 3, one, True, qw,
                         qa, False)]
        if i < nd:
            out.append(Conv(f"trans_downs.TransDown{i + 1}.block.conv", w[i],
                            w[i + 1], 1, one, True, qw, qa, False))
        elif i < n - 1:
            if n - i <= cfg["ds_depth_limit"]:
                out.append(Conv(f"classifiers.AuxClassifier{i + 1}.classifier",
                                w[i], cfg["num_classes"], 1, one, True, 0, 0,
                                True))
            if w[i] != w[i + 1]:
                out.append(Conv(f"trans_ups.TransUp{i + 1}.upsampler.block."
                                f"conv", w[i], w[i + 1], 1, one, True, qw, qa,
                                False))
    lw, la = _levels(cfg["q_last"])
    out.append(Conv("final_cls.cls", w[-1], cfg["num_classes"], 1, one, True,
                    lw, la, False))
    return out


def num_heads(cfg: Dict) -> int:
    return sum(c.head for c in convs(cfg)) + 1


def _seed(seed: int, salt: int) -> int:
    """A generator seed from the run's seed (any size) and a salt."""
    return (int(seed) * 1_000_003 + salt) % (2 ** 63)


# The served net's arithmetic is made exact: every weight, bias, scale and
# input intensity is a dyadic rational with few bits, so each sum the
# program forms (integer codes on K1, float32 elsewhere) is exact in
# float32 whatever its order, and no activation lies on a rounding tie of
# its grid (the grid steps are 2^e / (n - 1)^2 with n - 1 odd).  A
# random-weight net at 4 levels spreads a single code that a rounding
# flips into logits several units off; with exact sums the program and the
# reference differ only by the rounding of the float head's logits.
ACT_ALPHA_EXP = 2  # activation ranges 2^2 / (n - 1): 4/3 at 4 levels
BIAS_STEP = 2.0 ** -6


def _dyadic_alpha(peak: float, unit: float) -> float:
    """``unit`` times the power of two that puts it nearest ``peak``."""
    return unit * 2.0 ** round(math.log2(peak / unit))


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The served weights, made on ``device`` from ``seed`` in two draws:
    kaiming-normal kernels (std sqrt(2 / (k^3 * out))) and biases of std
    0.1, as a PTQ export holds them (BN folded), with post-PTQ scales
    emulated: a weight-quantized kernel on its symmetric grid with alpha_w
    the dyadic multiple of (nw - 1) (na - 1)^2 nearest max |w| (of nw - 1
    for a float input), every activation range 2^2 / (na - 1), float
    kernels and all biases on dyadic grids (see the note above).  Keys and
    layouts are the reference checkpoint's (OIDHW kernels)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 1))
    layers = convs(cfg)
    sizes = [c.cout * c.cin * c.k ** 3 for c in layers]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    biases = 0.1 * torch.randn(sum(c.cout for c in layers), generator=gen,
                               device=device)
    biases = torch.round(biases / BIAS_STEP) * BIAS_STEP
    sd, at, bt = {}, 0, 0
    for c, size in zip(layers, sizes):
        std = (2.0 / (c.k ** 3 * c.cout)) ** 0.5
        w = (flat[at:at + size] * std).reshape(c.cout, c.cin, c.k, c.k, c.k)
        at += size
        peak = float(w.abs().max())
        if c.qlvl_w:
            nw = c.qlvl_w - 1
            na = c.qlvl_act - 1 if c.qlvl_act else 1
            alpha = _dyadic_alpha(peak, nw * na * na)
            codes = torch.round((torch.clamp(w / alpha, -1.0, 1.0) + 1.0)
                                * nw / 2) * 2 - nw
            w = codes * (alpha / nw)
            act = 2.0 ** ACT_ALPHA_EXP / na if c.qlvl_act else 1.0
            sd[f"{c.name}.alpha_w"] = torch.tensor(alpha, device=device)
            sd[f"{c.name}.alpha_act"] = torch.tensor(act, device=device)
        else:
            step = _dyadic_alpha(peak, 1.0) / 256
            w = torch.round(w / step) * step
        sd[f"{c.name}.weight"] = w.contiguous()
        sd[f"{c.name}.bias"] = biases[bt:bt + c.cout].clone()
        bt += c.cout
    return sd


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as a TF32 tensor core takes its operands (the
    products are then exact and summed in float32)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _upsample(x, scale):
    d, h, w = x.shape[2:]
    s = _triple(scale)
    return F.interpolate(x, size=(d * s[0], h * s[1], w * s[2]),
                         mode="trilinear", align_corners=False)


class Reference:
    """The network of ``cfg`` over the weights ``sd`` (as ``make_weights``
    gives them, on the device the forward runs on).  ``tf32``: each conv
    and matmul on float inputs takes its operands rounded to TF32
    (``to_tf32``; the quantized convs' codes have fewer bits than TF32
    keeps), whatever kernels the backend picks: the step below float32,
    the control."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 tf32: bool = False):
        self.cfg = cfg
        self.sd = sd
        self.layers = {c.name: c for c in convs(cfg)}
        self.round = to_tf32 if tf32 else (lambda t: t)

    def conv(self, name, x):
        """One conv.  A quantized input takes its grid codes
        ``round(clip(x / alpha_act, 0, 1) * (na - 1))`` and the kernel its
        codes ``w / alpha_w * (nw - 1)``; their conv is scaled by
        ``alpha_act * alpha_w / ((na - 1) (nw - 1))``: the same function
        as the conv of the two grids' values."""
        c = self.layers[name]
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        pad = (c.k - 1) // 2
        if not c.qlvl_act:  # float input: the operands TF32 would round
            x, w = self.round(x), self.round(w)
        if not c.qlvl_act and c.k == 1:  # a classifier: a channel matmul
            y = torch.matmul(x.movedim(1, -1), w.view(c.cout, c.cin).t())
            return y.movedim(-1, 1) + b.view(1, -1, 1, 1, 1)
        if not c.qlvl_act:
            return F.conv3d(x, w, b, c.stride, pad)
        na, nw = c.qlvl_act - 1, c.qlvl_w - 1
        a_act = self.sd[f"{name}.alpha_act"].double()
        a_w = self.sd[f"{name}.alpha_w"].double()
        q = torch.round(torch.clamp(x / a_act.to(x.dtype), 0.0, 1.0) * na)
        wq = torch.round(w.double() / a_w * nw).to(x.dtype)
        scale = (a_act * a_w / (na * nw)).to(x.dtype)
        return F.conv3d(q, wq, None, c.stride, pad) * scale + b.view(
            1, -1, 1, 1, 1)

    def forward(self, x, all_heads: bool = False) -> List[torch.Tensor]:
        """(B, num_mod, D, H, W) -> the head logits, each (B, classes, D,
        H, W): the final head alone, or every head with the final last."""
        cfg = self.cfg
        w = list(cfg["widths"])
        n, nd = len(w), len(w) // 2
        init = _triple(cfg["init_stride"])
        h = self.conv("conv0.conv", x)
        skips, heads = [], []
        for i in range(n):
            for j in range(cfg["depths"][i]):
                pre = f"u_blocks.UResBlock{i + 1}.Layer{j + 1}"
                r = F.relu(h)
                t = self.conv(f"{pre}.block1.conv", r)
                h = self.conv(f"{pre}.block2.conv", F.relu(t)) + r
            if i < nd:
                skips.append(h)
                h = self.conv(f"trans_downs.TransDown{i + 1}.block.conv",
                              F.relu(F.max_pool3d(h, 2, 2)))
            elif i < n - 1:
                if all_heads and n - i <= cfg["ds_depth_limit"]:
                    up = 2 ** (n - 1 - i)
                    heads.append(_upsample(
                        self.conv(f"classifiers.AuxClassifier{i + 1}."
                                  f"classifier", h),
                        tuple(s * up for s in init)))
                u = h
                if w[i] != w[i + 1]:
                    u = self.conv(f"trans_ups.TransUp{i + 1}.upsampler.block."
                                  f"conv", F.relu(u))
                h = _upsample(u, 2) + skips[-(i - nd + 1)]
        h = self.conv("final_cls.cls", h)
        if init != (1, 1, 1):
            h = _upsample(h, init)
        return heads + [h]


def grid_starts(size: int, patch: int, overlap: int) -> List[int]:
    """The reference's patch starts along one axis: every
    ``patch - overlap`` below ``size - patch``, then ``size - patch``."""
    return list(range(0, size - patch, patch - overlap)) + [size - patch]


def patch_starts(shape: Sequence[int], patch, overlap):
    return [(i, j, k)
            for i in grid_starts(shape[0], patch[0], overlap[0])
            for j in grid_starts(shape[1], patch[1], overlap[1])
            for k in grid_starts(shape[2], patch[2], overlap[2])]


@torch.no_grad()
def volume_logits(net: Reference, vol: torch.Tensor, all_heads: bool = False,
                  block: int = 2) -> List[torch.Tensor]:
    """The overlap-averaged logits of one (num_mod, D, H, W) volume on the
    patch grid of the configuration, ``block`` patches a forward: a list
    of (classes, D, H, W), one per head computed."""
    patch = _triple(net.cfg["patch"])
    overlap = _triple(net.cfg["overlap"])
    shape = tuple(vol.shape[1:])
    starts = patch_starts(shape, patch, overlap)
    sums, count = None, torch.zeros(shape, device=vol.device)
    for s in range(0, len(starts), block):
        part = starts[s:s + block]
        xb = torch.stack([vol[:, i:i + patch[0], j:j + patch[1],
                              k:k + patch[2]] for i, j, k in part])
        outs = net.forward(xb, all_heads)
        if sums is None:
            sums = [torch.zeros((o.shape[1],) + shape, device=vol.device)
                    for o in outs]
        for b, (i, j, k) in enumerate(part):
            win = (slice(i, i + patch[0]), slice(j, j + patch[1]),
                   slice(k, k + patch[2]))
            for acc, o in zip(sums, outs):
                acc[(slice(None),) + win] += o[b]
            count[win] += 1.0
    return [acc / count for acc in sums]
