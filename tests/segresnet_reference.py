"""The plain reference of SegResNet: the network as a configuration
describes it, over a MONAI-style state dict.

One text, two copies: ``tests/segresnet_reference.py`` for the CPU tests,
and the first part of ``bench_torch/segresnet_model.py``, which adds the
harness's seeded weights, whole-volume loop and counts.  Plain PyTorch,
float32, NCDHW, TF32 off for the float convs (``Reference.forward``), no
kernel, cache or batching of the program: it imports neither JAX nor the
program.

The network is MONAI's ``SegResNet`` (``monai/networks/nets/segresnet.py``
with the blocks of ``monai/networks/blocks/segresnet_block.py``;
Myronenko, arXiv:1810.11654) written from its equations, since MONAI is
not installed here:

- ``convInit``: conv 3^3, num_mod -> f;
- encoder level i: for i > 0 a conv 3^3 of stride 2 (``down_layers.i.0``),
  then ResBlocks ``down_layers.i.1..``: ``y = x + conv2(relu(GN2(
  conv1(relu(GN1(x))))))``, GroupNorm of ``num_groups`` groups, eps
  ``norm_eps``, affine;
- decoder level j: ``x = up(conv1x1(x)) + skip`` (``up_samples.j``,
  trilinear x2, ``align_corners=False``), then ResBlocks ``up_layers.j.*``;
- head ``conv_final``: GN -> relu -> conv 1^3 with a bias.
Every conv has padding k // 2 and no bias but the head's.  Departures from
MONAI: none in the network.  MONAI's dropout after ``convInit`` (training
only) and its VAE branch (``SegResNetVAE``) are not part of the inference
network.  Two choices of arithmetic, which MONAI leaves to
``nn.GroupNorm``: a GroupNorm takes its mean and biased variance in
float64 and rounds them once to float32, as the mean and the channel
scales gamma / sqrt(var + eps), then computes ((x - mean) * a) + beta in
float32; and a quantized conv runs on the integer codes of its two grids
(the same function as the conv of the grids' values).

A quantized conv takes its input on the activation grid: the codes
``round(clip(x / alpha_act, 0, 1) * (na - 1))``, or on an offset grid
(``act_k`` = k > 0, the six convs that read the signed residual stream)
``clip(round(x / alpha_act * (na - 1)), -k, na - 1 - k)``; its kernel
holds ``alpha_w * codes / (nw - 1)``; their conv is scaled by
``alpha_act * alpha_w / ((na - 1)(nw - 1))``.  ``tf32``: each conv on a
float input takes its operands rounded to TF32 (the control, the
precision below float32).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    bias: bool
    qlvl_w: int  # 0: float weights
    qlvl_act: int  # 0: float input
    act_k: int  # offset-grid shift of a quantized input (0: unsigned)
    level: int  # its output's resolution: the patch over 2^level an axis


def _levels(spec):
    return max(int(spec[0]), 0), max(int(spec[1]), 0)


def convs(cfg: Dict) -> List[Conv]:
    """Every conv in the order the forward runs them."""
    f = int(cfg["init_filters"])
    down, up = list(cfg["blocks_down"]), list(cfg["blocks_up"])
    qw, qa = int(cfg["qlvl_w"]), int(cfg["qlvl_act"])
    k = int(cfg.get("act_k", 0))
    fw, fa = _levels(cfg["q_first"])
    out = [Conv("convInit.conv", cfg["num_mod"], f, 3, 1, False, fw, fa, 0,
                0)]

    def res(prefix, ch, level):
        return [Conv(f"{prefix}.conv{i}.conv", ch, ch, 3, 1, False, qw, qa,
                     0, level) for i in (1, 2)]

    for i, nb in enumerate(down):
        ch = f * 2 ** i
        if i > 0:
            out.append(Conv(f"down_layers.{i}.0.conv", ch // 2, ch, 3, 2,
                            False, qw, qa, k, i))
        for b in range(nb):
            out += res(f"down_layers.{i}.{b + 1}", ch, i)
    n_up = len(up)
    for j, nb in enumerate(up):
        ch = f * 2 ** (n_up - j)
        out.append(Conv(f"up_samples.{j}.0.conv", ch, ch // 2, 1, 1, False,
                        qw, qa, k, n_up - j))
        for b in range(nb):
            out += res(f"up_layers.{j}.{b}", ch // 2, n_up - 1 - j)
    lw, la = _levels(cfg["q_last"])
    out.append(Conv("conv_final.2.conv", f, cfg["num_classes"], 1, 1, True,
                    lw, la, 0, 0))
    return out


def group_norms(cfg: Dict) -> List[tuple]:
    """(name, channels, level) of every GroupNorm, in forward order."""
    f = int(cfg["init_filters"])
    down, up = list(cfg["blocks_down"]), list(cfg["blocks_up"])
    out = []
    for i, nb in enumerate(down):
        for b in range(nb):
            out += [(f"down_layers.{i}.{b + 1}.norm{n}", f * 2 ** i, i)
                    for n in (1, 2)]
    n_up = len(up)
    for j, nb in enumerate(up):
        for b in range(nb):
            out += [(f"up_layers.{j}.{b}.norm{n}", f * 2 ** (n_up - 1 - j),
                     n_up - 1 - j) for n in (1, 2)]
    return out + [("conv_final.0", f, 0)]


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as a TF32 tensor core takes its operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """SegResNet of ``cfg`` over the weights ``sd`` (MONAI's keys, OIDHW
    kernels, plus ``<conv>.alpha_w`` and ``<conv>.alpha_act`` of each
    quantized conv), on the device they are on."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 tf32: bool = False):
        self.cfg = cfg
        self.sd = sd
        self.layers = {c.name: c for c in convs(cfg)}
        self.round = to_tf32 if tf32 else (lambda t: t)

    def conv(self, name, x):
        c = self.layers[name]
        w = self.sd[f"{name}.weight"]
        b = self.sd[f"{name}.bias"] if c.bias else None
        pad = c.k // 2
        if not c.qlvl_act:  # float input: the operands TF32 would round
            x, w = self.round(x), self.round(w)
            if c.k == 1:  # a classifier: a channel matmul
                y = torch.matmul(x.movedim(1, -1), w.view(c.cout, c.cin).t())
                y = y.movedim(-1, 1)
                return y if b is None else y + b.view(1, -1, 1, 1, 1)
            return F.conv3d(x, w, b, c.stride, pad)
        na, nw = c.qlvl_act - 1, c.qlvl_w - 1
        a_act = self.sd[f"{name}.alpha_act"].double()
        a_w = self.sd[f"{name}.alpha_w"].double()
        alpha = a_act.to(x.dtype)
        if c.act_k:
            q = torch.clamp(torch.round(x / alpha * na), -c.act_k,
                            na - c.act_k)
        else:
            q = torch.round(torch.clamp(x / alpha, 0.0, 1.0) * na)
        wq = torch.round(w.double() / a_w * nw).to(x.dtype)
        scale = (a_act * a_w / (na * nw)).to(x.dtype)
        y = F.conv3d(q, wq, None, c.stride, pad) * scale
        return y if b is None else y + b.view(1, -1, 1, 1, 1)

    def norm(self, name, x):
        """GroupNorm: float64 statistics rounded once to float32, then
        ((x - mean) * gamma / sqrt(var + eps)) + beta in float32."""
        g = int(self.cfg["num_groups"])
        n, c = x.shape[:2]
        xd = x.reshape(n, g, -1).double()
        mean = xd.mean(dim=2)
        var = (xd - mean[:, :, None]).square().mean(dim=2)
        rstd = torch.reciprocal(torch.sqrt(var + float(self.cfg["norm_eps"])))
        gamma = self.sd[f"{name}.weight"].double().view(1, g, c // g)
        a = (gamma * rstd[:, :, None]).float()
        beta = self.sd[f"{name}.bias"].view(g, c // g, 1)
        y = ((x.reshape(n, g, c // g, -1) - mean.float()[:, :, None, None])
             * a[..., None] + beta)
        return y.reshape(x.shape)

    def res_block(self, prefix, x):
        t = self.conv(f"{prefix}.conv1.conv",
                      F.relu(self.norm(f"{prefix}.norm1", x)))
        return self.conv(f"{prefix}.conv2.conv",
                         F.relu(self.norm(f"{prefix}.norm2", t))) + x

    def forward(self, x, all_heads: bool = False) -> List[torch.Tensor]:
        """(B, num_mod, D, H, W) -> [(B, num_classes, D, H, W) logits]
        (one head)."""
        cfg = self.cfg
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            h = self.conv("convInit.conv", x)
            skips = []
            for i, nb in enumerate(cfg["blocks_down"]):
                if i > 0:
                    h = self.conv(f"down_layers.{i}.0.conv", h)
                for b in range(nb):
                    h = self.res_block(f"down_layers.{i}.{b + 1}", h)
                skips.append(h)
            n_up = len(cfg["blocks_up"])
            for j, nb in enumerate(cfg["blocks_up"]):
                u = self.conv(f"up_samples.{j}.0.conv", h)
                d, hh, w = u.shape[2:]
                h = F.interpolate(u, size=(2 * d, 2 * hh, 2 * w),
                                  mode="trilinear", align_corners=False)
                h = h + skips[n_up - 1 - j]
                for b in range(nb):
                    h = self.res_block(f"up_layers.{j}.{b}", h)
            h = self.conv("conv_final.2.conv",
                          F.relu(self.norm("conv_final.0", h)))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        return [h]
