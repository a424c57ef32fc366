"""The plain reference of SwinUNETR: the network as a configuration
describes it, over a MONAI-style state dict.

One text, two copies: ``tests/swinunetr_reference.py`` for the CPU tests,
and the first part of this file, ``bench_torch/swinunetr_model.py``, which
adds the harness's seeded weights (``make_weights``), the whole-volume
loop with overlap averaging (``model.volume_logits``) and the counts of
the per-layer metrics (``served_layers``, ``k1_least_s``, ``k3_least_s``,
``instance_norm_bytes``, ``attention_least_s``, ``peak_s``).  Plain
PyTorch,
float32, NCDHW (the Swin encoder channels-last, as MONAI's blocks run it),
TF32 off (``Reference.forward``), no kernel, cache or batching of the
program: it imports neither JAX nor the program.

The network is MONAI's ``SwinUNETR`` (``monai/networks/nets/swin_unetr.py``
with ``monai/networks/blocks/unetr_block.py`` and ``dynunet_block.py``;
Hatamizadeh et al., arXiv:2201.01266) at v0.9's settings (``use_v2`` off,
``downsample="merging"``, ``normalize``, instance norm, LeakyReLU 0.01,
``res_block``), written from its equations, since MONAI is not installed
here:

- ``swinViT.patch_embed.proj``: conv 2^3 of stride 2 with a bias; the
  skip ``hidden[0]`` is its LayerNorm over the channels, no affine
  (``proj_out``);
- stage i (``swinViT.layers{i+1}.0``): ``depths[i]`` Swin blocks, ``x = x
  + proj(W-MSA(norm1 x))``, ``x = x + linear2(GELU(linear1(norm2 x)))``,
  then ``PatchMerging`` (v0.9's order of the eight sub-grids, x0 ... x7,
  as its source lists them: (0,0,0), (1,0,0), (0,1,0), (0,0,1), (1,0,1),
  (0,1,0), (0,0,1), (1,1,1)), LayerNorm 8C, Linear 8C -> 2C without a bias;
  ``hidden[i+1]`` its LayerNorm without affine;
- W-MSA: the grid zero-padded (after norm1) up to a multiple of the window
  (``window_size``, 7 at the published settings; an axis of extent at most
  the window takes its extent and no shift, MONAI's ``get_window_size``),
  rolled by -(window // 2) on every axis in odd blocks, cut into
  windows; per window and head ``softmax(q k^T hd^-0.5 + B + M) v``, B
  from ``relative_position_bias_table`` by MONAI's
  ``relative_position_index`` of the configured window sliced to n x n, M
  = -100 between regions of ``compute_mask`` (odd blocks); padded tokens
  are not masked (their k and v are the qkv bias);
- ``UnetResBlock``: ``lrelu(IN(conv2(lrelu(IN(conv1 x)))) + r)``, r =
  ``IN(conv3 x)`` where the widths differ, else x; ``UnetrUpBlock``:
  transposed conv 2^3 of stride 2, ``cat([up, skip])``, a UnetResBlock;
- ``encoder1`` on the input, ``encoder2..4`` on ``hidden[0..2]``,
  ``encoder10`` on ``hidden[4]``, ``decoder5`` on (encoder10, hidden[3]),
  ``decoder4..1`` on (the previous decoder, encoder4..1); ``out``: conv
  1^3 with a bias.
Departures from MONAI: none in the network (dropout and drop path are
identities at inference).  Choices of arithmetic, which MONAI leaves to
its layers: a LayerNorm or InstanceNorm takes its mean and biased variance
in float64 and rounds them once to float32, as the mean and the channel
scales gamma / sqrt(var + eps), then computes ((x - mean) * a) + beta in
float32; the attention runs in float64 (the scale hd^-0.5 and the mask
-100 float64) and rounds once to float32 at its output; a quantized conv
or linear runs on the integer codes of its two grids.

A quantized layer takes its input on the activation grid, the codes
``round(clip(x / alpha_act, 0, 1) * (na - 1))``, or on an offset grid
(``act_k`` = k > 0: the layers that read a LayerNorm's, an attention's or
a concat's output) ``clip(round(x / alpha_act * (na - 1)), -k, na - 1 -
k)``; its weights hold ``alpha_w * codes / (nw - 1)``; their product is
scaled by ``alpha_act * alpha_w / ((na - 1)(nw - 1))``.  ``tf32``: the
layers on a float input (the patch embedding, encoder1's conv1 and conv3,
the head) and the attention take their operands rounded to TF32 (the
control, the precision below float32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

MERGE = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0),
         (0, 0, 1), (1, 1, 1))


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    kind: str  # "conv" (k^3, padding k // 2), "linear", "embed" (2^3 /2),
    #            "transp" (transposed 2^3 /2)
    cin: int
    cout: int
    k: int
    bias: bool
    qlvl_w: int  # 0: float weights
    qlvl_act: int  # 0: float input
    act_k: int  # offset-grid shift of a quantized input (0: unsigned)
    level: int  # its output's resolution: the patch over 2^level an axis


def _levels(spec):
    return max(int(spec[0]), 0), max(int(spec[1]), 0)


def layers(cfg: Dict) -> List[Layer]:
    """Every conv and linear in the order the forward runs them."""
    f = int(cfg["feature_size"])
    qw, qa = int(cfg["qlvl_w"]), int(cfg["qlvl_act"])
    k = int(cfg.get("act_k", 0))
    fw, fa = _levels(cfg["q_first"])
    mlp = int(cfg["mlp_ratio"])
    out = [Layer("swinViT.patch_embed.proj", "embed", cfg["num_mod"], f, 2,
                 True, fw, fa, 0, 1)]
    for i, depth in enumerate(cfg["depths"]):
        ch, lv = f * 2 ** i, i + 1
        stage = f"swinViT.layers{i + 1}.0"
        for b in range(depth):
            p = f"{stage}.blocks.{b}"
            out += [Layer(f"{p}.attn.qkv", "linear", ch, 3 * ch, 1, True, qw,
                          qa, k, lv),
                    Layer(f"{p}.attn.proj", "linear", ch, ch, 1, True, qw,
                          qa, k, lv),
                    Layer(f"{p}.mlp.linear1", "linear", ch, mlp * ch, 1,
                          True, qw, qa, k, lv),
                    Layer(f"{p}.mlp.linear2", "linear", mlp * ch, ch, 1,
                          True, qw, qa, 0, lv)]
        out.append(Layer(f"{stage}.downsample.reduction", "linear", 8 * ch,
                         2 * ch, 1, False, qw, qa, k, lv + 1))

    def res(prefix, cin, cout, lv, first=False):
        w1, a1 = (fw, fa) if first else (qw, qa)
        k1 = 0 if first else k
        block = [Layer(f"{prefix}.conv1.conv", "conv", cin, cout, 3, False,
                       w1, a1, k1, lv),
                 Layer(f"{prefix}.conv2.conv", "conv", cout, cout, 3, False,
                       qw, qa, 0, lv)]
        if cin != cout:
            block.append(Layer(f"{prefix}.conv3.conv", "conv", cin, cout, 1,
                               False, w1, a1, k1, lv))
        return block

    out += res("encoder1.layer", cfg["num_mod"], f, 0, first=True)
    out += res("encoder2.layer", f, f, 1)
    out += res("encoder3.layer", 2 * f, 2 * f, 2)
    out += res("encoder4.layer", 4 * f, 4 * f, 3)
    out += res("encoder10.layer", 16 * f, 16 * f, 5)
    for j, (cin, cout) in enumerate(((16 * f, 8 * f), (8 * f, 4 * f),
                                     (4 * f, 2 * f), (2 * f, f), (f, f))):
        name, lv = f"decoder{5 - j}", 4 - j
        out.append(Layer(f"{name}.transp_conv.conv", "transp", cin, cout, 2,
                         False, qw, qa, 0, lv))
        out += res(f"{name}.conv_block", 2 * cout, cout, lv)
    lw, la = _levels(cfg["q_last"])
    out.append(Layer("out.conv.conv", "conv", f, cfg["num_classes"], 1, True,
                     lw, la, 0, 0))
    return out


def layer_norms(cfg: Dict) -> List[tuple]:
    """(name, channels, level, affine) of every LayerNorm, in forward
    order (the ``proj_out`` skips have no affine and names of their own)."""
    f = int(cfg["feature_size"])
    out = [("swinViT.proj_out0", f, 1, False)]
    for i, depth in enumerate(cfg["depths"]):
        ch, lv = f * 2 ** i, i + 1
        stage = f"swinViT.layers{i + 1}.0"
        for b in range(depth):
            out += [(f"{stage}.blocks.{b}.norm{n}", ch, lv, True)
                    for n in (1, 2)]
        out += [(f"{stage}.downsample.norm", 8 * ch, lv + 1, True),
                (f"swinViT.proj_out{i + 1}", 2 * ch, lv + 1, False)]
    return out


def instance_norms(cfg: Dict) -> List[tuple]:
    """(name, channels, level) of every InstanceNorm, in forward order:
    norm1, norm2 (and norm3 beside conv3) of each UnetResBlock."""
    return [(c.name[:-len("conv1.conv")] + "norm" + c.name[-6], c.cout,
             c.level) for c in layers(cfg)
            if c.kind == "conv" and c.name.endswith(
                ("conv1.conv", "conv2.conv", "conv3.conv"))]


def attentions(cfg: Dict) -> List[tuple]:
    """(name, channels, heads, level, shift) of every window attention."""
    f = int(cfg["feature_size"])
    shift = int(cfg["window_size"]) // 2
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for b in range(depth):
            out.append((f"swinViT.layers{i + 1}.0.blocks.{b}.attn",
                        f * 2 ** i, heads, i + 1, shift if b % 2 else 0))
    return out


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero, as a TF32 tensor core takes its operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def window_size(extent, window, shift):
    """MONAI's ``get_window_size``: (window, shift) per axis."""
    w, s = [window] * 3, [shift] * 3
    for i, e in enumerate(extent):
        if e <= window:
            w[i], s[i] = int(e), 0
    return w, s


def position_index(window) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of a cubic window, (n, n)."""
    r = torch.arange(window)
    c = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (window - 1)
    m = 2 * window - 1
    return rel[:, :, 0] * m * m + rel[:, :, 1] * m + rel[:, :, 2]


def region_labels(padded, w, s, device) -> torch.Tensor:
    """MONAI's ``compute_mask`` labels of each window's tokens, (nW, n)."""
    img = torch.zeros(tuple(padded), device=device)
    cnt = 0
    for a in (slice(-w[0]), slice(-w[0], -s[0]), slice(-s[0], None)):
        for b in (slice(-w[1]), slice(-w[1], -s[1]), slice(-s[1], None)):
            for c in (slice(-w[2]), slice(-w[2], -s[2]), slice(-s[2], None)):
                img[a, b, c] = cnt
                cnt += 1
    return windows(img[None, ..., None], w)[..., 0]


def windows(x, w):
    """(B, D, H, W, C) -> (B nW, n, C) of windows w."""
    b, d, h, wd, c = x.shape
    x = x.view(b, d // w[0], w[0], h // w[1], w[1], wd // w[2], w[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w[0] * w[1] * w[2],
                                                     c)


def unwindows(x, w, b, padded):
    """The inverse of ``windows``: (B nW, n, C) -> (B, D, H, W, C)."""
    d, h, wd = padded
    x = x.view(b, d // w[0], h // w[1], wd // w[2], w[0], w[1], w[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, wd, -1)


class Reference:
    """SwinUNETR of ``cfg`` over the weights ``sd`` (MONAI's keys: OIDHW
    kernels, nn.Linear's (out, in), ConvTranspose3d's (in, out, 2, 2, 2),
    plus ``<layer>.alpha_w``, ``<layer>.alpha_act`` of each quantized
    layer), on the device they are on."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 tf32: bool = False):
        self.cfg = cfg
        self.sd = sd
        self.layers = {c.name: c for c in layers(cfg)}
        self.round = to_tf32 if tf32 else (lambda t: t)
        self.eps = float(cfg["norm_eps"])
        self.window = int(cfg["window_size"])

    def _codes(self, c: Layer, x):
        na = c.qlvl_act - 1
        alpha = self.sd[f"{c.name}.alpha_act"].to(x.dtype)
        if c.act_k:
            return torch.clamp(torch.round(x / alpha * na), -c.act_k,
                               na - c.act_k)
        return torch.round(torch.clamp(x / alpha, 0.0, 1.0) * na)

    def _weight(self, c: Layer):
        """(weights to multiply, the product's scale or None)."""
        w = self.sd[f"{c.name}.weight"]
        if not c.qlvl_act:
            return self.round(w), None
        na, nw = c.qlvl_act - 1, c.qlvl_w - 1
        a_act = self.sd[f"{c.name}.alpha_act"].double()
        a_w = self.sd[f"{c.name}.alpha_w"].double()
        wq = torch.round(w.double() / a_w * nw).to(w.dtype)
        return wq, (a_act * a_w / (na * nw)).to(w.dtype)

    def layer(self, name, x):
        """A conv (NCDHW) or linear (channels-last) of the table."""
        c = self.layers[name]
        x = self._codes(c, x) if c.qlvl_act else self.round(x)
        w, scale = self._weight(c)
        if c.kind == "linear":
            y = torch.matmul(x, w.t())
        elif c.kind == "embed":
            y = F.conv3d(x, w, None, 2)
        elif c.kind == "transp":
            y = F.conv_transpose3d(x, w, None, 2)
        elif c.k == 1:  # a channel matmul
            y = torch.matmul(x.movedim(1, -1), w.view(c.cout, c.cin).t())
            y = y.movedim(-1, 1)
        else:
            y = F.conv3d(x, w, None, 1, c.k // 2)
        if scale is not None:
            y = y * scale
        if c.bias:
            b = self.sd[f"{name}.bias"]
            y = y + (b if c.kind == "linear" else b.view(1, -1, 1, 1, 1))
        return y

    def layer_norm(self, x, name=None):
        """Over the last axis: float64 statistics rounded once to float32,
        then ((x - mean) * gamma / sqrt(var + eps)) + beta in float32."""
        xd = x.double()
        mean = xd.mean(dim=-1, keepdim=True)
        var = (xd - mean).square().mean(dim=-1, keepdim=True)
        rstd = torch.reciprocal(torch.sqrt(var + self.eps))
        if name is None:
            return (x - mean.float()) * rstd.float()
        a = (self.sd[f"{name}.weight"].double() * rstd).float()
        return (x - mean.float()) * a + self.sd[f"{name}.bias"]

    def instance_norm(self, x):
        """Per (sample, channel) of NCDHW x, as ``layer_norm`` without an
        affine."""
        n, c = x.shape[:2]
        xd = x.reshape(n, c, -1).double()
        mean = xd.mean(dim=2)
        var = (xd - mean[:, :, None]).square().mean(dim=2)
        rstd = torch.reciprocal(torch.sqrt(var + self.eps)).float()
        return ((x.reshape(n, c, -1) - mean.float()[:, :, None])
                * rstd[:, :, None]).reshape(x.shape)

    def attention(self, name, qkv, heads, shift):
        """W-MSA of channels-last ``qkv`` (the qkv linear's output), in
        float64, rounded once."""
        b, d, h, wd, c3 = qkv.shape
        c = c3 // 3
        hd = c // heads
        w, s = window_size((d, h, wd), self.window, shift)
        pad = [-(-e // k) * k for e, k in zip((d, h, wd), w)]
        f64 = torch.float64
        bias = self.sd[f"{name}.qkv.bias"].double()
        x = bias.expand(b, *pad, c3).clone()
        x[:, :d, :h, :wd] = self.round(qkv).double()
        if any(s):
            x = torch.roll(x, shifts=(-s[0], -s[1], -s[2]), dims=(1, 2, 3))
        n = w[0] * w[1] * w[2]
        idx = position_index(self.window)[:n, :n].reshape(-1).to(qkv.device)
        table = self.sd[f"{name}.relative_position_bias_table"].double()
        rel = table[idx].reshape(n, n, heads).permute(2, 0, 1)
        lab = region_labels(pad, w, s, qkv.device) if any(s) else None
        xw = windows(x, w)
        nw = xw.shape[0] // b
        out = torch.empty((xw.shape[0], n, c), dtype=f64, device=qkv.device)
        step = max(1, (1 << 26) // (heads * n * n))
        for w0 in range(0, xw.shape[0], step):
            t = xw[w0:w0 + step].reshape(-1, n, 3, heads, hd)
            q, k, v = t.permute(2, 0, 3, 1, 4)
            a = (q * hd ** -0.5) @ k.transpose(-2, -1) + rel
            if lab is not None:
                wl = lab[torch.arange(w0, w0 + t.shape[0],
                                      device=qkv.device) % nw]
                a = a + torch.where(wl[:, None, :, None]
                                    != wl[:, None, None, :], -100.0,
                                    0.0).to(f64)
            p = torch.softmax(a, dim=-1)
            p = self.round(p.float()).double() if self.round is to_tf32 \
                else p
            out[w0:w0 + step] = (p @ v).transpose(1, 2).reshape(-1, n, c)
        y = unwindows(out, w, b, pad)
        if any(s):
            y = torch.roll(y, shifts=tuple(s), dims=(1, 2, 3))
        return y[:, :d, :h, :wd].float()

    def swin_block(self, p, x, heads, shift):
        qkv = self.layer(f"{p}.attn.qkv", self.layer_norm(x, f"{p}.norm1"))
        a = self.attention(f"{p}.attn", qkv, heads, shift)
        x = x + self.layer(f"{p}.attn.proj", a)
        t = self.layer(f"{p}.mlp.linear1", self.layer_norm(x, f"{p}.norm2"))
        return x + self.layer(f"{p}.mlp.linear2", F.gelu(t))

    def res_block(self, prefix, x):
        t = F.leaky_relu(self.instance_norm(
            self.layer(f"{prefix}.conv1.conv", x)), 0.01)
        t = self.instance_norm(self.layer(f"{prefix}.conv2.conv", t))
        r = x
        if f"{prefix}.conv3.conv" in self.layers:
            r = self.instance_norm(self.layer(f"{prefix}.conv3.conv", x))
        return F.leaky_relu(t + r, 0.01)

    def up_block(self, prefix, x, skip):
        t = self.layer(f"{prefix}.transp_conv.conv", x)
        return self.res_block(f"{prefix}.conv_block",
                              torch.cat([t, skip], dim=1))

    def forward(self, x, all_heads: bool = False) -> List[torch.Tensor]:
        """(B, num_mod, D, H, W) -> [(B, num_classes, D, H, W) logits]
        (one head)."""
        cfg = self.cfg
        shifts = {name: s for name, _, _, _, s in attentions(cfg)}
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            h = self.layer("swinViT.patch_embed.proj", x).permute(
                0, 2, 3, 4, 1)
            hidden = [self.layer_norm(h)]
            for i, (depth, heads) in enumerate(zip(cfg["depths"],
                                                   cfg["num_heads"])):
                stage = f"swinViT.layers{i + 1}.0"
                for b in range(depth):
                    p = f"{stage}.blocks.{b}"
                    h = self.swin_block(p, h, heads, shifts[f"{p}.attn"])
                d, hh, w = h.shape[1:4]
                m = F.pad(h, (0, 0, 0, w % 2, 0, hh % 2, 0, d % 2))
                m = torch.cat([m[:, a::2, b::2, c::2] for a, b, c in MERGE],
                              dim=-1)
                h = self.layer(f"{stage}.downsample.reduction",
                               self.layer_norm(m, f"{stage}.downsample.norm"))
                hidden.append(self.layer_norm(h))
            hs = [t.permute(0, 4, 1, 2, 3).contiguous() for t in hidden]
            enc0 = self.res_block("encoder1.layer", x)
            enc1 = self.res_block("encoder2.layer", hs[0])
            enc2 = self.res_block("encoder3.layer", hs[1])
            enc3 = self.res_block("encoder4.layer", hs[2])
            dec = self.res_block("encoder10.layer", hs[4])
            for name, skip in (("decoder5", hs[3]), ("decoder4", enc3),
                               ("decoder3", enc2), ("decoder2", enc1),
                               ("decoder1", enc0)):
                dec = self.up_block(name, dec, skip)
            out = self.layer("out.conv.conv", dec)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        return [out]


# ---------------------------------------------------------------------
# The harness's part: seeded weights, whole-volume logits, counts.
# ---------------------------------------------------------------------

from . import costs  # noqa: E402
from .model import _dyadic_alpha, _seed, volume_logits  # noqa: E402,F401

ACT_ALPHA_EXP = 2  # activation ranges 2^2 / (n - 1): 4/3 at 4 levels
BIAS_STEP = 2.0 ** -6
GAMMA_STEP = 2.0 ** -8
TABLE_STD, TABLE_STEP = 0.5, 2.0 ** -8


def _shape(c: Layer):
    """The weight's shape as MONAI holds it."""
    if c.kind == "linear":
        return (c.cout, c.cin)
    if c.kind == "transp":
        return (c.cin, c.cout, 2, 2, 2)
    return (c.cout, c.cin, c.k, c.k, c.k)


def _fan_in(c: Layer) -> int:
    return {"linear": c.cin, "transp": c.cin, "embed": 8 * c.cin}.get(
        c.kind, c.k ** 3 * c.cin)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The served weights, made on ``device`` from ``seed``, as a PTQ
    export of SwinUNETR holds them: kaiming-normal kernels (std sqrt(2 /
    fan-in)), each weight-quantized one on its symmetric grid with alpha_w
    the dyadic multiple of (nw - 1)(na - 1)^2 nearest max |w| (a float
    input's on a grid of its dyadic peak / 256), every activation range
    2^2 / (na - 1), the offset-grid layers at ``act_k``, biases of std 0.1
    on a 1/64 grid, LayerNorm affines gamma = 1 + 0.1 N on a 1/256 grid and
    beta = 0.1 N on a 1/64 grid, relative-position tables of std 0.5 on a
    1/256 grid.  Keys are MONAI's (``relative_position_index`` too)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 1))
    table = layers(cfg)
    sizes = [math.prod(_shape(c)) for c in table]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    affine = [(n, ch) for n, ch, _, aff in layer_norms(cfg) if aff]
    aff = 0.1 * torch.randn(2, sum(ch for _, ch in affine), generator=gen,
                            device=device)
    biases = 0.1 * torch.randn(sum(c.cout for c in table if c.bias),
                               generator=gen, device=device)
    window = int(cfg["window_size"])
    rows = (2 * window - 1) ** 3
    tabs = TABLE_STD * torch.randn(
        rows * sum(h for _, _, h, _, _ in attentions(cfg)), generator=gen,
        device=device)
    sd, at, bt = {}, 0, 0
    for c, size in zip(table, sizes):
        w = (flat[at:at + size] * (2.0 / _fan_in(c)) ** 0.5).reshape(
            _shape(c))
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
            if c.act_k:
                sd[f"{c.name}.act_k"] = torch.tensor(
                    c.act_k, dtype=torch.int32, device=device)
        else:
            step = _dyadic_alpha(peak, 1.0) / 256
            w = torch.round(w / step) * step
        sd[f"{c.name}.weight"] = w.contiguous()
        if c.bias:
            b = biases[bt:bt + c.cout]
            sd[f"{c.name}.bias"] = torch.round(b / BIAS_STEP) * BIAS_STEP
            bt += c.cout
    at = 0
    for name, ch in affine:
        g, b = aff[0, at:at + ch], aff[1, at:at + ch]
        at += ch
        sd[f"{name}.weight"] = 1.0 + torch.round(g / GAMMA_STEP) * GAMMA_STEP
        sd[f"{name}.bias"] = torch.round(b / BIAS_STEP) * BIAS_STEP
    at = 0
    index = position_index(window).to(device)
    for name, _, heads, _, _ in attentions(cfg):
        t = tabs[at:at + rows * heads].reshape(rows, heads)
        at += rows * heads
        sd[f"{name}.relative_position_bias_table"] = (
            torch.round(t / TABLE_STEP) * TABLE_STEP)
        sd[f"{name}.relative_position_index"] = index
    return sd


def _voxels(cfg: Dict, level: int, patch=None) -> int:
    d, h, w = (p >> level for p in (patch or cfg["patch"]))
    return d * h * w


def on_k1(c: Layer) -> bool:
    """Runs on K1 in the int8 deployment: a 3^3 conv on grids of at most
    128 levels (the offset grid's too)."""
    return (c.kind == "conv" and c.k == 3 and 0 < c.qlvl_w <= 128
            and 0 < c.qlvl_act <= 128)


def on_k3(c: Layer) -> bool:
    """Runs on K3: a linear, 1^3 conv or transposed conv (as its 1^3 conv to
    8 C') on grids of at most 128 levels."""
    return (c.kind in ("linear", "transp") or (c.kind == "conv" and c.k == 1)
            ) and 0 < c.qlvl_w <= 128 and 0 < c.qlvl_act <= 128


def served_layers(cfg: Dict, patch=None) -> List[Dict]:
    """Each conv and linear one patch of ``patch`` (the configuration's by
    default) runs: its name, kernel (``k1``, ``k3`` or None: a float layer
    on the float32 path), output voxels, rows and columns as the kernel
    sees them (a transposed conv: its input voxels and 8 C' columns) and
    operations (a multiply-add two)."""
    out = []
    for c in layers(cfg):
        vox = _voxels(cfg, c.level, patch)
        taps = {"conv": c.k ** 3, "embed": 8}.get(c.kind, 1)
        rows, cols = vox, c.cout
        if c.kind == "transp":
            rows, cols = vox // 8, 8 * c.cout
        out.append(dict(name=c.name, kernel="k1" if on_k1(c) else (
            "k3" if on_k3(c) else None), vox=vox, rows=rows, cin=c.cin,
            cout=cols, bias=c.bias, ops=2 * vox * taps * c.cin * c.cout))
    return out


def k1_least_s(cfg: Dict, flags: Dict[str, Dict], patches: int,
               patch=None) -> float:
    """Least seconds of one forward's K1 calls over ``patches`` patches,
    by ``costs``' per-call rule: the larger of the call's bytes over the
    memory rate and its int8 operations over the int8 peak."""
    total = 0.0
    for c in served_layers(cfg, patch):
        if c["kernel"] == "k1":
            nbytes = costs.k1_call_bytes(c["vox"] * patches, c["cin"],
                                         c["cout"], flags.get(c["name"], {}))
            total += costs.bound_s(nbytes, c["ops"] * patches,
                                   costs.INT8_OPS)[0]
    return total


def k3_call_bytes(rows: int, k: int, n: int, bias: bool) -> int:
    """Bytes one K3 call must move: its float32 x once, the int8 weights,
    the bias, its float32 y once."""
    return rows * k * 4 + k * n + (4 * n if bias else 0) + rows * n * 4


def k3_least_s(cfg: Dict, patches: int, patch=None) -> float:
    """Least seconds of one forward's K3 convs over ``patches`` patches:
    per conv the larger of its bytes over the memory rate and its int8
    operations over the int8 peak."""
    total = 0.0
    for c in served_layers(cfg, patch):
        if c["kernel"] == "k3":
            nbytes = k3_call_bytes(c["rows"] * patches, c["cin"], c["cout"],
                                   c["bias"])
            total += costs.bound_s(nbytes, c["ops"] * patches,
                                   costs.INT8_OPS)[0]
    return total


def instance_norm_elements(cfg: Dict, patch=None) -> List[tuple]:
    """(elements, output bytes an element) of each InstanceNorm one patch
    runs: norm1 emits conv2's int8 codes (1 byte), norm2 and norm3 float32
    (4)."""
    return [(_voxels(cfg, level, patch) * ch, 1 if name.endswith("norm1")
             else 4) for name, ch, level in instance_norms(cfg)]


def instance_norm_bytes(cfg: Dict, patch=None) -> int:
    """Bytes the InstanceNorms of one patch must move: each float32 input
    read once and each output written once."""
    return sum(n * (4 + out) for n, out in instance_norm_elements(cfg,
                                                                   patch))


def layer_norm_elements(cfg: Dict, patch=None) -> int:
    """Elements the LayerNorms of one patch normalize."""
    return sum(_voxels(cfg, level, patch) * ch
               for _, ch, level, _ in layer_norms(cfg))


def attention_geometry(cfg: Dict, level: int, shift: int, patch=None):
    """(window, tokens a window, windows) of an attention at ``level``."""
    ext = [p >> level for p in (patch or cfg["patch"])]
    w, _ = window_size(ext, int(cfg["window_size"]), shift)
    n, nwin = 1, 1
    for e, k in zip(ext, w):
        n *= k
        nwin *= -(-e // k)
    return w, n, nwin


def window_heads(cfg: Dict, patch=None) -> int:
    """(window, head) attentions of one patch, padding included."""
    return sum(heads * attention_geometry(cfg, level, shift, patch)[2]
               for _, _, heads, level, shift in attentions(cfg))


def _table_bytes(cfg: Dict, heads: int) -> int:
    return (2 * int(cfg["window_size"]) - 1) ** 3 * heads * 4


def attention_cost(cfg: Dict, patch=None):
    """(bytes, float32 operations) of one patch's window attentions: q, k
    and v read once, the output written once, the bias table; q k^T and p
    v of every query on the unpadded grid (whose outputs the crop keeps)
    against its window's n keys, a multiply-add two."""
    nbytes = ops = 0
    for _, ch, heads, level, shift in attentions(cfg):
        vox = _voxels(cfg, level, patch)
        _, n, _ = attention_geometry(cfg, level, shift, patch)
        nbytes += vox * 4 * ch * 4 + _table_bytes(cfg, heads)
        ops += 4 * vox * ch * n
    return nbytes, ops


def attention_least_s(cfg: Dict, patches: int, patch=None) -> float:
    """Least seconds of one forward's window attentions over ``patches``
    patches: the larger of their bytes over the memory rate and their
    operations over the float32 peak, per attention."""
    total = 0.0
    for _, ch, heads, level, shift in attentions(cfg):
        vox = _voxels(cfg, level, patch) * patches
        _, n, _ = attention_geometry(cfg, level, shift, patch)
        nbytes = vox * 4 * ch * 4 + _table_bytes(cfg, heads)
        total += costs.bound_s(nbytes, 4 * vox * ch * n, costs.FP32_OPS)[0]
    return total


def peak_s(cfg: Dict, patches: int, patch=None) -> float:
    """Seconds one forward over ``patches`` patches takes at the dense
    peak of the type each part runs in: K1's and K3's int8, the float
    layers' float32 (the patch embedding, encoder1's conv1 and conv3, the
    head), the window attentions' float32."""
    total = sum(c["ops"] * patches / (costs.INT8_OPS if c["kernel"]
                                      else costs.FP32_OPS)
                for c in served_layers(cfg, patch))
    return total + attention_cost(cfg, patch)[1] * patches / costs.FP32_OPS
