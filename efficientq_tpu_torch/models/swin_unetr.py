"""SwinUNETR: the Swin-transformer U-Net that MONAI ships for BraTS
(``monai/networks/nets/swin_unetr.py``, ``SwinUNETR``; A. Hatamizadeh et
al., "Swin UNETR: Swin Transformers for Semantic Segmentation of Brain
Tumors in MRI Images", BrainLes 2021, arXiv:2201.01266), built as a graph
IR (see nnir.py), as MONAI's v0.9 network with ``use_v2=False``,
``downsample="merging"``, ``normalize=True``, ``res_block=True`` and the
instance norm of its default ``norm_name``.

The inference network, written from MONAI's equations:

- ``swinViT.patch_embed.proj``: conv 2^3 of stride 2, num_mod -> f, with a
  bias, no patch norm;
- four ``BasicLayer`` stages ``swinViT.layers{1..4}.0``, widths f 2^i:
  ``depths[i]`` Swin blocks, then ``PatchMerging`` (its v0.9 gather,
  ``ops.patch_merge``; LayerNorm 8C; Linear 8C -> 2C, no bias);
- a Swin block: ``x = x + proj(attn(qkv(norm1(x))))``, then ``x = x +
  linear2(gelu(linear1(norm2(x))))``; the attention is the window
  attention of ``kernels/window_attention.py`` (window ``window_size``,
  shift 0 in even blocks and ``window_size // 2`` in odd ones), the MLP
  ``mlp_ratio`` C wide with the exact GELU;
- the skips ``swinViT.proj_out{0..4}``: LayerNorm over the channels, no
  affine, of the patch embedding and of each stage's merged output;
- ``UnetResBlock`` (``encoder1``, ``2``, ``3``, ``4``, ``10`` as
  ``UnetrBasicBlock``'s ``layer``; the decoders' ``conv_block``):
  ``lrelu(IN(conv2(lrelu(IN(conv1 x)))) + r)``, r = ``IN(conv3 x)`` (1^3)
  where the widths differ, else x; 3^3 convs of padding 1, no bias;
  InstanceNorm without affine (a ``group_norm`` of one channel a group);
  LeakyReLU 0.01;
- ``UnetrUpBlock`` (``decoder5`` ... ``decoder1``): ``transp_conv`` (2^3,
  stride 2, no bias) as a 1^3 conv to 8 C' and ``depth_to_space``, then
  the channel concat with the skip, then a ``UnetResBlock``;
- ``out``: conv 1^3, f -> num_classes, with a bias.

Node names are MONAI's module paths (``swinViT.layers1.0.blocks.0.attn``,
``...attn.qkv``, ``...mlp.linear1``, ``encoder2.layer.conv1.conv``,
``decoder5.transp_conv.conv``, ``out.conv.conv`` ...), so a MONAI state
dict maps key for key (``torch_io``: nn.Linear's (out, in) and
ConvTranspose3d's (in, out, 2, 2, 2) weights turned to the conv layout).
The norms without an affine, the activations, the adds, the merges'
gathers, the depth-to-space steps and the concats take names of their
own.  Dropout and drop-path are identities at inference and left out.

Quantization as the UResQ presets have it: ``q_first`` covers the three
layers that read the raw input (``swinViT.patch_embed.proj``,
``encoder1.layer.conv1.conv``, ``encoder1.layer.conv3.conv``), ``q_last``
the head, every other conv and linear takes (``qlvl_w``, ``qlvl_act``).
The window attention itself is not quantized.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..nnir import Graph, GraphBuilder, QCfg


@dataclasses.dataclass
class SwinUNETRConfig:
    num_mod: int = 4
    num_classes: int = 3
    feature_size: int = 48
    depths: Sequence[int] = (2, 2, 2, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 2
    mlp_ratio: int = 4
    norm_eps: float = 1e-5
    # quantization (as UResQConfig's)
    quantize: bool = False
    qlvl_w: int = 8
    qlvl_act: int = 8
    q_weight: bool = True
    q_act: bool = True
    # (qlvl_w, qlvl_act) of the input layers and the head; <= 0 disables
    q_first: Optional[Tuple[int, int]] = None
    q_last: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        self.depths = tuple(int(d) for d in self.depths)
        self.num_heads = tuple(int(h) for h in self.num_heads)
        if len(self.depths) != 4 or len(self.num_heads) != 4:
            raise ValueError(f"SwinUNETR has four stages: depths "
                             f"{self.depths}, num_heads {self.num_heads}")
        for i, h in enumerate(self.num_heads):
            if (self.feature_size * 2 ** i) % h:
                raise ValueError(f"stage {i + 1}'s width "
                                 f"{self.feature_size * 2 ** i} is not a "
                                 f"multiple of its {h} heads")
        if self.patch_size != 2:
            raise ValueError("SwinUNETR's decoder takes patch_size 2")

    def main_qcfg(self) -> Optional[QCfg]:
        if not self.quantize:
            return None
        return QCfg(q_weight=self.q_weight, qlvl_w=self.qlvl_w,
                    q_act=self.q_act, qlvl_act=self.qlvl_act)

    def edge_qcfg(self, spec: Optional[Tuple[int, int]]) -> Optional[QCfg]:
        """qcfg of an input layer or the head from a (qlvl_w, qlvl_act)
        override; None spec -> plain conv."""
        if not self.quantize or spec is None:
            return None
        qw, qa = int(spec[0]), int(spec[1])
        return QCfg(q_weight=qw > 0, qlvl_w=qw, q_act=qa > 0, qlvl_act=qa)


def min_input_divisor(cfg: SwinUNETRConfig) -> Tuple[int, int, int]:
    """Per-axis divisor of a spatial input shape: the patch embedding and
    four merges halve each axis, and the decoder's transposed convs
    double it back onto the skips, so 2^5."""
    d = cfg.patch_size * 2 ** len(cfg.depths)
    return (d, d, d)


def validate_spatial_shape(shape, cfg: SwinUNETRConfig, what: str) -> None:
    """Raise a clear ValueError when ``shape`` (D, H, W) cannot flow through
    the encoder and back to its skips."""
    div = min_input_divisor(cfg)
    shape = tuple(int(s) for s in shape)
    bad = [ax for ax in range(3) if shape[ax] % div[ax]]
    if bad:
        axes = "".join("DHW"[ax] for ax in bad)
        raise ValueError(
            f"{what} {shape} is incompatible with the network: axes {axes} "
            f"must be multiples of {div} (the patch embedding and four "
            f"patch merges halve each axis), or the decoder's transposed "
            f"convs cannot match their skip connections")


def _res_block(g: GraphBuilder, prefix: str, x: str, cin: int, cout: int,
               cfg: SwinUNETRConfig, qcfg, qcfg_in=None) -> str:
    """MONAI's UnetResBlock (kernel 3, stride 1, instance norm, LeakyReLU
    0.01); ``qcfg_in`` for the convs that read x (conv1, conv3) where it
    differs."""
    q_in = qcfg if qcfg_in is None else qcfg_in
    eps = cfg.norm_eps
    h = g.conv(f"{prefix}.conv1.conv", x, cin, cout, 3, 1, 1, bias=False,
               qcfg=q_in)
    h = g.group_norm(f"{prefix}.norm1", h, cout, cout, eps, affine=False)
    h = g.leaky_relu(f"{prefix}.lrelu", h)
    h = g.conv(f"{prefix}.conv2.conv", h, cout, cout, 3, 1, 1, bias=False,
               qcfg=qcfg)
    h = g.group_norm(f"{prefix}.norm2", h, cout, cout, eps, affine=False)
    r = x
    if cin != cout:
        r = g.conv(f"{prefix}.conv3.conv", x, cin, cout, 1, 1, 0,
                   bias=False, qcfg=q_in)
        r = g.group_norm(f"{prefix}.norm3", r, cout, cout, eps,
                         affine=False)
    h = g.add_op(f"{prefix}.add", h, r)
    return g.leaky_relu(f"{prefix}.lrelu_out", h)


def _up_block(g: GraphBuilder, prefix: str, x: str, skip: str, cin: int,
              cout: int, cfg: SwinUNETRConfig, qcfg) -> str:
    """MONAI's UnetrUpBlock: the 2^3 stride-2 transposed conv (a 1^3 conv
    to 8 cout, then depth-to-space), the concat with the skip, a
    UnetResBlock."""
    t = g.add(f"{prefix}.transp_conv.conv", "conv", [x], in_ch=cin,
              out_ch=8 * cout, kernel_size=(1, 1, 1), stride=(1, 1, 1),
              padding=(0, 0, 0), dilation=(1, 1, 1), groups=1, bias=False,
              qcfg=qcfg, transposed=2)
    t = g.depth_to_space(f"{prefix}.transp_conv.d2s", t, 2)
    c = g.concat(f"{prefix}.cat", [t, skip])
    return _res_block(g, f"{prefix}.conv_block", c, 2 * cout, cout, cfg,
                      qcfg)


def _swin_block(g: GraphBuilder, prefix: str, x: str, ch: int, heads: int,
                shift: int, cfg: SwinUNETRConfig, qcfg) -> str:
    eps = cfg.norm_eps
    h = g.layer_norm(f"{prefix}.norm1", x, ch, eps)
    qkv = g.linear(f"{prefix}.attn.qkv", h, ch, 3 * ch, qcfg=qcfg)
    a = g.window_attention(f"{prefix}.attn", qkv, ch, heads,
                           cfg.window_size, shift, qkv)
    a = g.linear(f"{prefix}.attn.proj", a, ch, ch, qcfg=qcfg)
    x = g.add_op(f"{prefix}.add1", x, a)
    h = g.layer_norm(f"{prefix}.norm2", x, ch, eps)
    h = g.linear(f"{prefix}.mlp.linear1", h, ch, cfg.mlp_ratio * ch,
                 qcfg=qcfg)
    h = g.gelu(f"{prefix}.mlp.fn", h)
    h = g.linear(f"{prefix}.mlp.linear2", h, cfg.mlp_ratio * ch, ch,
                 qcfg=qcfg)
    return g.add_op(f"{prefix}.add2", x, h)


def build_swin_unetr(cfg: SwinUNETRConfig) -> Graph:
    g = GraphBuilder()
    inp = g.input()
    f = cfg.feature_size
    qmain = cfg.main_qcfg()
    qfirst = cfg.edge_qcfg(cfg.q_first)
    eps = cfg.norm_eps
    x = g.conv("swinViT.patch_embed.proj", inp, cfg.num_mod, f,
               cfg.patch_size, cfg.patch_size, 0, bias=True, qcfg=qfirst)
    hidden = [g.layer_norm("swinViT.proj_out0", x, f, eps, affine=False)]
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        ch = f * 2 ** i
        stage = f"swinViT.layers{i + 1}.0"
        for b in range(depth):
            shift = cfg.window_size // 2 if b % 2 else 0
            x = _swin_block(g, f"{stage}.blocks.{b}", x, ch, heads, shift,
                            cfg, qmain)
        m = g.patch_merge(f"{stage}.downsample.merge", x)
        m = g.layer_norm(f"{stage}.downsample.norm", m, 8 * ch, eps)
        x = g.linear(f"{stage}.downsample.reduction", m, 8 * ch, 2 * ch,
                     bias=False, qcfg=qmain)
        hidden.append(g.layer_norm(f"swinViT.proj_out{i + 1}", x, 2 * ch,
                                   eps, affine=False))
    enc0 = _res_block(g, "encoder1.layer", inp, cfg.num_mod, f, cfg, qmain,
                      qcfg_in=qfirst)
    enc1 = _res_block(g, "encoder2.layer", hidden[0], f, f, cfg, qmain)
    enc2 = _res_block(g, "encoder3.layer", hidden[1], 2 * f, 2 * f, cfg,
                      qmain)
    enc3 = _res_block(g, "encoder4.layer", hidden[2], 4 * f, 4 * f, cfg,
                      qmain)
    dec4 = _res_block(g, "encoder10.layer", hidden[4], 16 * f, 16 * f, cfg,
                      qmain)
    dec3 = _up_block(g, "decoder5", dec4, hidden[3], 16 * f, 8 * f, cfg,
                     qmain)
    dec2 = _up_block(g, "decoder4", dec3, enc3, 8 * f, 4 * f, cfg, qmain)
    dec1 = _up_block(g, "decoder3", dec2, enc2, 4 * f, 2 * f, cfg, qmain)
    dec0 = _up_block(g, "decoder2", dec1, enc1, 2 * f, f, cfg, qmain)
    out = _up_block(g, "decoder1", dec0, enc0, f, f, cfg, qmain)
    logits = g.conv("out.conv.conv", out, f, cfg.num_classes, 1, 1, 0,
                    bias=True, qcfg=cfg.edge_qcfg(cfg.q_last))
    return g.build([logits])
