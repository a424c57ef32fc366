"""SegResNet: the residual encoder-decoder that MONAI ships for BraTS
(``monai/networks/nets/segresnet.py``, ``SegResNet``, with the blocks of
``monai/networks/blocks/segresnet_block.py``; A. Myronenko, "3D MRI brain
tumor segmentation using autoencoder regularization", BrainLes 2018,
arXiv:1810.11654), built as a graph IR (see nnir.py).

The inference network as MONAI implements it (every conv has padding
``k // 2`` and no bias but the head's):

- ``convInit``: conv 3^3, num_mod -> f (``init_filters``);
- encoder level i = 0..L-1, width f * 2^i: for i > 0 a conv 3^3 of
  stride 2 from the previous width (``down_layers.i.0``), then
  ``blocks_down[i]`` ResBlocks; each level's output is a skip;
- ``ResBlock(c)``: ``y = x + conv2(relu(GN2(conv1(relu(GN1(x))))))``, two
  3^3 convs c -> c, GroupNorm of ``num_groups`` groups with an affine;
- decoder level j = 0..L-2 from the widest: ``x = up(conv1x1(x; c ->
  c/2)) + skip`` (``up_samples.j``: trilinear x2, ``align_corners=False``,
  MONAI's non-trainable upsample), then ``blocks_up[j]`` ResBlocks;
- head (``conv_final``): GN -> relu -> conv 1^3, f -> num_classes, with a
  bias.

Left out, as MONAI's inference network leaves them out: the dropout after
``convInit`` (training only) and the VAE branch of ``SegResNetVAE`` (a
training regularizer).  Node names are MONAI's module paths
(``convInit.conv``, ``down_layers.1.0.conv``,
``down_layers.1.1.conv1.conv``, ``down_layers.1.1.norm1``,
``up_samples.0.0.conv``, ``up_layers.0.0.conv2.conv``, ``conv_final.0``,
``conv_final.2.conv``), so a MONAI state dict maps key for key
(torch_io.py).  The ReLUs, the upsamples and the adds hold no weights and
take names of their own (``.act1``, ``.act2``, ``.add``, ``up_samples.j.1``,
``conv_final.1``).

Quantization as the UResQ presets have it: ``q_first`` and ``q_last``
override the grids of ``convInit`` and the head, every other conv takes
(``qlvl_w``, ``qlvl_act``).  The ResBlock convs read ReLU'd GroupNorm
outputs; the stride-2 convs and the up-projections read the signed
residual stream, which calibration puts on an offset grid
(``run_ptq(act_offset=...)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..nnir import Graph, GraphBuilder, QCfg


@dataclasses.dataclass
class SegResNetConfig:
    num_mod: int = 4
    num_classes: int = 3
    init_filters: int = 32
    blocks_down: Sequence[int] = (1, 2, 2, 4)
    blocks_up: Sequence[int] = (1, 1, 1)
    num_groups: int = 8
    norm_eps: float = 1e-5
    # quantization (as UResQConfig's)
    quantize: bool = False
    qlvl_w: int = 8
    qlvl_act: int = 8
    q_weight: bool = True
    q_act: bool = True
    # (qlvl_w, qlvl_act) of convInit and the head; a level <= 0 disables
    q_first: Optional[Tuple[int, int]] = None
    q_last: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        self.blocks_down = tuple(int(b) for b in self.blocks_down)
        self.blocks_up = tuple(int(b) for b in self.blocks_up)
        if len(self.blocks_up) != len(self.blocks_down) - 1:
            raise ValueError(f"blocks_up {self.blocks_up} needs one level "
                             f"fewer than blocks_down {self.blocks_down}")
        if self.init_filters % self.num_groups:
            raise ValueError(f"init_filters {self.init_filters} is not a "
                             f"multiple of num_groups {self.num_groups}")

    def main_qcfg(self) -> Optional[QCfg]:
        if not self.quantize:
            return None
        return QCfg(q_weight=self.q_weight, qlvl_w=self.qlvl_w,
                    q_act=self.q_act, qlvl_act=self.qlvl_act)

    def edge_qcfg(self, spec: Optional[Tuple[int, int]]) -> Optional[QCfg]:
        """qcfg of convInit or the head from a (qlvl_w, qlvl_act) override;
        None spec -> plain conv."""
        if not self.quantize or spec is None:
            return None
        qw, qa = int(spec[0]), int(spec[1])
        return QCfg(q_weight=qw > 0, qlvl_w=qw, q_act=qa > 0, qlvl_act=qa)


def min_input_divisor(cfg: SegResNetConfig) -> Tuple[int, int, int]:
    """Per-axis divisor of a spatial input shape: one stride-2 conv per
    encoder level after the first, so 2^(levels - 1) per axis; an input
    that reaches a stride-2 conv with an odd extent comes back from the
    decoder's x2 upsample one voxel short of its skip."""
    d = 2 ** (len(cfg.blocks_down) - 1)
    return (d, d, d)


def validate_spatial_shape(shape, cfg: SegResNetConfig, what: str) -> None:
    """Raise a clear ValueError when ``shape`` (D, H, W) cannot flow through
    the encoder and back to its skips."""
    div = min_input_divisor(cfg)
    shape = tuple(int(s) for s in shape)
    bad = [ax for ax in range(3) if shape[ax] % div[ax]]
    if bad:
        axes = "".join("DHW"[ax] for ax in bad)
        raise ValueError(
            f"{what} {shape} is incompatible with the network: axes {axes} "
            f"must be multiples of {div} (one stride-2 conv per encoder "
            f"level after the first), or the decoder's upsampled planes "
            f"cannot match their skip connections")


def _res_block(g: GraphBuilder, prefix: str, x: str, ch: int,
               cfg: SegResNetConfig, qcfg) -> str:
    """MONAI's ResBlock: GN1 -> relu -> conv1 -> GN2 -> relu -> conv2, plus
    the block's input (its relu acts on the norm's output, not on x)."""
    h = g.group_norm(f"{prefix}.norm1", x, ch, cfg.num_groups, cfg.norm_eps)
    h = g.relu(f"{prefix}.act1", h)
    h = g.conv(f"{prefix}.conv1.conv", h, ch, ch, 3, 1, 1, bias=False,
               qcfg=qcfg)
    h = g.group_norm(f"{prefix}.norm2", h, ch, cfg.num_groups, cfg.norm_eps)
    h = g.relu(f"{prefix}.act2", h)
    h = g.conv(f"{prefix}.conv2.conv", h, ch, ch, 3, 1, 1, bias=False,
               qcfg=qcfg)
    return g.add_op(f"{prefix}.add", h, x)


def build_segresnet(cfg: SegResNetConfig) -> Graph:
    g = GraphBuilder()
    x = g.input()
    f = cfg.init_filters
    qmain = cfg.main_qcfg()
    x = g.conv("convInit.conv", x, cfg.num_mod, f, 3, 1, 1, bias=False,
               qcfg=cfg.edge_qcfg(cfg.q_first))
    skips = []
    for i, n_blocks in enumerate(cfg.blocks_down):
        ch = f * 2 ** i
        if i > 0:
            x = g.conv(f"down_layers.{i}.0.conv", x, ch // 2, ch, 3, 2, 1,
                       bias=False, qcfg=qmain)
        for k in range(n_blocks):
            x = _res_block(g, f"down_layers.{i}.{k + 1}", x, ch, cfg, qmain)
        skips.append(x)
    n_up = len(cfg.blocks_up)
    for j, n_blocks in enumerate(cfg.blocks_up):
        ch = f * 2 ** (n_up - j)
        x = g.conv(f"up_samples.{j}.0.conv", x, ch, ch // 2, 1, 1, 0,
                   bias=False, qcfg=qmain)
        x = g.upsample(f"up_samples.{j}.1", x, 2)
        x = g.add_op(f"up_samples.{j}.add", x, skips[n_up - 1 - j])
        for k in range(n_blocks):
            x = _res_block(g, f"up_layers.{j}.{k}", x, ch // 2, cfg, qmain)
    x = g.group_norm("conv_final.0", x, f, cfg.num_groups, cfg.norm_eps)
    x = g.relu("conv_final.1", x)
    x = g.conv("conv_final.2.conv", x, f, cfg.num_classes, 1, 1, 0,
               bias=True, qcfg=cfg.edge_qcfg(cfg.q_last))
    return g.build([x])
