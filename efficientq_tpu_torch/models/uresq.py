"""UResQ: symmetric residual 3D U-Net with deep supervision, built as a
graph IR (see nnir.py).  A copy of the JAX package's ``models/uresq.py``
(graph construction is plain Python), so both packages build the same
graph.

Structural parity with the reference UResQ (src/models/model_blk.py:49-207):

- odd number of stages; strided init conv (init_stride), MaxPool(2) + 1x1-conv
  transition downs, trilinear-up + sum-fusion transition ups
- three conv-block orderings selected by ``blk_type``
  (src/models/factoryQ.py:30-81): 'pre' = BN-ReLU-Drop-Conv,
  'mid' = ReLU-Drop-Conv-BN, 'post' = Drop-Conv-BN-ReLU
- two-block residual unit with 1x1 projection when channels change
  (src/models/factory_blk.py:147-166)
- deep supervision: 1x1 classifier + trilinear up per late decoder stage,
  limited to ``ds_depth_limit`` heads (src/models/model_blk.py:156-178);
  'simple' ds = classifier + single big upsample
  (src/models/factoryQ.py:214-236 with up_times=0)
- dropout halved (capped at 0.2) for stages narrower than drop_cut_thres
  (src/models/model_blk.py:131-134, definer.py:214-217)
- q_first / q_last override quantization of the first/last conv
  (src/models/model_blk.py:98-107); aux classifier convs are never quantized

Node names mirror the reference's torch module paths so torch checkpoints map
key-for-key (see torch_io.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .. import ops
from ..nnir import Graph, GraphBuilder, QCfg


@dataclasses.dataclass
class UResQConfig:
    num_mod: int
    num_classes: int
    depth_config: Sequence[int]
    width_config: Sequence[int]
    dilation_config: Sequence[int]
    init_stride: Tuple[int, int, int] = (1, 1, 1)
    stride: int = 2
    drop_rate: float = 0.25
    blk_type: str = "pre"  # 'pre' | 'mid' | 'post'
    ds: Optional[str] = None  # None | 'simple' | 'complex'
    init_kernel: int = 3
    fuse_bn: bool = False
    # hetero params (definer.py:214-221)
    drop_cut_thres: int = 128
    ds_depth_limit: int = 99999
    aniso_pool_depth: int = 99999
    aniso_pool_stride: Tuple[int, int, int] = (2, 2, 1)
    # nn.ReLU(inplace=True) in the reference mutates block inputs; for the
    # 'mid' ordering this makes the residual add relu(x) instead of x
    # (factory_blk.py:162-166 with NLAConvBN's in-place relu1). True
    # replicates the as-executed (and as-trained) semantics.
    inplace_nla: bool = True
    # quantization
    quantize: bool = False  # False -> plain convs everywhere (qconv='conv')
    qlvl_w: int = 8
    qlvl_act: int = 8
    q_weight: bool = True
    q_act: bool = True
    q_first: Optional[Tuple[int, int]] = None  # (qlvl_w, qlvl_act), <=0 disables
    q_last: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        assert len(self.depth_config) == len(self.width_config) == len(self.dilation_config)
        assert len(self.depth_config) % 2 == 1, "Can only have odd number of UBlocks"
        self.init_stride = ops.triple(self.init_stride)
        assert self.blk_type in ("pre", "mid", "post")

    def main_qcfg(self) -> Optional[QCfg]:
        if not self.quantize:
            return None
        return QCfg(q_weight=self.q_weight, qlvl_w=self.qlvl_w,
                    q_act=self.q_act, qlvl_act=self.qlvl_act)

    def edge_qcfg(self, spec: Optional[Tuple[int, int]]) -> Optional[QCfg]:
        """qcfg for the first/last conv given a (qlvl_w, qlvl_act) override
        (src/models/model_blk.py:98-107). None spec -> plain conv."""
        if not self.quantize or spec is None:
            return None
        qw, qa = int(spec[0]), int(spec[1])
        return QCfg(q_weight=qw > 0, qlvl_w=qw, q_act=qa > 0, qlvl_act=qa)


def min_input_divisor(cfg: UResQConfig) -> Tuple[int, int, int]:
    """Smallest per-axis divisor a spatial input shape must satisfy.

    The init conv divides each axis by init_stride and every encoder stage
    pools by 2 (anisotropic stages by aniso_pool_stride); an input that
    reaches a pool with an odd extent floors there, so the decoder's
    upsample re-doubles to a SMALLER extent and the skip-fusion add
    mismatches (the torch reference fails the same way inside SumFusion).
    """
    n_updown = len(cfg.depth_config) // 2
    div = list(ops.triple(cfg.init_stride))
    for i in range(n_updown):
        k = ops.triple(cfg.stride if i < cfg.aniso_pool_depth
                       else cfg.aniso_pool_stride)
        for ax in range(3):
            div[ax] *= k[ax]
    return tuple(div)


def validate_spatial_shape(shape, cfg: UResQConfig, what: str) -> None:
    """Raise a clear ValueError when ``shape`` (D, H, W) cannot flow through
    the network's encoder/decoder without a skip-shape mismatch."""
    div = min_input_divisor(cfg)
    shape = tuple(int(s) for s in shape)
    bad = [ax for ax in range(3) if shape[ax] % div[ax]]
    if bad:
        axes = "".join("DHW"[ax] for ax in bad)
        raise ValueError(
            f"{what} {shape} is incompatible with the network: axes {axes} "
            f"must be multiples of {div} (init_stride x one pool-2 per "
            f"encoder stage), or the decoder's upsampled planes cannot "
            f"match their skip connections")


def _block(g: GraphBuilder, prefix: str, x: str, in_ch: int, out_ch: int,
           cfg: UResQConfig, kernel: int, stride, padding, dilation,
           drop_rate: float, qcfg) -> str:
    """One conv block in the configured ordering. Returns output node name.

    'pre':  bn -> relu -> drop -> conv      (factoryQ.py:30-45)
    'mid':  relu -> drop -> conv -> bn      (factoryQ.py:66-81)
    'post': drop -> conv -> bn -> relu      (factoryQ.py:48-63)
    """
    t = cfg.blk_type
    if t == "pre":
        x = g.bn(f"{prefix}.bn", x, in_ch)
        x = g.relu(f"{prefix}.relu", x)
        if drop_rate > 0:
            x = g.dropout(f"{prefix}.do", x, drop_rate)
        x = g.conv(f"{prefix}.conv", x, in_ch, out_ch, kernel, stride, padding,
                   dilation, bias=False, qcfg=qcfg)
    elif t == "mid":
        x = g.relu(f"{prefix}.relu", x)
        if drop_rate > 0:
            x = g.dropout(f"{prefix}.do", x, drop_rate)
        x = g.conv(f"{prefix}.conv", x, in_ch, out_ch, kernel, stride, padding,
                   dilation, bias=False, qcfg=qcfg)
        x = g.bn(f"{prefix}.bn", x, out_ch)
    else:  # post
        if drop_rate > 0:
            x = g.dropout(f"{prefix}.do", x, drop_rate)
        x = g.conv(f"{prefix}.conv", x, in_ch, out_ch, kernel, stride, padding,
                   dilation, bias=False, qcfg=qcfg)
        x = g.bn(f"{prefix}.bn", x, out_ch)
        x = g.relu(f"{prefix}.relu", x)
    return x


def _res_block(g: GraphBuilder, prefix: str, x: str, in_ch: int, out_ch: int,
               cfg: UResQConfig, dilation: int, drop_rate: float, qcfg) -> str:
    """ResBlockWithType (factory_blk.py:147-166): block1 (no drop) -> block2
    (drop) -> + projection(x).

    In-place ReLU semantics: with the 'mid' ordering and inplace nla, the
    reference's block1 relu mutates the residual source in place, so the
    skip path adds relu(x) (and the projection conv, when present, consumes
    relu(x)) — replicated here by tapping block1's relu node.
    """
    inp = x
    h = _block(g, f"{prefix}.block1", x, in_ch, out_ch, cfg, 3, 1, dilation,
               dilation, 0.0, qcfg)
    if cfg.blk_type == "mid" and cfg.inplace_nla:
        residual_src = f"{prefix}.block1.relu"
    else:
        residual_src = inp
    h = _block(g, f"{prefix}.block2", h, out_ch, out_ch, cfg, 3, 1, dilation,
               dilation, drop_rate, qcfg)
    if in_ch != out_ch:
        proj = g.conv(f"{prefix}.projection", residual_src, in_ch, out_ch, 1,
                      1, 0, bias=False, qcfg=qcfg)
    else:
        proj = residual_src
    return g.add_op(f"{prefix}.add", h, proj)


def _stage_drop_rate(cfg: UResQConfig, width: int) -> float:
    dr = cfg.drop_rate
    if dr > 0 and width < cfg.drop_cut_thres:
        dr = min(cfg.drop_rate / 2, 0.2)
    return dr


def _down(g: GraphBuilder, prefix: str, x: str, in_ch: int, out_ch: int,
          cfg: UResQConfig, kernel, qcfg) -> str:
    """MaxPool + 1x1 conv block (factory_blk.py:96-119)."""
    x = g.maxpool(f"{prefix}.pool", x, kernel)
    return _block(g, f"{prefix}.block", x, in_ch, out_ch, cfg, 1, 1, 0, 1, 0.0, qcfg)


def _up(g: GraphBuilder, prefix: str, x: str, in_ch: int, out_ch: int,
        cfg: UResQConfig, scale, qcfg) -> str:
    """1x1 conv block (iff channels change) + trilinear up
    (factory_blk.py:122-144)."""
    if in_ch != out_ch:
        x = _block(g, f"{prefix}.block", x, in_ch, out_ch, cfg, 1, 1, 0, 1, 0.0, qcfg)
    return g.upsample(f"{prefix}.trilinear", x, scale)


def build_uresq(cfg: UResQConfig) -> Graph:
    g = GraphBuilder()
    x = g.input()
    widths = list(cfg.width_config)
    depths = list(cfg.depth_config)
    dils = list(cfg.dilation_config)
    n_stages = len(widths)
    n_updown = n_stages // 2
    qmain = cfg.main_qcfg()

    # conv0 (model_blk.py:109-124): strided init conv; 'mid' adds bn,
    # 'post' adds bn+relu, 'pre' conv only.
    pad0 = (cfg.init_kernel - 1) // 2
    x = g.conv("conv0.conv", x, cfg.num_mod, widths[0], cfg.init_kernel,
               cfg.init_stride, pad0, bias=False, qcfg=cfg.edge_qcfg(cfg.q_first))
    if cfg.blk_type in ("mid", "post"):
        x = g.bn("conv0.bn", x, widths[0])
    if cfg.blk_type == "post":
        x = g.relu("conv0.relu", x)

    skips: List[str] = []
    heads: List[str] = []

    for i in range(n_stages):
        dr = _stage_drop_rate(cfg, widths[i])
        # UResBlock i+1: depth_config[i] residual blocks (factoryQ.py:202-211)
        in_ch = widths[i]
        for j in range(depths[i]):
            x = _res_block(g, f"u_blocks.UResBlock{i+1}.Layer{j+1}", x,
                           in_ch, widths[i], cfg, dils[i], dr, qmain)
            in_ch = widths[i]

        if i < n_updown:
            skips.append((x, widths[i]))
            kernel = cfg.stride if i < cfg.aniso_pool_depth else cfg.aniso_pool_stride
            x = _down(g, f"trans_downs.TransDown{i+1}", x, widths[i],
                      widths[i + 1], cfg, kernel, qmain)
        elif i < n_stages - 1:
            # aux head BEFORE the up-transition (model_blk.py:200-203)
            if cfg.ds and (n_stages - i) <= cfg.ds_depth_limit:
                heads.append(_aux_head(g, f"classifiers.AuxClassifier{i+1}", x,
                                       widths[i], i, cfg))
            iso = i >= n_stages - 1 - cfg.aniso_pool_depth
            scale = cfg.stride if iso else cfg.aniso_pool_stride
            up = _up(g, f"trans_ups.TransUp{i+1}.upsampler", x, widths[i],
                     widths[i + 1], cfg, scale, qmain)
            skip_node, skip_ch = skips[-(i - n_updown + 1)]
            assert skip_ch == widths[i + 1]
            if cfg.fuse_bn and cfg.blk_type != "mid":
                # SumFusion with per-branch BN (factoryQ.py:109-128)
                up = g.bn(f"trans_ups.TransUp{i+1}.bn_x", up, widths[i + 1])
                skip_node = g.bn(f"trans_ups.TransUp{i+1}.bn_skip", skip_node,
                                 widths[i + 1])
            x = g.add_op(f"trans_ups.TransUp{i+1}.add", up, skip_node)

    # final classifier (model_blk.py:180-186)
    x = g.conv("final_cls.cls", x, widths[-1], cfg.num_classes, 1, 1, 0,
               bias=True, qcfg=cfg.edge_qcfg(cfg.q_last))
    if cfg.init_stride != (1, 1, 1):
        x = g.upsample("final_cls.extra_up", x, cfg.init_stride)
    heads.append(x)

    return g.build(heads)


def _aux_head(g: GraphBuilder, prefix: str, x: str, in_ch: int, stage: int,
              cfg: UResQConfig) -> str:
    """Deep-supervision head (factoryQ.py:214-236). Plain (non-quantized)
    convs, matching Conv=nn.Conv3d in model_blk.py:163,171."""
    n_stages = len(cfg.width_config)
    channel_config = list(cfg.width_config[stage + 1:])
    if cfg.ds == "simple":
        # 1x1 classifier then one big trilinear up: init_stride * 2^len
        # (model_blk.py:159-167 with up_times=0)
        scale = tuple(s * (2 ** len(channel_config)) for s in cfg.init_stride)
        x = g.conv(f"{prefix}.classifier", x, in_ch, cfg.num_classes, 1, 1, 0,
                   bias=True)
        x = g.upsample(f"{prefix}.extra_up", x, scale)
        return x
    # 'complex': chain of upsampler blocks then classifier + init_stride up
    # (model_blk.py:169-174, factoryQ.py:214-236).  Reference quirk: the aux
    # chain's Upper is constructed WITHOUT blk_type (model_blk.py:170-174),
    # so non-mid networks get LinearUp3dWithType's default 'pre' ordering
    # in their aux heads (factory_blk.py:122-123).
    aux_cfg = cfg
    if cfg.blk_type != "mid":
        aux_cfg = dataclasses.replace(cfg, blk_type="pre")
    cur = in_ch
    for k, ch in enumerate(channel_config):
        x = _up(g, f"{prefix}.up{k+1}", x, cur, ch, aux_cfg, cfg.stride, None)
        cur = ch
    x = g.conv(f"{prefix}.classifier", x, cur, cfg.num_classes, 1, 1, 0, bias=True)
    if cfg.init_stride != (1, 1, 1):
        x = g.upsample(f"{prefix}.extra_up", x, cfg.init_stride)
    return x


def num_mo(cfg: UResQConfig) -> int:
    """Number of model outputs (deep-supervision heads + final), mirroring
    definer.py:232-235."""
    if cfg.ds:
        return min(cfg.ds_depth_limit, len(cfg.depth_config) // 2 + 1)
    return 1


# -----------------------------------------------------------------------
# preset factories mirroring definer.get_model_cube (src/definer.py:130-248)
# -----------------------------------------------------------------------


def preset_config(task: str, quantize: bool = False, qlvl_w: int = 4,
                  qlvl_act: int = 4, q_first=(256, -1), q_last=(256, -1),
                  ds: str = "simple", blk_type: str = "mid",
                  drop_rate: float = 0.5) -> UResQConfig:
    """BraTS / LiTS presets from config/{brats,lits}_{fp,ptq}.yaml."""
    task = task.lower()
    if task == "brats":
        widths = [32, 64, 128, 256, 128, 64, 32]
        init_stride = (2, 2, 2)
        num_mod, num_classes = 4, 3  # 4 classes - 1 (multi_label)
    elif task == "lits":
        widths = [32, 64, 128, 256, 512, 256, 128, 64, 32]
        init_stride = (2, 2, 1)
        num_mod, num_classes = 1, 3
    else:
        raise ValueError(f"unknown task {task}")
    n = len(widths)
    # hetero params (definer.py:214-221): ds_depth_limit=3 when init stride
    # contains a 2; aniso pooling disabled in that case (hetero_dim=true)
    ds_depth_limit = 3 if 2 in init_stride else 4
    aniso_pool_depth = 99999 if 2 in init_stride else 4
    return UResQConfig(
        num_mod=num_mod, num_classes=num_classes,
        depth_config=[1] * n, width_config=widths, dilation_config=[1] * n,
        init_stride=init_stride, stride=2, drop_rate=drop_rate,
        blk_type=blk_type, ds=ds, init_kernel=3, fuse_bn=True,
        drop_cut_thres=128, ds_depth_limit=ds_depth_limit,
        aniso_pool_depth=aniso_pool_depth, aniso_pool_stride=(2, 2, 1),
        quantize=quantize, qlvl_w=qlvl_w,
        qlvl_act=qlvl_act if qlvl_act > 0 else 256,
        q_weight=qlvl_w > 0, q_act=qlvl_act > 0,
        q_first=q_first, q_last=q_last,
    )
