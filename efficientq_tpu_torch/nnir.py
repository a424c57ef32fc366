"""A minimal functional graph IR for 3D segmentation networks (PyTorch).

Counterpart of the JAX package's ``nnir.py``: the same ``Node`` / ``Graph``
data and the same flat ``{"params": {node: {...}}, "state": {...}}``
variables, with torch tensors in place of jax arrays.  Tensors are NDHWC
and conv kernels DHWIO (see ops.py).

``apply`` interprets the graph eagerly, so it does by hand what XLA's
dead-code elimination and buffer reuse did for the JAX interpreter under
``jit``:

- it evaluates only the nodes that the selected outputs reach (the aux
  heads that ``heads=slice(-1, None)`` drops, and the relus that
  ``kernels.epilogue`` rewires away, are never computed);
- it frees each value after its last consumer.

``apply(compute_dtype=torch.bfloat16)`` is low-precision serving, as in
the JAX package: K1 nodes emit bfloat16 and take their residual in
bfloat16, plain convs run on bfloat16 operands and emit bfloat16, the
int8 1x1 convs (on K3 or off the kernel path) and the K4 convs still emit
float32, and the head outputs come back as float32 unless
``keep_head_dtype``.

Modes: 'fp' (plain convs), 'quantized' (fake-quant activations, stored
post-PTQ weights) and 'fq' (weights fake-quantized on the fly as well);
int8-deployed nodes run on integer codes in both quantized modes.

``apply(train=True, seed=...)`` is the training forward, the counterpart
of the JAX package's ``apply(train=True, rng=...)``: batch norm normalizes
with batch statistics and returns its running-stat update, dropout draws
its mask from a generator seeded from (``seed``, the node's topological
index), and ``remat=N`` runs N-node segments under
``torch.utils.checkpoint``.  A stateful generator would be advanced again
when a segment is recomputed and draw another mask; a mask that is a pure
function of (seed, index) is drawn the same in both.  With
``compute_dtype`` in ``fp`` mode (``--amp``) the convs run at that dtype,
batch norm takes its statistics and running-stat EMA in float32 and
re-emits at that dtype, and the heads come back as float32: JAX's casts,
at JAX's rounding points.

``GraphModule`` holds a graph and its variables as an ``nn.Module``, so
``.to(device)`` moves every tensor of the network at once.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import ops
from .kernels import WRAPPERS, Kernels
from .kernels.groupnorm import group_norm as _k6, group_norm_reference
from .kernels.qmatmul import qconv1x1_ndhwc
from .kernels.window_attention import (window_attention as _k7,
                                       window_count)
from .quant import (act_codes, fake_quant_act, fake_quant_act_k,
                    fake_quant_weight)

QUANT_MODES = ("quantized", "fq")


@dataclasses.dataclass(frozen=True)
class QCfg:
    """Per-conv quantization config."""

    q_weight: bool
    qlvl_w: int
    q_act: bool
    qlvl_act: int


@dataclasses.dataclass
class Node:
    name: str
    op: str
    inputs: Tuple[str, ...]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Graph:
    nodes: List[Node]
    outputs: List[str]  # head node names, shallow-to-deep aux heads then final
    input_name: str = "input"

    _index: Optional[Dict[str, Node]] = None

    def node(self, name: str) -> Node:
        if self._index is None or len(self._index) != len(self.nodes):
            self._index = {n.name: n for n in self.nodes}
        return self._index[name]

    def qconv_nodes(self) -> List[Node]:
        """Convs carrying a quantization config, in topological order."""
        return [n for n in self.nodes if n.op == "conv" and n.attrs.get("qcfg")]

    def consumers(self, nodes: Optional[Dict[str, Node]] = None
                  ) -> Dict[str, List[str]]:
        """{producer name: [consumer names]}; graph outputs appear as the
        external consumer ``"__output__"``.  ``nodes`` optionally substitutes
        in-flight rewritten nodes (same names, possibly rewired inputs)."""
        out: Dict[str, List[str]] = {}
        for n in self.nodes:
            for i in (nodes[n.name] if nodes is not None else n).inputs:
                out.setdefault(i, []).append(n.name)
        for o in self.outputs:
            out.setdefault(o, []).append("__output__")
        return out


class GraphBuilder:
    def __init__(self):
        self.nodes: List[Node] = []
        self.names = set()

    def add(self, name: str, op: str, inputs: Sequence[str], **attrs) -> str:
        assert name not in self.names, f"duplicate node {name}"
        self.names.add(name)
        self.nodes.append(Node(name, op, tuple(inputs), attrs))
        return name

    def input(self, name="input"):
        return self.add(name, "input", ())

    def conv(self, name, x, in_ch, out_ch, kernel_size, stride=1, padding=0,
             dilation=1, groups=1, bias=True, qcfg: Optional[QCfg] = None):
        return self.add(name, "conv", [x], in_ch=in_ch, out_ch=out_ch,
                        kernel_size=ops.triple(kernel_size),
                        stride=ops.triple(stride),
                        padding=ops.triple(padding),
                        dilation=ops.triple(dilation),
                        groups=groups, bias=bias, qcfg=qcfg)

    def bn(self, name, x, ch, eps=1e-5, momentum=0.1):
        return self.add(name, "bn", [x], ch=ch, eps=eps, momentum=momentum)

    def group_norm(self, name, x, ch, num_groups, eps=1e-5, affine=True):
        """GroupNorm over ``num_groups`` groups of ``ch`` channels, with a
        per-channel affine (``scale``, ``bias``) and no running
        statistics.  ``affine=False`` (InstanceNorm's default): the
        variables still hold scale 1 and bias 0, which no checkpoint
        carries."""
        return self.add(name, "group_norm", [x], ch=ch,
                        num_groups=int(num_groups), eps=float(eps),
                        affine=bool(affine))

    def linear(self, name, x, in_ch, out_ch, bias=True,
               qcfg: Optional[QCfg] = None):
        """A linear layer over the channels: a 1x1x1 conv whose weight a
        checkpoint holds as nn.Linear's (out, in) (``torch_io``)."""
        return self.add(name, "conv", [x], in_ch=in_ch, out_ch=out_ch,
                        kernel_size=(1, 1, 1), stride=(1, 1, 1),
                        padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                        bias=bias, qcfg=qcfg, linear=True)

    def layer_norm(self, name, x, ch, eps=1e-5, affine=True):
        """LayerNorm over the ``ch`` channels of each voxel, with a
        per-channel affine (``scale``, ``bias``) unless ``affine`` is
        False."""
        return self.add(name, "layer_norm", [x], ch=ch, eps=float(eps),
                        affine=bool(affine))

    def leaky_relu(self, name, x, slope=0.01):
        return self.add(name, "leaky_relu", [x], slope=float(slope))

    def gelu(self, name, x):
        """The exact (erf) GELU."""
        return self.add(name, "gelu", [x])

    def concat(self, name, xs):
        """The inputs joined along the channels, in order."""
        return self.add(name, "concat", list(xs))

    def depth_to_space(self, name, x, factor=2):
        """(N, D, H, W, f^3 C) -> (N, fD, fH, fW, C): channel t C + o of
        voxel (z, y, x) goes to voxel (f z + a, f y + b, f x + c), t = (a f
        + b) f + c (a transposed conv of kernel f and stride f, after its
        1x1 conv to f^3 C)."""
        return self.add(name, "depth_to_space", [x], factor=int(factor))

    def window_attention(self, name, qkv, ch, num_heads, window, shift,
                         qkv_node):
        """Window self-attention (``kernels/window_attention.py``) of the
        qkv linear ``qkv_node``'s output: ``ch`` channels of ``num_heads``
        heads, the configured ``window`` and ``shift`` triples; the
        variables hold ``relative_position_bias_table``.  A padded token's
        key and value are ``qkv_node``'s bias."""
        return self.add(name, "window_attention", [qkv], ch=ch,
                        num_heads=int(num_heads), window=ops.triple(window),
                        shift=ops.triple(shift), qkv_node=qkv_node)

    def patch_merge(self, name, x):
        """MONAI's v0.9 ``PatchMerging`` gather: odd extents padded with
        zeros, then the eight 2x2x2 sub-grids joined along the channels in
        its source's order (x0 ... x7: offsets (0,0,0), (1,0,0), (0,1,0),
        (0,0,1), (1,0,1), (0,1,0), (0,0,1), (1,1,1)), (N, D, H, W, C) ->
        (N, D/2, H/2, W/2, 8C)."""
        return self.add(name, "patch_merge", [x])

    def relu(self, name, x):
        return self.add(name, "relu", [x])

    def maxpool(self, name, x, kernel, stride=None):
        return self.add(name, "maxpool", [x], kernel=ops.triple(kernel),
                        stride=ops.triple(stride if stride is not None
                                          else kernel))

    def upsample(self, name, x, scale_factor):
        return self.add(name, "upsample", [x],
                        scale_factor=ops.triple(scale_factor))

    def dropout(self, name, x, rate):
        return self.add(name, "dropout", [x], rate=float(rate))

    def add_op(self, name, a, b):
        return self.add(name, "add", [a, b])

    def identity(self, name, x):
        return self.add(name, "identity", [x])

    def build(self, outputs: Sequence[str], input_name="input") -> Graph:
        return Graph(self.nodes, list(outputs), input_name)


def to_device(variables: Dict[str, Any], device) -> Dict[str, Any]:
    """The ``{'params', 'state'}`` dicts with every entry a tensor on
    ``device`` (the input untouched)."""
    return {group: {node: {k: torch.as_tensor(v).to(device)
                           for k, v in entries.items()}
                    for node, entries in variables.get(group, {}).items()}
            for group in ("params", "state")}


def init(graph: Graph, seed: int = 0, device="cuda"):
    """{'params': ..., 'state': ...} on ``device``, with kaiming-normal conv
    kernels drawn from ``np.random.default_rng(seed)``, zero biases, unit
    alphas, and identity batch norms.  The numbers differ from the JAX
    package's ``init`` (another generator); tests carry weights across with
    ``models.torch_io.from_jax_variables``."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    state: Dict[str, Dict[str, torch.Tensor]] = {}
    for node in graph.nodes:
        if node.op == "conv":
            a = node.attrs
            kshape = (*a["kernel_size"], a["in_ch"] // a["groups"], a["out_ch"])
            std = np.sqrt(2.0 / (np.prod(a["kernel_size"]) * kshape[3]))
            p = {"kernel": torch.as_tensor(
                std * rng.standard_normal(kshape), **f32)}
            if a["bias"]:
                p["bias"] = torch.zeros(a["out_ch"], **f32)
            if a.get("qcfg"):
                p["alpha_w"] = torch.tensor(1.0, **f32)
                p["alpha_act"] = torch.tensor(1.0, **f32)
            params[node.name] = p
        elif node.op == "bn":
            ch = node.attrs["ch"]
            params[node.name] = {"scale": torch.ones(ch, **f32),
                                 "bias": torch.zeros(ch, **f32)}
            state[node.name] = {"mean": torch.zeros(ch, **f32),
                                "var": torch.ones(ch, **f32)}
        elif node.op == "group_norm" or (node.op == "layer_norm"
                                         and node.attrs["affine"]):
            ch = node.attrs["ch"]
            params[node.name] = {"scale": torch.ones(ch, **f32),
                                 "bias": torch.zeros(ch, **f32)}
        elif node.op == "window_attention":
            w = node.attrs["window"]
            rows = (2 * w[0] - 1) * (2 * w[1] - 1) * (2 * w[2] - 1)
            params[node.name] = {"relative_position_bias_table":
                                 torch.as_tensor(0.02 * rng.standard_normal(
                                     (rows, node.attrs["num_heads"])),
                                     **f32)}
    return {"params": params, "state": state}


def _pallas_1x1_eligible(a) -> bool:
    """1x1x1 convs that are a matmul over channels: stride 1, no padding,
    one group."""
    return (a["kernel_size"] == (1, 1, 1) and a["stride"] == (1, 1, 1)
            and a["padding"] == (0, 0, 0) and a["groups"] == 1)


def _pallas_3x3_int8_eligible(a) -> bool:
    """Interior 3^3 qconvs: stride 1, isotropic 'same' padding = dilation."""
    return (a["kernel_size"] == (3, 3, 3) and a["stride"] == (1, 1, 1)
            and a["padding"] == a["dilation"] and len(set(a["dilation"])) == 1
            and a["groups"] == 1)


def int_conv_dtype(taps: int, c: int, qlvl_act: int, qlvl_w: int):
    """Float type in which a conv of integer codes is exact.  Every partial
    sum is an integer of magnitude at most taps*C*(na-1)*(nw-1); float32
    holds those exactly below 2**24 (every preset's 1x1 int8 convs: at most
    512*127*127 = 8.2 M), float64 beyond."""
    bound = taps * c * (qlvl_act - 1) * (qlvl_w - 1)
    return torch.float32 if bound < 2 ** 24 else torch.float64


def _int8_conv(qa: torch.Tensor, codes: torch.Tensor, a, qcfg: QCfg):
    """Integer conv of int8 codes computed exactly in a float type (the
    JAX package's XLA int8 conv with int32 accumulation), returned as
    float32: an exact integer, or the float64 sum rounded half to even as
    int32 -> float32 rounds."""
    k = a["kernel_size"]
    c = qa.shape[-1]
    dt = int_conv_dtype(k[0] * k[1] * k[2], c, qcfg.qlvl_act, qcfg.qlvl_w)
    if _pallas_1x1_eligible(a):
        y = torch.matmul(qa.reshape(-1, c).to(dt), codes.reshape(c, -1).to(dt))
        y = y.reshape(*qa.shape[:-1], -1)
    else:
        y = ops.conv3d(qa.to(dt), codes.to(dt), None, a["stride"],
                       a["padding"], a["dilation"], a["groups"])
    return y.to(torch.float32)


def _eval_conv(node: Node, params, ins, mode: str, kernels: Kernels,
               compute_dtype=None):
    a = node.attrs
    p = params[node.name]
    x = ins[0]
    qcfg: Optional[QCfg] = a.get("qcfg")
    if (a.get("pallas") and mode in QUANT_MODES and qcfg is not None
            and qcfg.q_act):
        if not (a.get("int8") and a["kernel_size"] == (3, 3, 3)):
            return _eval_fused_1x1(node, p, x, mode, kernels)
        # the deployed hot path: the int8 3^3 conv with its fused
        # epilogues (kernels/qconv3d.py; flags from kernels/qmatmul.py and
        # kernels/epilogue.py), emitting compute_dtype; at a compute dtype
        # the residual streams in that dtype too
        quant_for = a.get("epilogue_quant_for")
        res = ins[1] if a.get("residual") else None
        if res is not None and compute_dtype is not None:
            res = res.to(compute_dtype)
        return kernels.conv3x3_int8(
            x, p["kernel_int8"], p.get("bias"), p["alpha_act"], p["scale"],
            qcfg.qlvl_act, dilation=a["dilation"][0], residual=res,
            quant_alpha=(params[quant_for]["alpha_act"] if quant_for
                         else None),
            quant_qlvl=a.get("epilogue_qlvl", 0) if quant_for else 0,
            x_quantized=bool(a.get("input_quantized")),
            residual_relu=bool(a.get("residual_relu")),
            pool=bool(a.get("epilogue_pool")),
            w_packed=p.get("kernel_packed"),
            out_dtype=compute_dtype or torch.float32, **_act_k(a))
    if a.get("int8") and mode in QUANT_MODES:
        # integer path of ptq/deploy.py: int8 codes in, exact integer conv,
        # float32 scale epilogue (float32 at any compute dtype, as in the
        # JAX package)
        # an offset grid (act_k, a static int) gives signed codes in
        # [-k, n-1-k]; zero stays on the grid, so the zero padding and the
        # scale epilogue are unchanged
        qa = (x if a.get("input_quantized")
              else act_codes(x, p["alpha_act"], qcfg.qlvl_act,
                             a.get("act_k", 0)))
        y = _int8_conv(qa, p["kernel_int8"], a, qcfg) * p["scale"]
        if "bias" in p:
            y = y + p["bias"]
        return y
    x, kernel = _quantize_operands(x, p, a, mode)
    bias = p.get("bias")
    if compute_dtype is not None:
        # low precision: operands cast, the conv emits compute_dtype (one
        # rounding of a float32 accumulation), the bias is added in it
        y = ops.conv3d(x.to(compute_dtype), kernel.to(compute_dtype), None,
                       a["stride"], a["padding"], a["dilation"], a["groups"])
        return y if bias is None else y + bias.to(compute_dtype)
    return ops.conv3d(x, kernel, bias, a["stride"], a["padding"],
                      a["dilation"], a["groups"])


def _act_k(a) -> Dict[str, int]:
    """The offset-grid keyword of a flagged conv's kernel call: {} on the
    unsigned grid, so a kernel record entry without it still serves
    every other graph."""
    return {"act_k": a["act_k"]} if a.get("act_k") else {}


def _quantize_operands(x, p, a, mode: str):
    """(x, kernel) of a float conv: the activations fake-quantized with
    ``q_act`` in both quantized modes (on the offset grid ``act_k`` where
    calibration chose one: the node's static attribute if deployment baked
    it, else the calibrated parameter), the weights fake-quantized on the
    fly in 'fq' (after PTQ the stored kernel already holds quantized
    values)."""
    kernel = p["kernel"]
    qcfg: Optional[QCfg] = a.get("qcfg")
    if qcfg is not None and mode in QUANT_MODES:
        if qcfg.q_act:
            ak = a.get("act_k", p.get("act_k"))
            if ak is None:
                x = fake_quant_act(x, p["alpha_act"], qcfg.qlvl_act)
            else:
                x = fake_quant_act_k(x, p["alpha_act"], qcfg.qlvl_act, ak)
        if mode == "fq" and qcfg.q_weight:
            kernel = fake_quant_weight(kernel, p["alpha_w"], qcfg.qlvl_w)
    return x, kernel


def _eval_fused_1x1(node: Node, p, x, mode: str, kernels: Kernels):
    """A flagged 1x1x1 conv (``to_pallas_inference(include_1x1=True)``):
    int8 nodes on K3, the others on K4 through ``qconv1x1_ndhwc`` (weights
    fake-quantized first in 'fq').  Both take the float activation, whatever
    its dtype, and emit float32, as the JAX kernels do."""
    a = node.attrs
    qcfg: QCfg = a["qcfg"]
    if a.get("input_quantized"):
        raise ValueError(f"{node.name}: a flagged 1x1 conv quantizes its "
                         f"float input itself and cannot take int8 codes")
    if a.get("int8"):
        # K3's packed weights (made at deploy time) go as the seventh
        # argument, so an entry with K3's positional signature takes them too
        n, d, h, w, c = x.shape
        y = kernels.int8_matmul(
            x.reshape(-1, c), p["kernel_int8"].reshape(c, -1), p.get("bias"),
            p["alpha_act"], p["scale"], qcfg.qlvl_act, p.get("kernel_packed"),
            **_act_k(a))
        return y.reshape(n, d, h, w, -1)
    kernel = p["kernel"]
    if mode == "fq" and qcfg.q_weight:
        kernel = fake_quant_weight(kernel, p["alpha_w"], qcfg.qlvl_w)
    return qconv1x1_ndhwc(x, kernel, p.get("bias"), p["alpha_act"],
                          qcfg.qlvl_act, matmul=kernels.qact_matmul)


def _eval_conv_cf(node: Node, params, x, mode: str, compute_dtype=None):
    """The channels-first head (``ptq.deploy.channels_first_tail``): the
    1x1 classifier emits contiguous NCDHW, so the upsample and the stitch
    after it run along W instead of over a 3-channel minor axis."""
    p = params[node.name]
    x, kernel = _quantize_operands(x, p, node.attrs, mode)
    if compute_dtype is not None:
        x, kernel = x.to(compute_dtype), kernel.to(compute_dtype)
    y = ops.conv3d_ncdhw_out(x, kernel)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype).reshape(1, -1, 1, 1, 1)
    return y


def eval_node(node: Node, params: Dict[str, Any], state: Dict[str, Any],
              ins, *, mode: str = "fp", kernels: Optional[Kernels] = None,
              compute_dtype=None):
    """Evaluate one inference-mode node.  ``kernels`` (``kernels.Kernels``,
    by default the wrappers) runs the flagged nodes: the int8 3^3 convs
    (K1), the s2d stem (K2), the int8 1x1 convs (K3), the fake-quant 1x1
    convs (K4), the serving upsamples (K5, the ``upsample_k5`` nodes of
    ``ptq.deploy.upsample_serving``), the serving GroupNorms (K6, the
    ``group_norm_k6`` nodes of ``ptq.deploy.group_norm_serving``) and every
    window attention (K7).  Every GroupNorm node, either kind, adds the
    elements it normalizes to ``group_norm.elements`` of
    ``kernels/groupnorm.py``, every LayerNorm node to
    ``ops.layer_norm.elements``, every window attention its (sample,
    window, head) count to ``window_attention.window_heads``."""
    kernels = kernels or WRAPPERS
    if node.op == "conv":
        return _eval_conv(node, params, ins, mode, kernels, compute_dtype)
    if node.op == "conv_cf":
        return _eval_conv_cf(node, params, ins[0], mode, compute_dtype)
    if node.op == "upsample_cf":
        return ops.upsample3d_cf(ins[0], node.attrs["scale_factor"])
    if node.op == "upsample_k5":
        # inputs (x) or (x, skip): the TransUp skip added in K5's epilogue
        return kernels.upsample(
            ins[0], node.attrs["scale_factor"],
            ins[1] if len(ins) > 1 else None, node.attrs["channels_first"])
    if node.op == "stem_s2d":
        # the fused space-to-depth stem (kernels/stem.py, rewritten by
        # ptq/deploy.py::s2d_stem_serving): the input is the (s2d patches,
        # parities) pair; returns (relu'd activation at compute_dtype, the
        # consumer's int8 codes)
        xs, par = ins[0]
        p = params[node.name]
        return kernels.stem_conv(
            xs, par, p["w_even"], p["w_odd"], p["bias"], p["alpha_next"],
            node.attrs["qlvl_next"], out_dtype=compute_dtype or torch.float32,
            w_packed=p.get("kernel_packed"))
    if node.op == "bn":
        p = params[node.name]
        s = state[node.name]
        return ops.batch_norm(ins[0], p["scale"], p["bias"], s["mean"],
                              s["var"], node.attrs["eps"])
    if node.op in ("group_norm", "group_norm_k6"):
        return _eval_group_norm(node, params, ins[0], kernels)
    if node.op == "layer_norm":
        p = params.get(node.name, {})
        return ops.layer_norm(ins[0], p.get("scale"), p.get("bias"),
                              node.attrs["eps"])
    if node.op == "window_attention":
        a = node.attrs
        x = ins[0]
        _k7.window_heads += x.shape[0] * a["num_heads"] * window_count(
            x.shape[1:4], a["window"], a["shift"])
        return kernels.window_attention(
            x, params[node.name]["relative_position_bias_table"],
            params[a["qkv_node"]].get("bias"), a["num_heads"], a["window"],
            a["shift"])
    if node.op == "relu":
        return ops.relu(ins[0])
    if node.op == "leaky_relu":
        return torch.nn.functional.leaky_relu(ins[0], node.attrs["slope"])
    if node.op == "gelu":
        return torch.nn.functional.gelu(ins[0])
    if node.op == "concat":
        return torch.cat(ins, dim=-1)
    if node.op == "depth_to_space":
        return ops.depth_to_space(ins[0], node.attrs["factor"])
    if node.op == "patch_merge":
        return ops.patch_merge(ins[0])
    if node.op == "maxpool":
        return ops.max_pool3d(ins[0], node.attrs["kernel"],
                              node.attrs["stride"])
    if node.op == "upsample":
        return ops.upsample3d(ins[0], node.attrs["scale_factor"])
    if node.op == "tuple_get":
        return ins[0][node.attrs["idx"]]
    if node.op in ("dropout", "identity"):
        return ins[0]
    if node.op == "add":
        return ins[0] + ins[1]
    raise ValueError(f"unknown op {node.op}")


def _eval_group_norm(node: Node, params, x, kernels: Kernels):
    """A ``group_norm`` node (the plain version, on any device) or a
    ``group_norm_k6`` node of the serving rewrite (``kernels``'s K6): its
    ReLU (``relu``) and its consumer's act-quant (``quant_for``,
    ``quant_qlvl``: int8 codes out) fused in."""
    a = node.attrs
    p = params[node.name]
    _k6.elements += x.numel()
    if node.op == "group_norm":
        return group_norm_reference(x, p["scale"], p["bias"],
                                    a["num_groups"], a["eps"])
    quant_for = a.get("quant_for")
    return kernels.group_norm(
        x, p["scale"], p["bias"], a["num_groups"], a["eps"],
        bool(a.get("relu")),
        params[quant_for]["alpha_act"] if quant_for else None,
        a.get("quant_qlvl", 0) if quant_for else 0)


def node_seed(seed: int, index: int) -> int:
    """The seed of node ``index``'s dropout generator in the forward of
    step seed ``seed`` (the counterpart of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([int(seed), int(index)])
               .generate_state(1, np.uint64)[0])


def _eval_train_node(node: Node, i: int, params, st, ins, *, seed,
                     mode: str, compute_dtype):
    """One node of the training forward, plain or segmented: (output, batch
    norm state update or None).  ``i`` is the node's topological index,
    which seeds its dropout mask, so segment boundaries cannot change it."""
    if node.op == "conv" and compute_dtype is not None and mode == "fp":
        # mixed-precision training: the conv on compute_dtype operands,
        # emitting compute_dtype, the bias added in it.  QAT (mode 'fq')
        # stays float32: a half-width round of the grid arithmetic flips
        # 2-bit codes
        p = params[node.name]
        a = node.attrs
        y = ops.conv3d(ins[0].to(compute_dtype), p["kernel"].to(compute_dtype),
                       None, a["stride"], a["padding"], a["dilation"],
                       a["groups"])
        if "bias" in p:
            y = y + p["bias"].to(compute_dtype)
        return y, None
    if node.op == "bn":
        p = params[node.name]
        s = st[node.name]
        x = ins[0]
        if compute_dtype is not None:
            # batch statistics and the running-stat EMA in float32, the
            # normalized output re-emitted at compute_dtype
            x = x.float()
        out, m, v = ops.batch_norm_train(
            x, p["scale"], p["bias"], s["mean"], s["var"],
            node.attrs["momentum"], node.attrs["eps"])
        if compute_dtype is not None:
            out = out.to(compute_dtype)
        return out, {"mean": m.detach(), "var": v.detach()}
    if node.op == "dropout" and node.attrs["rate"] > 0:
        if seed is None:
            raise ValueError("dropout in train mode needs a seed")
        gen = torch.Generator().manual_seed(node_seed(seed, i))
        return ops.dropout3d(ins[0], node.attrs["rate"], gen), None
    return eval_node(node, params, st, ins, mode=mode,
                     compute_dtype=compute_dtype), None


def _segments(graph: Graph, remat: int):
    """The N-node segments of ``apply(remat=N)`` with their boundary sets,
    in the JAX version's (first-use) order: [(nodes, inputs, outputs)],
    each node as (topological index, node)."""
    indexed = [(i, n) for i, n in enumerate(graph.nodes) if n.op != "input"]
    segments = [indexed[k:k + remat] for k in range(0, len(indexed), remat)]
    seg_of = {graph.input_name: -1}
    for si, seg in enumerate(segments):
        for _, n in seg:
            seg_of[n.name] = si
    seg_in: List[List[str]] = [[] for _ in segments]
    seg_out: List[List[str]] = [[] for _ in segments]
    for si, seg in enumerate(segments):
        for _, n in seg:
            for src in n.inputs:
                if seg_of[src] < si and src not in seg_in[si]:
                    seg_in[si].append(src)
                    if seg_of[src] >= 0 and src not in seg_out[seg_of[src]]:
                        seg_out[seg_of[src]].append(src)
    for o in graph.outputs:
        if o not in seg_out[seg_of[o]]:
            seg_out[seg_of[o]].append(o)
    return list(zip(segments, seg_in, seg_out))


def _apply_remat(graph: Graph, variables, x, *, seed, mode: str,
                 compute_dtype, remat: int, tf32: bool):
    """The training forward in ``remat``-node segments, each under
    ``torch.utils.checkpoint``, which keeps only a segment's boundary
    values for the backward and recomputes its interior there, at the
    forward's precision whatever the backward's caller holds.  Returns
    (stacked heads, {bn node: new running stats})."""
    params = variables["params"]
    st = variables.get("state", {})
    new_state: Dict[str, Any] = {}
    env = {graph.input_name: x}
    segments = _segments(graph, remat)
    for si, (seg, in_names, out_names) in enumerate(segments):
        def seg_fn(*boundary, seg=seg, in_names=in_names,
                   out_names=out_names):
            vals = dict(zip(in_names, boundary))
            updates = {}
            with ops.conv_precision(tf32):
                for i, node in seg:
                    vals[node.name], ns = _eval_train_node(
                        node, i, params, st, [vals[n] for n in node.inputs],
                        seed=seed, mode=mode, compute_dtype=compute_dtype)
                    if ns is not None:
                        updates[node.name] = ns
            # the running stats leave as tensors, so the recomputation in
            # the backward gives them again without keeping them
            return (tuple(vals[n] for n in out_names),
                    {k: (u["mean"], u["var"]) for k, u in updates.items()})
        outs_seg, updates = checkpoint(
            seg_fn, *[env[n] for n in in_names], use_reentrant=False)
        env.update(zip(out_names, outs_seg))
        new_state.update({k: {"mean": m.detach(), "var": v.detach()}
                          for k, (m, v) in updates.items()})
        needed = set(graph.outputs)
        for _, later_in, _ in segments[si + 1:]:
            needed.update(later_in)
        for k in list(env):
            if k not in needed:
                del env[k]
    outs = [env[o] for o in graph.outputs]
    if compute_dtype is not None:
        outs = [o.float() for o in outs]
    return torch.stack(outs), new_state


def live_nodes(graph: Graph, outputs: Sequence[str]) -> set:
    """Names of the nodes that ``outputs`` reach, walking back from them."""
    live, stack = set(), list(outputs)
    while stack:
        name = stack.pop()
        if name not in live:
            live.add(name)
            stack.extend(graph.node(name).inputs)
    return live


def apply(graph: Graph, variables: Dict[str, Any], x, *,
          mode: str = "fp", heads: Optional[slice] = None,
          kernels: Optional[Kernels] = None,
          conv3x3_int8: Callable = None, stem_conv: Callable = None,
          int8_matmul: Callable = None, qact_matmul: Callable = None,
          upsample: Callable = None, group_norm: Callable = None,
          compute_dtype=None, keep_head_dtype: bool = False,
          capture: Optional[Sequence[str]] = None, train: bool = False,
          seed: Optional[int] = None, remat: int = 0, tf32: bool = False):
    """Interpret the graph on ``x`` (NDHWC; for an s2d-stem graph the
    (patches, parities) pair of ``kernels.stem.extract_s2d_patches``).

    mode: 'fp' (plain convs), 'quantized' (fake-quant activations and
    stored quantized weights) or 'fq' (fake-quant activations and weights
    quantized on the fly); int8-deployed nodes run on integer codes in
    both quantized modes.  ``kernels``: the ``kernels.Kernels`` record
    (see ``eval_node``; by default the wrappers); each of the six keywords
    named after its entries (``conv3x3_int8=``, ``upsample=`` ...)
    replaces that one entry.
    ``heads`` selects output heads (e.g. ``slice(-1, None)`` for the final
    head only); only the nodes those heads reach are evaluated.
    ``compute_dtype`` (e.g. ``torch.bfloat16``): low-precision serving (see
    the module docstring); the head outputs are cast back to float32
    unless ``keep_head_dtype`` (hard-prediction serving keeps them).

    Returns the selected head outputs stacked: (num_heads, N, D, H, W, C)
    (a channels-first head: (num_heads, N, C, D, H, W)).  With ``capture``
    (node names) returns (heads, {name: that node's output}): the PTQ
    sweep's regression targets.  Captured nodes are evaluated even where
    no selected head reaches them, and outlive their last consumer.

    ``train=True`` returns (heads, {bn node: {"mean", "var"}}), the
    running stats after this batch; ``seed`` seeds the dropout masks (see
    the module docstring).  It takes no kernel record.  ``remat=N`` (N > 0,
    train mode only) runs the graph in N-node segments under
    ``torch.utils.checkpoint`` (all heads), with the same values as
    ``remat=0``; it is ignored under ``capture``, as in the JAX package.
    ``tf32=True`` lets the float32 convs use TF32 (the FP train step's
    choice); by default they run in exact float32.  A caller that runs the
    backward holds the same precision around it (``ops.conv_precision``),
    since the backward's convs run there; a segment recomputed under
    ``remat`` sets its own.
    """
    assert mode in ("fp",) + QUANT_MODES
    if remat < 0:
        raise ValueError(f"remat must be >= 0 (nodes per checkpoint "
                         f"segment), got {remat}")
    if remat and not train:
        raise ValueError("remat applies to the training forward only "
                         "(train=True)")
    swaps = {k: v for k, v in dict(
        conv3x3_int8=conv3x3_int8, stem_conv=stem_conv,
        int8_matmul=int8_matmul, qact_matmul=qact_matmul, upsample=upsample,
        group_norm=group_norm).items() if v is not None}
    if train and (kernels is not None or swaps):
        raise ValueError("the training forward takes no kernel hooks")
    kernels = (kernels or WRAPPERS)._replace(**swaps)
    if remat and capture is None:
        with ops.conv_precision(tf32):
            return _apply_remat(graph, variables, x, seed=seed, mode=mode,
                                compute_dtype=compute_dtype,
                                remat=int(remat), tf32=tf32)
    outputs = graph.outputs if heads is None else graph.outputs[heads]
    params = variables["params"]
    st = variables.get("state", {})
    captured = {}
    new_state: Dict[str, Any] = {}
    live = live_nodes(graph, list(outputs) + list(capture or ()))
    uses = collections.Counter(i for n in graph.nodes if n.name in live
                               for i in n.inputs)
    uses.update(outputs)
    values = {graph.input_name: x}
    with ops.conv_precision(tf32):
        for i, node in enumerate(graph.nodes):
            if node.op == "input" or node.name not in live:
                continue
            ins = [values[n] for n in node.inputs]
            if train:
                values[node.name], ns = _eval_train_node(
                    node, i, params, st, ins, seed=seed, mode=mode,
                    compute_dtype=compute_dtype)
                if ns is not None:
                    new_state[node.name] = ns
            else:
                values[node.name] = eval_node(
                    node, params, st, ins, mode=mode, kernels=kernels,
                    compute_dtype=compute_dtype)
            if capture and node.name in capture:
                captured[node.name] = values[node.name]
            for n in node.inputs:
                uses[n] -= 1
                if uses[n] == 0:
                    del values[n]
    outs = [values[o] for o in outputs]
    if compute_dtype is not None and not keep_head_dtype:
        outs = [o.to(torch.float32) for o in outs]
    if capture is not None:
        return torch.stack(outs), captured
    if train:
        return torch.stack(outs), new_state
    return torch.stack(outs)


class GraphModule(nn.Module):
    """A graph and its variables.  Every tensor of ``variables`` is a
    buffer, so ``.to(device)`` moves the whole network; ``variables``
    rebuilds the flat dict view on each access."""

    def __init__(self, graph: Graph, variables: Dict[str, Any],
                 mode: str = "fp"):
        super().__init__()
        self.graph = graph
        self.mode = mode
        self._slots = []
        for group in ("params", "state"):
            for node, entries in variables.get(group, {}).items():
                for key, v in entries.items():
                    buf = f"v{len(self._slots)}"
                    self.register_buffer(buf, torch.as_tensor(v))
                    self._slots.append((group, node, key, buf))

    @property
    def variables(self) -> Dict[str, Any]:
        out: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {
            "params": {}, "state": {}}
        for group, node, key, buf in self._slots:
            out[group].setdefault(node, {})[key] = getattr(self, buf)
        return out

    def forward(self, x: torch.Tensor, heads: Optional[slice] = None,
                kernels: Optional[Kernels] = None) -> torch.Tensor:
        return apply(self.graph, self.variables, x, mode=self.mode,
                     heads=heads, kernels=kernels)
