"""Int8 deployment transform: true integer-arithmetic quantized inference.

Counterpart of the JAX package's ``ptq/deploy.py`` (``eligible`` and
``to_int8_inference``).  The fake-quant forward computes

    y = conv(alpha_a * qa/(na-1), alpha_w * s/(nw-1)) + b

with qa in [0, na-1] and s an odd integer in [-(nw-1), nw-1], so the conv
runs on int8 codes with exact integer accumulation and one float32
epilogue:

    y = conv_int8(qa, s) * (alpha_a * alpha_w / ((na-1)(nw-1))) + b

The JAX package builds the fused-kernel graph only on a TPU; the port
builds it on every device, so the CPU tests run the same graph the card
runs (on the CPU the K1 wrapper takes its plain version).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..kernels.epilogue import fuse_int8_epilogues
from ..kernels.qconv3d import pack_weights
from ..kernels.qmatmul import to_pallas_inference
from ..nnir import Graph


def eligible(qcfg) -> bool:
    return (qcfg is not None and qcfg.q_weight and qcfg.q_act
            and qcfg.qlvl_act <= 128 and qcfg.qlvl_w <= 128)


def to_int8_inference(graph: Graph, variables) -> Tuple[Graph, Dict]:
    """Returns (graph', variables') with eligible qconvs converted to int8
    codes + a scale epilogue, the int8 3^3 convs flagged for K1 and their
    epilogues fused.  Input variables must hold post-PTQ quantized kernels
    (values = alpha_w * grid).  K1's weight layout (``kernel_packed``) is
    made here, once."""
    params = {k: dict(v) for k, v in variables["params"].items()}
    new_nodes = []
    for node in graph.nodes:
        attrs = dict(node.attrs)
        if node.op == "conv" and eligible(attrs.get("qcfg")):
            qcfg = attrs["qcfg"]
            p = params[node.name]
            alpha_w = torch.as_tensor(p["alpha_w"], dtype=torch.float32)
            alpha_a = torch.as_tensor(p["alpha_act"], dtype=torch.float32)
            # w / alpha_w * (nw-1) = 2b - (nw-1): odd integers
            p["kernel_int8"] = torch.round(
                p.pop("kernel") / alpha_w * (qcfg.qlvl_w - 1)).to(torch.int8)
            p["scale"] = alpha_a * alpha_w / ((qcfg.qlvl_act - 1)
                                              * (qcfg.qlvl_w - 1))
            attrs["int8"] = True
        new_nodes.append(dataclasses.replace(node, attrs=attrs))
    out = fuse_int8_epilogues(to_pallas_inference(
        Graph(new_nodes, list(graph.outputs), graph.input_name)))
    for node in out.nodes:
        if node.attrs.get("pallas"):
            p = params[node.name]
            p["kernel_packed"] = pack_weights(p["kernel_int8"])
    return out, {"params": params, "state": variables.get("state", {})}
