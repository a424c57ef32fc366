"""BatchNorm folding as a pure graph + variables transform.

Counterpart of the JAX package's ``ptq/fold_bn.py``: every ``bn`` node
whose input is a ``conv`` with fan-out 1 is folded into that conv (which
gains a bias if it had none) and replaced by an ``identity`` node.  BNs that
do not directly follow a conv are left alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..nnir import Graph, Node


def fold_bn(graph: Graph, variables) -> Tuple[Graph, Dict]:
    """Returns (folded_graph, folded_variables); inputs untouched.

        std   = sqrt(running_var + eps)
        w'    = w * gamma / std          (per out-channel)
        beta  = bn_bias - gamma * mean / std
        b'    = gamma * b / std + beta   (beta if conv had no bias)
    """
    params = {k: dict(v) for k, v in variables["params"].items()}
    state = {k: dict(v) for k, v in variables.get("state", {}).items()}

    fanout: Dict[str, int] = {}
    for node in graph.nodes:
        for inp in node.inputs:
            fanout[inp] = fanout.get(inp, 0) + 1
    for out in graph.outputs:
        fanout[out] = fanout.get(out, 0) + 1

    index = {n.name: n for n in graph.nodes}
    new_nodes = []
    for node in graph.nodes:
        if node.op == "bn":
            prev = index[node.inputs[0]]
            if prev.op == "conv" and fanout.get(prev.name, 0) == 1:
                gamma = params[node.name]["scale"]
                mean = state[node.name]["mean"]
                std = torch.sqrt(state[node.name]["var"] + node.attrs["eps"])
                cp = params[prev.name]
                cp["kernel"] = cp["kernel"] * (gamma / std)  # DHWIO: O last
                beta = params[node.name]["bias"] - gamma * mean / std
                if "bias" in cp:
                    cp["bias"] = gamma * cp["bias"] / std + beta
                else:
                    cp["bias"] = beta
                del params[node.name]
                del state[node.name]
                # the conv (already emitted) now carries a bias
                for i, n in enumerate(new_nodes):
                    if n.name == prev.name:
                        new_nodes[i] = dataclasses.replace(
                            n, attrs={**n.attrs, "bias": True})
                        break
                new_nodes.append(Node(node.name, "identity", node.inputs, {}))
                continue
        new_nodes.append(dataclasses.replace(node, attrs=dict(node.attrs)))

    return Graph(new_nodes, list(graph.outputs), graph.input_name), {
        "params": params, "state": state}
