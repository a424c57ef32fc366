"""The graph pass that flags convs for the fused kernels.

Counterpart of the JAX package's ``pallas/qmatmul.py::to_pallas_inference``.
Only the graph pass is ported: it flags (attribute ``pallas``, kept for a
node-for-node comparison with the JAX graph) the int8 3^3 convs that the
K1 kernel (kernels/qconv3d.py) runs.  The fused 1x1 matmul kernels (K3
``fused_int8_matmul`` and K4 ``fused_qact_matmul``) are reached in the JAX
package only with ``include_1x1=True``, which deployment does not use;
they are still to be ported, so this pass has no such option.
"""
from __future__ import annotations

import dataclasses

from ..nnir import Graph, _pallas_3x3_int8_eligible


def to_pallas_inference(graph: Graph) -> Graph:
    """Flag every int8 3^3 qconv of stride 1 and 'same' padding (after
    ``ptq.deploy.to_int8_inference`` set ``int8``) for the K1 kernel."""
    new_nodes = []
    for node in graph.nodes:
        qcfg = node.attrs.get("qcfg")
        if (node.op == "conv" and qcfg is not None and qcfg.q_act
                and not node.attrs.get("act_k")
                and node.attrs.get("int8")
                and _pallas_3x3_int8_eligible(node.attrs)):
            attrs = dict(node.attrs)
            attrs["pallas"] = True
            new_nodes.append(dataclasses.replace(node, attrs=attrs))
        else:
            new_nodes.append(node)
    return Graph(new_nodes, list(graph.outputs), graph.input_name)
