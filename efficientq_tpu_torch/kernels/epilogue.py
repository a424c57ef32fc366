"""Epilogue fusion for the int8 deployment graph (pure graph rewrites).

Counterpart of the JAX package's ``pallas/epilogue.py``, carried over rule
for rule and with the same attribute names, so the two fused graphs can be
compared node for node.  After ``ptq.deploy.to_int8_inference`` and
``kernels.qmatmul.to_pallas_inference``, the elementwise neighbourhood of
each flagged int8 3^3 conv moves into the K1 kernel (kernels/qconv3d.py):

1. conv -> [identity/dropout]* -> relu -> [identity/dropout]* -> int8 conv
   (every hop single-consumer): the producer emits the consumer's int8
   activation codes (``epilogue_quant_for``, ``epilogue_qlvl``), the relu
   folds into the quantizer's clip at 0, and the consumer skips its own
   act-quant (``input_quantized``).
2. conv -> [identity/dropout]* -> add(other): the residual operand is added
   inside the kernel (``residual``); the add becomes an identity.
3. ``_fuse_pools``: conv -> identity -> maxpool(2) becomes a second, pooled
   output of the kernel (``epilogue_pool``), read through ``tuple_get``.
4. ``_elide_relus``: a relu whose every consumer re-applies it (an int8
   conv's act-quant, or a fused residual with ``residual_relu``) is bypassed
   and left dead; ``nnir.apply`` never evaluates it.

The fused graph is for deployment (mode='quantized') only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..nnir import Graph, Node

_TRANSPARENT = ("identity", "dropout")


def _follow_transparent(nodes, cons, name):
    """Walk forward through single-consumer identity/dropout nodes; returns
    (last transparent node name, the single consumer after it) or
    (name, None) if the chain fans out / ends."""
    cur = name
    while True:
        cs = cons.get(cur, [])
        if len(cs) != 1 or cs[0] == "__output__":
            return cur, None
        nxt = nodes[cs[0]]
        if nxt.op in _TRANSPARENT:
            cur = nxt.name
            continue
        return cur, nxt


def _is_pallas_int8_3x3(node: Node) -> bool:
    return (node.op == "conv" and node.attrs.get("pallas")
            and node.attrs.get("int8")
            and node.attrs.get("kernel_size") == (3, 3, 3))


def fuse_int8_epilogues(graph: Graph) -> Graph:
    """Returns a new graph with relu+act-quant, residual-add and maxpool
    epilogues folded into the flagged int8 3^3 convs."""
    nodes = {n.name: dataclasses.replace(n, inputs=tuple(n.inputs),
                                         attrs=dict(n.attrs))
             for n in graph.nodes}
    cons = graph.consumers()

    for n in graph.nodes:
        node = nodes[n.name]
        if not _is_pallas_int8_3x3(node):
            continue

        last, nxt = _follow_transparent(nodes, cons, node.name)
        if nxt is None:
            continue

        if nxt.op == "relu":
            relu = nxt
            _, after = _follow_transparent(nodes, cons, relu.name)
            if (after is not None and after.op == "conv"
                    and after.attrs.get("int8")
                    and not after.attrs.get("input_quantized")
                    and not after.attrs.get("act_k")
                    and after.attrs.get("qcfg") is not None
                    and after.attrs["qcfg"].q_act
                    # flagged 1x1 convs have no code-input variant
                    and (not after.attrs.get("pallas")
                         or after.attrs.get("kernel_size") == (3, 3, 3))):
                node.attrs["epilogue_quant_for"] = after.name
                node.attrs["epilogue_qlvl"] = after.attrs["qcfg"].qlvl_act
                nodes[after.name].attrs["input_quantized"] = True
                nodes[relu.name] = dataclasses.replace(
                    nodes[relu.name], op="identity")
            continue

        if nxt.op == "add" and len(nxt.inputs) == 2 and last in nxt.inputs:
            other = [i for i in nxt.inputs if i != last]
            if len(other) != 1:  # add(x, x) — not a residual pattern
                continue
            order = {m.name: i for i, m in enumerate(graph.nodes)}
            if order.get(other[0], 1 << 30) > order[node.name]:
                continue  # operand not available before the conv
            node.attrs["residual"] = True
            new_inputs = (*node.inputs, other[0])
            nodes[node.name] = dataclasses.replace(node, inputs=new_inputs)
            nodes[nxt.name] = dataclasses.replace(
                nodes[nxt.name], op="identity", inputs=(last,))

    _fuse_pools(graph, nodes)
    _elide_relus(graph, nodes)
    return Graph([nodes[n.name] for n in graph.nodes], list(graph.outputs),
                 graph.input_name)


def _fuse_pools(graph: Graph, nodes: Dict[str, Node]) -> None:
    """conv(+residual) -> identity -> maxpool(2) becomes a dual-output
    kernel: the first transparent hop becomes tuple_get(0) (skip and
    decoder consumers see y unchanged), the maxpool tuple_get(1)."""
    cons = graph.consumers(nodes)
    for n in graph.nodes:
        node = nodes[n.name]
        if (not _is_pallas_int8_3x3(node)
                or node.attrs.get("epilogue_quant_for")):
            continue
        # walk the single-consumer transparent chain after the conv (the
        # folded-BN identity, then the fused residual add's identity); the
        # pool hangs off wherever the chain fans out
        cur, first_t = node.name, None
        while True:
            if cur in graph.outputs:
                first_t = None
                break
            cs = [c for c in cons.get(cur, []) if c != "__output__"]
            if len(cs) == 1 and nodes[cs[0]].op in _TRANSPARENT:
                if first_t is None:
                    first_t = cs[0]
                cur = cs[0]
                continue
            break
        if first_t is None:
            continue  # need a transparent hop to host tuple_get(0)
        pools = [u for u in cons.get(cur, [])
                 if u != "__output__" and nodes[u].op == "maxpool"
                 and nodes[u].attrs.get("kernel") == (2, 2, 2)
                 and nodes[u].attrs.get("stride") == (2, 2, 2)]
        if len(pools) != 1:
            continue
        node.attrs["epilogue_pool"] = True
        nodes[first_t] = dataclasses.replace(nodes[first_t], op="tuple_get",
                                             attrs={"idx": 0})
        nodes[pools[0]] = dataclasses.replace(
            nodes[pools[0]], op="tuple_get", inputs=(node.name,),
            attrs={"idx": 1})


def _quant_absorbs_relu(node: Node) -> bool:
    """The act-quant prologue round(clip(x/alpha, 0, 1)*(n-1)) clips at 0,
    which IS a relu, so a relu feeding only the quantizer is redundant."""
    return (node.op == "conv" and node.attrs.get("int8")
            and not node.attrs.get("input_quantized")
            and not node.attrs.get("act_k")
            and node.attrs.get("qcfg") is not None
            and node.attrs["qcfg"].q_act
            and (not node.attrs.get("pallas")
                 or node.attrs.get("kernel_size") == (3, 3, 3)))


def _elide_relus(graph: Graph, nodes: Dict[str, Node]) -> None:
    """Bypass relu nodes whose every consumer re-applies the relu: the
    ResBlock entry relu feeds block1.conv's act-quant and block2.conv's
    residual operand, which the kernel relus itself (``residual_relu``).
    The relu node stays in the list, unreachable."""
    # consumers of the REWRITTEN nodes (the residual operand was appended
    # to the conv's inputs above)
    cons = graph.consumers(nodes)
    for n in graph.nodes:
        if n.op != "relu" or n.name in graph.outputs:
            continue
        users = cons.get(n.name, [])
        if not users or "__output__" in users:
            continue
        rewires = []  # (consumer name, input index, flag)
        ok = True
        for uname in users:
            u = nodes[uname]
            idxs = [i for i, inp in enumerate(u.inputs) if inp == n.name]
            for i in idxs:
                if i == 0 and _quant_absorbs_relu(u):
                    rewires.append((uname, i, None))
                elif (i >= 1 and u.attrs.get("residual")
                        and u.attrs.get("pallas")):
                    rewires.append((uname, i, "residual_relu"))
                else:
                    ok = False
        if not ok or not rewires:
            continue
        src = nodes[n.name].inputs[0]
        for uname, i, flag in rewires:
            u = nodes[uname]
            ins = list(u.inputs)
            ins[i] = src
            attrs = u.attrs
            if flag:
                attrs[flag] = True
            nodes[uname] = dataclasses.replace(u, inputs=tuple(ins),
                                               attrs=attrs)
