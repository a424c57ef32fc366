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

Serving rewrites: ``channels_first_tail`` (the final head emitted NCDHW)
and ``s2d_stem_serving`` (the init conv as the fused space-to-depth stem,
K2), which the s2d path applies (``--serve_stem s2d``), and
``upsample_serving`` (every upsample on K5, the TransUp skip add fused in)
and ``group_norm_serving`` (every GroupNorm on K6, with its ReLU and its
consumer's act-quant fused in), which every serving path applies last,
together, as ``serving_graph``, after ``swin_serving`` (a SwinUNETR
graph's linears, 1^3 and transposed convs on K3 and its offset-grid 3^3
convs on K1; other graphs come back as they are).  ``serving_rewrites``
chooses them for every serving path (``eval/validate.py::_build_infer``,
``make_s2d_volume_inferencer``, ``export.py``).  Training, QAT and
calibration graphs keep ``ops.upsample3d`` and the plain GroupNorm.
"""
from __future__ import annotations

import dataclasses
from typing import Collection, Dict, Optional, Tuple

import numpy as np
import torch

from .. import nnir, ops
from ..eval.sliding import (CapturedForward, _patch_forward, chunk_fn,
                            make_volume_inferencer, patch_grid, serve_volume)
from ..kernels.epilogue import _quant_absorbs_relu, fuse_int8_epilogues
from ..kernels.qconv3d import pack_weights
from ..kernels.qmatmul import pack_weights_1x1, to_pallas_inference
from ..kernels.stem import (extract_s2d_patches, pack_stem_weights,
                            s2d_stem_weights, s2d_supported)
from ..nnir import Graph, Node


def eligible(qcfg) -> bool:
    return (qcfg is not None and qcfg.q_weight and qcfg.q_act
            and qcfg.qlvl_act <= 128 and qcfg.qlvl_w <= 128)


def act_k_of(p) -> int:
    """The offset-grid shift (``act_k``) of a conv's parameters as a Python
    int; 0 when the conv has none."""
    v = p.get("act_k")
    return 0 if v is None else int(v)


def to_int8_inference(graph: Graph, variables,
                      only_kernel_sizes: Optional[Collection] = None
                      ) -> Tuple[Graph, Dict]:
    """Returns (graph', variables') with eligible qconvs converted to int8
    codes + a scale epilogue, the int8 3^3 convs flagged for K1 and their
    epilogues fused.  Input variables must hold post-PTQ quantized kernels
    (values = alpha_w * grid); a calibrated offset grid (``act_k``) is
    baked into every conv's attributes, int8 or not.  The kernels' weight
    layouts
    (``kernel_packed``) are made here, once: K1's for the flagged 3^3
    convs, K3's for every int8 1x1x1 conv that
    ``to_pallas_inference(include_1x1=True)`` can flag.

    ``only_kernel_sizes``: kernel-size triples to deploy; qconvs of other
    sizes keep the float fake-quant path.  ``{(3, 3, 3)}`` is the mixed
    deployment (``--deploy mixed``): the 3^3 convs on int8, the 1x1
    transitions in float."""
    params = {k: dict(v) for k, v in variables["params"].items()}
    new_nodes = []
    for node in graph.nodes:
        attrs = dict(node.attrs)
        if node.op == "conv":
            # the offset-grid shift calibrated for this conv (run_ptq
            # act_offset), baked as a static int: the int8 path's signed
            # codes read it, and the kernel flagging, the epilogue fusion
            # and the s2d rewrite keep such a conv off the fused kernels,
            # whose act-quant assumes the unsigned grid
            ak = act_k_of(params.get(node.name, {}))
            if ak:
                attrs["act_k"] = ak
        if (node.op == "conv" and eligible(attrs.get("qcfg"))
                and (only_kernel_sizes is None
                     or tuple(attrs["kernel_size"]) in only_kernel_sizes)):
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
        if node.attrs.get("pallas") or (
                node.attrs.get("int8") and node.attrs.get("act_k")
                and nnir._pallas_3x3_int8_eligible(node.attrs)):
            # K1's layout, also of the offset-grid 3^3 convs that
            # swin_serving routes to K1
            p = params[node.name]
            p["kernel_packed"] = pack_weights(p["kernel_int8"])
        elif node.attrs.get("int8") and nnir._pallas_1x1_eligible(node.attrs):
            p = params[node.name]
            p["kernel_packed"] = pack_weights_1x1(p["kernel_int8"])
    return out, {"params": params, "state": variables.get("state", {})}


def channels_first_tail(graph: Graph) -> Graph:
    """Serving-only rewrite: keep only the FINAL head and emit it NCDHW.

    The classifier head has C = 3 channels; with channels minor, its
    upsample and the full-volume stitch walk 3-element rows.  The rewrite
    makes the 1x1 head conv emit (N, C, D, H, W) (``conv_cf``) and upsamples
    that (``upsample_cf``), so both run along W.  Numerics are unchanged
    (same contraction, same trilinear weights).  Consumers take the class
    axis at dim 1 of each head.  A tail of another shape is left as is.
    A tail already on K5 (``upsample_serving``) turns channels-first on
    K5, so the two rewrites apply in either order."""
    out = graph.outputs[-1]
    tail_up = None
    cur = graph.node(out)
    if cur.op in ("upsample", "upsample_k5"):
        tail_up = cur.name
        cur = graph.node(cur.inputs[0])
    a = cur.attrs
    if not (cur.op == "conv" and a["kernel_size"] == (1, 1, 1)
            and a["stride"] == (1, 1, 1) and a["padding"] == (0, 0, 0)
            and a["groups"] == 1 and not a.get("int8")):
        return graph
    new_nodes = []
    for n in graph.nodes:
        if n.name == cur.name:
            new_nodes.append(dataclasses.replace(n, op="conv_cf",
                                                 attrs=dict(n.attrs)))
        elif n.name == tail_up and n.op == "upsample_k5":
            new_nodes.append(dataclasses.replace(
                n, attrs=dict(n.attrs, channels_first=True)))
        elif n.name == tail_up:
            new_nodes.append(dataclasses.replace(n, op="upsample_cf",
                                                 attrs=dict(n.attrs)))
        else:
            new_nodes.append(n)
    # the aux-head nodes stay in the list, unreachable from the single
    # channels-first output, so nnir.apply never evaluates them
    return Graph(new_nodes, [out], graph.input_name)


def upsample_serving(graph: Graph) -> Graph:
    """Serving-only rewrite: every trilinear upsample runs on K5
    (``kernels/upsample.py``).

    Every ``upsample`` and ``upsample_cf`` becomes an ``upsample_k5`` node
    (``channels_first`` for the latter).  An ``upsample`` whose one
    consumer is an ``add`` takes the add's place, with the inputs (the
    upsample's input, the add's other input), and adds that skip in K5's
    epilogue.  An upsample with another consumer, or one a batch norm
    separates from its add (the ``fuse_bn`` graphs' ``TransUp.bn_x``), runs
    on K5 without the epilogue.  The values are those of the graph as it
    was: K5's plain version is the unfused pair, and the kernel rounds as
    it does.  A graph without upsamples comes back as it is, so the
    rewrite applies once, before or after ``channels_first_tail``."""
    if not any(n.op in ("upsample", "upsample_cf") for n in graph.nodes):
        return graph
    consumers = graph.consumers()
    fused = {}  # add name -> the upsample it takes
    for n in graph.nodes:
        users = consumers.get(n.name, [])
        if (n.op == "upsample" and len(users) == 1
                and users[0] != "__output__"
                and graph.node(users[0]).op == "add"):
            fused[users[0]] = n
    gone = {up.name for up in fused.values()}
    new_nodes = []
    for n in graph.nodes:
        if n.name in gone:
            continue
        if n.name in fused:
            up = fused[n.name]
            skip = next(i for i in n.inputs if i != up.name)
            new_nodes.append(Node(n.name, "upsample_k5",
                                  (up.inputs[0], skip),
                                  {"scale_factor": up.attrs["scale_factor"],
                                   "channels_first": False}))
        elif n.op in ("upsample", "upsample_cf"):
            new_nodes.append(dataclasses.replace(
                n, op="upsample_k5",
                attrs=dict(n.attrs, channels_first=n.op == "upsample_cf")))
        else:
            new_nodes.append(n)
    return Graph(new_nodes, list(graph.outputs), graph.input_name)


def group_norm_serving(graph: Graph) -> Graph:
    """Serving-only rewrite: every live GroupNorm runs on K6
    (``kernels/groupnorm.py``), as a ``group_norm_k6`` node.

    - GN -> [relu] -> int8 conv (one consumer at each hop, the conv
      reading it as its data input; ``fuse_int8_epilogues`` may have
      bypassed the relu already): K6 emits the conv's int8 activation
      codes (``quant_for``, ``quant_qlvl``; the quantizer's clip at 0 is
      the relu) and the conv takes them (``input_quantized``), on K1 or on
      the int8 path;
    - GN -> relu (its one consumer): K6 emits the ReLU'd float (``relu``),
      and the relu node becomes an identity;
    - a leaky relu in the relu's place goes as the relu does into a
      conv's codes (the quantizer's clip at 0 takes the leak), and stays
      a node of its own otherwise;
    - any other GN: K6 emits the float.

    The values are those of the graph as it was: K6's plain version is the
    plain GroupNorm, ReLU and act-quant.  A graph without GroupNorms
    (every UResQ graph) comes back as it is, so the rewrite applies once,
    in any order with ``upsample_serving``."""
    if not any(n.op == "group_norm" for n in graph.nodes):
        return graph
    live = nnir.live_nodes(graph, graph.outputs)
    # the live consumers only: an epilogue-bypassed relu stays in the list
    consumers = {k: [u for u in users if u == "__output__" or u in live]
                 for k, users in graph.consumers().items()}

    def only_user(name):
        users = consumers.get(name, [])
        if len(users) != 1 or users[0] == "__output__":
            return None
        return graph.node(users[0])

    attrs_of = {}
    for n in graph.nodes:
        if n.op != "group_norm" or n.name not in live:
            continue
        attrs = dict(n.attrs, relu=False)
        nxt = only_user(n.name)
        relu = (nxt if nxt is not None and nxt.op in ("relu", "leaky_relu")
                else None)
        conv = only_user(relu.name) if relu is not None else nxt
        src = relu.name if relu is not None else n.name
        # an int8 conv whose act-quant can take codes (and absorbs a relu,
        # or a leaky relu: the quantizer's clip at 0 takes the leak too)
        if (conv is not None and _quant_absorbs_relu(conv)
                and conv.inputs[0] == src and src not in conv.inputs[1:]):
            attrs.update(quant_for=conv.name,
                         quant_qlvl=conv.attrs["qcfg"].qlvl_act)
            attrs_of[conv.name] = dict(conv.attrs, input_quantized=True)
        elif relu is not None and relu.op == "relu":
            attrs["relu"] = True
        else:
            relu = None  # a leaky relu K6 cannot take stays a node
        attrs_of[n.name] = attrs
        if relu is not None:
            attrs_of[relu.name] = None  # an identity
    new_nodes = []
    for n in graph.nodes:
        if n.name not in attrs_of:
            new_nodes.append(n)
        elif attrs_of[n.name] is None:
            new_nodes.append(Node(n.name, "identity", n.inputs, {}))
        elif n.op == "group_norm":
            new_nodes.append(dataclasses.replace(n, op="group_norm_k6",
                                                 attrs=attrs_of[n.name]))
        else:
            new_nodes.append(dataclasses.replace(n, attrs=attrs_of[n.name]))
    return Graph(new_nodes, list(graph.outputs), graph.input_name)


def swin_serving(graph: Graph) -> Graph:
    """Serving-only rewrite of a SwinUNETR graph (one with window
    attentions, which run on K7 in every graph): every int8 1^3 conv of
    stride 1 (its linears, its 1^3 ``conv3`` and transposed convs)
    flagged for K3, and every int8 3^3 conv of stride 1, offset grid or
    not, for K1 (``pallas``); the kernels quantize their float inputs on
    the offset grid ``act_k`` where the conv has one.  The values are
    those of the int8 path: the kernels' plain versions are its steps.
    Any other graph comes back as it is (``to_pallas_inference`` keeps
    UResQ's and SegResNet's offset-grid convs off the kernels, as the JAX
    package does)."""
    if not any(n.op == "window_attention" for n in graph.nodes):
        return graph
    new_nodes = []
    for n in graph.nodes:
        a = n.attrs
        qcfg = a.get("qcfg")
        if (n.op == "conv" and a.get("int8") and qcfg is not None
                and qcfg.q_act and not a.get("pallas")
                and (nnir._pallas_1x1_eligible(a)
                     or nnir._pallas_3x3_int8_eligible(a))):
            n = dataclasses.replace(n, attrs=dict(a, pallas=True))
        new_nodes.append(n)
    return Graph(new_nodes, list(graph.outputs), graph.input_name)


def serving_graph(graph: Graph) -> Graph:
    """The serving rewrites that every serving path applies last:
    ``swin_serving`` (K3 and K1 for SwinUNETR), ``upsample_serving`` (K5)
    and ``group_norm_serving`` (K6)."""
    return group_norm_serving(upsample_serving(swin_serving(graph)))


def s2d_stem_serving(graph: Graph, variables):
    """Serving-only rewrite: run the init conv as the fused space-to-depth
    stem (kernels/stem.py, K2).

    Rewrites
        input -> conv0 (3^3 s2) -> [identity...] -> relu -> {int8 conv,
                                                             residual uses}
    into
        (s2d patches, parities) -> stem_s2d -> (relu'd activation, codes)
    with the relu node becoming a tuple-get of the activation (residual
    consumers are untouched) and the int8 consumer reading the codes
    (``input_quantized``).  The model input becomes the (patches,
    parities) pair of ``kernels.stem.extract_s2d_patches``; use it with
    ``sliding_window_inference(extract_fn=...)``.

    Returns (graph', variables', stem_node); stem_node is None, with the
    graph and variables returned unchanged, when the graph does not match.
    The s2d weights are bfloat16 (serving runs the stem at bfloat16
    operands with float32 accumulation), on the stem kernel's device.
    K2 takes any channel count, so the JAX package's TPU-only width guard
    does not apply."""
    skip = (graph, variables, None)
    stem = next((n for n in graph.nodes
                 if n.op == "conv" and n.inputs == (graph.input_name,)), None)
    if stem is None or stem.attrs.get("int8"):
        return skip
    a = stem.attrs
    if not (a["kernel_size"] == (3, 3, 3) and a["stride"] == (2, 2, 2)
            and a["padding"] == (1, 1, 1) and a["dilation"] == (1, 1, 1)
            and a["groups"] == 1):
        return skip
    # follow the identity chain to the stem's relu; after epilogue fusion
    # (kernels/epilogue.py::_elide_relus) the chain end fans out (the relu
    # is dead and its former consumers read the chain), so accept a
    # fan-out as long as exactly one relu hangs off it
    cur = stem.name
    relu = None
    for _ in range(4):
        users = [n for n in graph.nodes if cur in n.inputs]
        relus = [u for u in users if u.op == "relu"]
        if len(relus) == 1:
            relu = relus[0]
            break
        if len(users) != 1 or users[0].op != "identity":
            return skip
        cur = users[0].name
    if relu is None:
        return skip
    # the codes consumer: a K1 conv reading the (possibly elided) relu as
    # its data input; every other consumer edge must be a residual stream,
    # which takes the activation
    taps = {relu.name, cur}
    edges = [(n, i) for n in graph.nodes if n.name != relu.name
             for i, inp in enumerate(n.inputs) if inp in taps]
    codes_edges = [(n, i) for (n, i) in edges
                   if i == 0 and n.op == "conv" and n.attrs.get("int8")
                   and n.attrs.get("pallas")
                   # offset-grid consumers quantize with signed codes the
                   # stem's unsigned quant epilogue cannot emit
                   and not n.attrs.get("act_k")
                   and not n.attrs.get("input_quantized")]
    if len(codes_edges) != 1:
        return skip
    consumer = codes_edges[0][0]
    res_edges = [(n, i) for (n, i) in edges if n is not consumer]
    if any(i == 0 or not n.attrs.get("residual") for (n, i) in res_edges):
        return skip  # a non-residual consumer would need the float value

    params = {k: dict(v) for k, v in variables["params"].items()}
    sp = params[stem.name]
    kernel = sp["kernel"]
    w_even, w_odd = s2d_stem_weights(
        kernel.detach().cpu().numpy().astype(np.float32))
    bias = sp.get("bias")
    if bias is None:
        bias = torch.zeros(w_even.shape[-1], device=kernel.device)
    params[stem.name] = {
        "w_even": torch.from_numpy(w_even).to(kernel.device, torch.bfloat16),
        "w_odd": torch.from_numpy(w_odd).to(kernel.device, torch.bfloat16),
        "bias": bias.to(torch.float32),
        "alpha_next": params[consumer.name]["alpha_act"],
    }
    # K2's weight layout, made here once
    params[stem.name]["kernel_packed"] = pack_stem_weights(
        params[stem.name]["w_even"], params[stem.name]["w_odd"])
    codes_name = stem.name + ".s2d_codes"
    new_nodes = []
    for n in graph.nodes:
        if n.name == stem.name:
            attrs = dict(n.attrs)
            attrs["qlvl_next"] = consumer.attrs["qcfg"].qlvl_act
            new_nodes.append(dataclasses.replace(n, op="stem_s2d",
                                                 attrs=attrs))
        elif n.name == relu.name:
            new_nodes.append(dataclasses.replace(n, op="tuple_get",
                                                 attrs={"idx": 0}))
            new_nodes.append(
                type(n)(codes_name, "tuple_get", n.inputs, {"idx": 1}))
        elif n.name == consumer.name:
            attrs = dict(n.attrs)
            attrs["input_quantized"] = True
            ins = (codes_name,) + tuple(
                relu.name if inp in taps else inp for inp in n.inputs[1:])
            new_nodes.append(dataclasses.replace(n, inputs=ins, attrs=attrs))
        elif any(m is n for (m, _) in res_edges):
            # residual streams read the activation (the tuple-get that
            # replaced the relu); a residual_relu flag stays harmless
            ins = tuple(relu.name if inp in taps else inp for inp in n.inputs)
            new_nodes.append(dataclasses.replace(n, inputs=ins,
                                                 attrs=dict(n.attrs)))
        else:
            new_nodes.append(n)
    g2 = Graph(new_nodes, list(graph.outputs), graph.input_name)
    return g2, {"params": params,
                "state": variables.get("state", {})}, g2.node(stem.name)


def serving_rewrites(graph: Graph, variables, *, s2d: bool = False,
                     heads=None):
    """The graph a serving path runs: (graph', variables', channels_first,
    stem).  Every path gets ``serving_graph`` (K5, K6) last.  With ``s2d``
    (``--serve_stem s2d``) the final head first turns channels-first
    (``channels_first_tail``) where the path serves it alone
    (``heads=slice(-1, None)``, or a graph of one head), and the init conv
    becomes the s2d stem (``s2d_stem_serving``), whose node is ``stem``.
    Without an eligible stem, or without ``s2d``, the result is the direct
    path's: (``serving_graph(graph)``, ``variables``, False, None)."""
    if s2d:
        g, cf = graph, False
        if heads == slice(-1, None) or len(graph.outputs) == 1:
            g = channels_first_tail(graph)
            cf = g is not graph
        g, v, stem = s2d_stem_serving(g, variables)
        if stem is not None:
            return serving_graph(g), v, cf, stem
    return serving_graph(graph), variables, False, None


def s2d_extract_fn(vol_shape, patch_size, overlap, stem_attrs):
    """The s2d volume preparation, for the live s2d path and the s2d
    artifact: ``serve_volume``'s ``extract_fn`` that takes the volume
    (float32, on the card) to space-to-depth planes and the grid's s2d
    patches with their parities (``kernels.stem.extract_s2d_patches``), or
    None where the grid of ``vol_shape`` has odd H/W starts or extents, or
    the stem (``stem_attrs``) another geometry, which K2 cannot serve."""
    patch_size = ops.triple(patch_size)
    starts = patch_grid(vol_shape, patch_size, overlap)
    if not s2d_supported(starts, patch_size, tuple(vol_shape), stem_attrs):
        return None
    return extract_s2d_patches


def make_s2d_volume_inferencer(graph: Graph, variables, *,
                               patch_batch="auto", hard_pred: bool = True,
                               multilabel: bool = False,
                               compute_dtype=torch.bfloat16, heads=None,
                               device="cuda", kernels=None, capture=None):
    """s2d serving (``--serve_stem s2d``): the init conv runs as the fused
    space-to-depth stem K2, the interior int8 convs on K1 at
    ``compute_dtype`` (``serving_rewrites(s2d=True)``).

    ``graph`` / ``variables``: the int8 deployment (``to_int8_inference``),
    without the channels-first tail, which the rewrites apply.  The
    weights go to ``device`` once.

    Returns ``infer(variables_ignored, image, patch_size, overlap)`` that
    takes a host (N, D, H, W, C) volume (NumPy or a CPU tensor) and
    returns what ``eval.sliding.make_volume_inferencer`` returns, or None
    when the graph has no eligible stem.  The volume goes to the card as
    float32 and is transformed to s2d space there (``s2d_extract_fn``;
    see ``PERF.md`` for the placement's times).  A volume whose grid the
    s2d path cannot serve (odd H/W starts or extents) is served by the
    direct inferencer at the same compute dtype.  ``capture``: as
    ``make_volume_inferencer``'s (``infer.captured``).
    ``patch_batch="auto"`` runs the whole grid as one batch; a device
    out-of-memory halves it and retries, and later volumes keep the
    smaller batch.  ``kernels``: the ``kernels.Kernels`` record (by
    default the wrappers).  The graph may be the mixed deployment
    (``only_kernel_sizes={(3, 3, 3)}``) and carry the 1x1 flags of
    ``to_pallas_inference(include_1x1=True)``."""
    g2, v2, cf, stem = serving_rewrites(graph, variables, s2d=True,
                                        heads=heads)
    if stem is None:
        return None
    dev = torch.device(device)
    v2 = nnir.to_device(v2, dev)
    v_direct = nnir.to_device(variables, dev)
    auto = patch_batch in ("auto", 0, None)
    fallback = make_volume_inferencer(
        serving_rewrites(graph, variables)[0],
        patch_batch=8 if auto else int(patch_batch),
        mode="quantized", heads=heads, hard_pred=hard_pred,
        multilabel=multilabel, compute_dtype=compute_dtype, kernels=kernels,
        capture=capture)
    forward = _patch_forward(g2, "quantized", None if cf else heads,
                             hard_pred, compute_dtype, kernels)
    captured = CapturedForward(forward) if capture is not False else None
    pb_cap = [None]

    def infer(variables_ignored, image, patch_size, overlap):
        del variables_ignored  # the weights are in the rewritten graph
        image = torch.as_tensor(image)
        extract = s2d_extract_fn(tuple(image.shape[1:4]), patch_size,
                                 overlap, stem.attrs)
        if extract is None:
            return fallback(v_direct, image.to(dev), patch_size, overlap)
        pb = (len(patch_grid(image.shape[1:4], patch_size, overlap))
              * image.shape[0] if auto else int(patch_batch))
        if pb_cap[0] is not None:
            pb = min(pb, pb_cap[0])
        image = image.to(dev, torch.float32)
        model_fn = chunk_fn(forward, captured, capture, v2, dev)
        while True:
            try:
                with torch.inference_mode():
                    return serve_volume(model_fn, image, patch_size, overlap,
                                        pb, hard_pred=hard_pred,
                                        multilabel=multilabel,
                                        channels_first=cf, extract_fn=extract)
            except torch.cuda.OutOfMemoryError:
                if pb <= 1:
                    raise
                if captured is not None:
                    captured.graph = None  # free the larger graph
                pb = max(1, pb // 2)
                pb_cap[0] = pb
                print(f"serve_stem=s2d: device out of memory, retrying "
                      f"at patch_batch={pb}")

    infer.captured = captured
    return infer
