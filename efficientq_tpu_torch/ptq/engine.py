"""PTQ engine: the layer-wise calibration sweep (PyTorch).

Counterpart of the JAX package's ``ptq/engine.py``:

1. fold BN (a pure graph transform)
2. one captured FP forward collects every qconv's FP output (the
   per-layer regression target)
3. attention weight map + mask pyramid from the FP prediction
4. an eager sweep over the node list: at each qconv the *current* input
   (which carries the quantization error of the layers before it) is
   fake-quantized, the layer is calibrated by ADMM (admm.py), and its
   quantized output feeds the next node

Its options: block granularity (each ResBlock's exit conv calibrated
against the block's FP output, ``block_calibration_targets``), offset
activation grids searched per layer (``act_offset``), per-layer grid
overrides, and the two-pass mixed precision of ``run_ptq_mixed``.

The whole sweep runs inside ``ops.exact_f32()``: cuBLAS and cuDNN would
otherwise round float32 products to TF32.  An out-of-memory error on the
card is raised, not retried elsewhere.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import torch

from .. import nnir, ops
from ..nnir import Graph
from ..quant import project_by_iter
from .admm import PTQHyperParams, calibrate_layer
from .attention import attention_weight_map, mask_pyramid, match_pyramid_level
from .fold_bn import fold_bn


@dataclasses.dataclass
class PTQReport:
    layer_losses: List[Tuple[str, float]]
    class_voxel_nums: List[int]
    fp_forward_seconds: float
    calibration_seconds: float
    output_fp: torch.Tensor
    output_q: torch.Tensor
    # per-layer ADMM trajectories {layer: {loss, primal_residual,
    # dual_residual, rho: (admm_iter,)}}
    layer_histories: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict)
    # scale-free per-layer sensitivities (reported loss / target energy)
    layer_rel_losses: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    # per-layer seconds {layer: {"gram", "admm", "rest"}} on the device's
    # clock (CUDA events on a card)
    layer_seconds: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    # layers recalibrated at the lifted grid by run_ptq_mixed
    mixed_upgraded: List[str] = dataclasses.field(default_factory=list)

    def layer_loss_lines(self) -> List[str]:
        """layer_loss.txt formatting."""
        return [f"{name:45s}:{loss}" for name, loss in self.layer_losses]

    def time_cost_line(self) -> str:
        total = self.fp_forward_seconds + self.calibration_seconds
        return f"{total / 60:.3f} min."


_VALUE_PRESERVING = ("identity", "dropout")  # dropout is identity in eval


def block_calibration_targets(graph: Graph) -> Dict[str, Tuple[str, str]]:
    """Block-granularity calibration map: {conv_name: (add_name,
    residual_name)} for every weight-quantized conv whose output reaches a
    two-operand residual add through value-preserving glue, with the
    residual operand produced before the conv.

    The add is linear, so minimizing the block output error
    ``|| add_fp - (conv(x_q) + residual_q) ||^2`` over the conv's weights
    is the layer-wise problem with the target shifted to
    ``add_fp - residual_q``: the exit conv of each ResBlock absorbs the
    quantization error of everything inside the block.  Each hop conv ->
    add must have one consumer and preserve values ('post' blocks, with a
    relu between conv and add, stay layer-wise)."""
    cons = graph.consumers()
    nodes = {n.name: n for n in graph.nodes}
    order = {n.name: i for i, n in enumerate(graph.nodes)}

    out: Dict[str, Tuple[str, str]] = {}
    for node in graph.qconv_nodes():
        if not node.attrs["qcfg"].q_weight:
            continue
        cur = node.name
        for _ in range(4):
            cs = cons.get(cur, [])
            if len(cs) != 1 or cs[0] == "__output__":
                break
            nxt = nodes[cs[0]]
            if nxt.op in _VALUE_PRESERVING:
                cur = nxt.name
                continue
            if nxt.op == "add" and len(nxt.inputs) == 2 and cur in nxt.inputs:
                other = [i for i in nxt.inputs if i != cur]
                if len(other) == 1 and order.get(other[0], 1 << 30) \
                        < order[node.name]:
                    out[node.name] = (nxt.name, other[0])
            break
    return out


def tail_sensitive_convs(graph: Graph, k: int = 2) -> List[str]:
    """The last ``k`` weight-quantized convs in graph order that do not
    reach a graph output without crossing another weight-quantized conv
    (so never the classifier heads, which ``q_last`` keeps at its own
    grid): the final ResBlock's convs on both presets, the set the JAX
    package's W2A2 basin probe found every collapse to start from."""
    cons = graph.consumers()
    nodes = {n.name: n for n in graph.nodes}

    def reaches_output_sans_qconv(name):
        seen, stack = set(), [name]
        while stack:
            for c in cons.get(stack.pop(), []):
                if c == "__output__":
                    return True
                nd = nodes[c]
                if (nd.op == "conv" and nd.attrs.get("qcfg") is not None
                        and nd.attrs["qcfg"].q_weight):
                    continue
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return False

    body = [n.name for n in graph.qconv_nodes()
            if n.attrs["qcfg"].q_weight
            and not reaches_output_sans_qconv(n.name)]
    return body[-k:]


def apply_qlvl_overrides(graph: Graph,
                         qlvl_overrides: Dict[str, Tuple[int, int]]) -> Graph:
    """Pure rewrite: per-layer (qlvl_w, qlvl_act) grid overrides.  The
    returned graph carries the overridden qcfgs, so deployment packs and
    fuses each layer at its own grid."""
    unknown = set(qlvl_overrides) - {n.name for n in graph.nodes}
    if unknown:
        raise ValueError(f"qlvl_overrides for unknown nodes: {unknown}")
    new_nodes = []
    for n in graph.nodes:
        if n.name in qlvl_overrides and n.attrs.get("qcfg") is not None:
            attrs = dict(n.attrs)
            qw, qa = qlvl_overrides[n.name]
            attrs["qcfg"] = dataclasses.replace(
                attrs["qcfg"], qlvl_w=int(qw), qlvl_act=int(qa))
            n = dataclasses.replace(n, attrs=attrs)
        new_nodes.append(n)
    return dataclasses.replace(graph, nodes=new_nodes, _index=None)


def _layer_kw(node, qcfg, p, hp, act_search: int = 0):
    """The calibrate_layer keywords of one qconv."""
    return dict(ksize=node.attrs["kernel_size"], stride=node.attrs["stride"],
                padding=node.attrs["padding"],
                dilation=node.attrs["dilation"], qlvl_w=qcfg.qlvl_w,
                has_bias="bias" in p, hp=hp,
                qlvl_act=qcfg.qlvl_act if qcfg.q_act else None,
                act_search=act_search)


def _wait(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_ptq(graph: Graph, variables, calib_x, *, task: str, init_stride,
            hp: PTQHyperParams = PTQHyperParams(), att_style: str = "p:0.5",
            num_mask_lvls: int = 5, fold: bool = True, verbose: bool = False,
            mesh=None, granularity: str = "layer",
            qlvl_overrides: Dict[str, Tuple[int, int]] = None,
            block_target: str = "quantized", act_offset: int = 0,
            act_offset_convs=None, device="cuda"):
    """Calibrate every qconv of ``graph`` on one NDHWC calibration batch.

    ``variables`` and ``calib_x`` are moved to ``device`` (the card unless
    told ``"cpu"``).  Returns (folded_graph, quantized_variables,
    PTQReport).  After this, ``nnir.apply(folded_graph, qvars, x,
    mode='quantized')`` runs quantized inference (the stored kernels hold
    quantized values; activations are fake-quantized by alpha_act).

    ``granularity='block'`` calibrates each ResBlock's exit conv against
    the block's FP output (``block_calibration_targets``): its target
    becomes ``add_fp - residual``, the residual being the quantized stream
    (``block_target='quantized'``) or its captured FP value (``'fp'``).
    Ineligible convs stay layer-wise.

    ``act_offset=K`` searches the offset activation grids k = 0..K per
    layer (``quant.fake_quant_act_k``), picked by input reconstruction
    error; the chosen k is stored as ``params[...]['act_k']`` and flows
    through the quantized forward, int8 deployment and the exports.
    ``act_offset_convs`` limits the search to the named convs (None: every
    activation-quantized conv).

    Not ported: ``mesh`` (ROADMAP queue 1 item 9).
    """
    if mesh is not None:
        raise NotImplementedError("mesh-sharded calibration is ROADMAP "
                                  "queue 1 item 9")
    if granularity not in ("layer", "block"):
        raise ValueError(f"granularity must be 'layer' or 'block', "
                         f"got {granularity!r}")
    if block_target not in ("quantized", "fp"):
        raise ValueError(f"block_target must be 'quantized' or 'fp', "
                         f"got {block_target!r}")

    def act_search_for(name: str) -> int:
        if act_offset_convs is not None and name not in act_offset_convs:
            return 0
        return int(act_offset)

    device = torch.device(device)
    variables = nnir.to_device(variables, device)
    calib_x = torch.as_tensor(calib_x).to(device)
    if fold:
        graph, variables = fold_bn(graph, variables)
    if qlvl_overrides:
        graph = apply_qlvl_overrides(graph, qlvl_overrides)
    params = {k: dict(v) for k, v in variables["params"].items()}
    state = variables.get("state", {})
    block_targets = (block_calibration_targets(graph)
                     if granularity == "block" else {})
    with ops.exact_f32():
        return _sweep(graph, params, state, calib_x, task, init_stride, hp,
                      att_style, num_mask_lvls, verbose, block_targets,
                      block_target, act_search_for)


def _sweep(graph, params, state, calib_x, task, init_stride, hp, att_style,
           num_mask_lvls, verbose, block_targets, block_target,
           act_search_for):
    capture = [n.name for n in graph.qconv_nodes()]
    capture += sorted({a for a, _ in block_targets.values()
                       if a not in capture})
    if block_target == "fp":
        capture += sorted({r for _, r in block_targets.values()
                           if r not in capture})
    t0 = time.time()
    out_fp, captured = nnir.apply(
        graph, {"params": params, "state": state}, calib_x, mode="fp",
        capture=capture)
    _wait(out_fp)
    t1 = time.time()

    # body mask: BraTS = nonzero voxels of modality 0; LiTS = everything.
    # The class stats use an all-ones mask, the pyramid the body mask.
    if task == "brats":
        body_mask = calib_x[..., 0] != 0.0
    else:
        body_mask = torch.ones(calib_x.shape[:-1], dtype=torch.bool,
                               device=calib_x.device)
    weight_map, nums = attention_weight_map(
        out_fp[-1], torch.ones_like(body_mask), att_style, task)
    pyramid = mask_pyramid(out_fp, body_mask, weight_map, init_stride,
                           num_mask_lvls, task)

    layer_losses: List[Tuple[str, float]] = []
    layer_rel_losses: List[Tuple[str, float]] = []
    layer_histories: Dict[str, Dict[str, torch.Tensor]] = {}
    layer_seconds: Dict[str, Dict[str, float]] = {}
    values = {graph.input_name: calib_x}

    # last position at which each value is consumed (inf for head outputs)
    last_use = {name: float("inf") for name in graph.outputs}
    for pos, n in enumerate(graph.nodes):
        for src in n.inputs:
            last_use[src] = max(last_use.get(src, -1), pos)

    for pos, node in enumerate(graph.nodes):
        if node.op == "input":
            continue
        ins = [values[n] for n in node.inputs]
        qcfg = node.attrs.get("qcfg") if node.op == "conv" else None
        if qcfg is None:
            out = nnir.eval_node(node, params, state, ins, mode="fp")
        elif qcfg.q_weight:
            p = params[node.name]
            t_layer = time.time()
            if verbose:
                print(f"Calibrating {node.name}")
            y_fp = captured[node.name]
            if node.name in block_targets:
                # block granularity: the FP block output minus the
                # residual stream (the add is linear), so this conv absorbs
                # the block's error; its reported loss is the block
                # output's.  The residual feeds the add, after this conv,
                # so its value is still live.
                add_name, res_name = block_targets[node.name]
                res_val = (captured[res_name] if block_target == "fp"
                           else values[res_name])
                y_fp = captured[add_name] - res_val
            search = act_search_for(node.name)
            res = calibrate_layer(
                ins[0], y_fp, p["kernel"], p.get("bias"),
                match_pyramid_level(pyramid, y_fp.shape),
                **_layer_kw(node, qcfg, p, hp, act_search=search))
            p["kernel"] = res["kernel"]
            if res["bias"] is not None:
                p["bias"] = res["bias"]
            p["alpha_w"] = res["alpha_w"]
            if res["alpha_act"] is not None:
                p["alpha_act"] = res["alpha_act"]
            if search:
                # the chosen shift (0 = the unsigned grid, and always 0
                # without q_act), read by the quantized forward, deployment
                # and the exports
                p["act_k"] = res["act_k"]
            layer_losses.append((node.name, float(res["loss_reported"])))
            layer_rel_losses.append((node.name,
                                     float(res["loss_relative"])))
            layer_histories[node.name] = res["history"]
            layer_seconds[node.name] = res["seconds"]
            if verbose:
                hist = res["history"]
                for i in range(0, len(hist["loss"]), 10):
                    print(f"ADMM iter {i + 1}: primal residual = "
                          f"{hist['primal_residual'][i]:.4f}, "
                          f"dual residual = {hist['dual_residual'][i]:.4f}"
                          f", rho = {hist['rho'][i]:.4f}, "
                          f"loss = {hist['loss'][i]:.7f}.")
                print(f"  {node.name}: {time.time() - t_layer:.2f}s")
            out = res["out_q"]
        else:
            # act-only quantization (q_weight off): no ADMM
            p = params[node.name]
            x_q = ins[0]
            if qcfg.q_act:
                a_act, b_act = project_by_iter(x_q, qcfg.qlvl_act, 0.0, 1.0)
                p["alpha_act"] = a_act
                x_q = a_act * b_act
            a = node.attrs
            out = ops.conv3d(x_q, p["kernel"], p.get("bias"), a["stride"],
                             a["padding"], a["dilation"], a["groups"])
        values[node.name] = out
        # free what no later node consumes: the live frontier, not the
        # network's depth, sets the peak memory
        for name in [k for k in values if last_use.get(k, -1) <= pos]:
            del values[name]

    out_q = torch.stack([values[n] for n in graph.outputs])
    _wait(out_q)
    t2 = time.time()
    report = PTQReport(layer_losses, nums, t1 - t0, t2 - t1, out_fp, out_q,
                       layer_histories, layer_rel_losses, layer_seconds)
    return graph, {"params": params, "state": state}, report


def run_ptq_mixed(graph: Graph, variables, calib_x, *, task: str,
                  init_stride, hp: PTQHyperParams = PTQHyperParams(),
                  mixed_frac: float = 0.25, mixed_qlvl: int = 16,
                  verbose: bool = False, ranking=None,
                  mixed_tail: bool = True, **kw):
    """Sensitivity-driven mixed-precision PTQ: two passes of
    :func:`run_ptq`.

    1. calibrate at the graph's grids and rank every weight-quantized layer
       by its relative reconstruction loss (scale-free, so comparable
       across layers);
    2. recalibrate with the worst ``mixed_frac`` of the layers lifted to a
       ``mixed_qlvl`` grid (weights and activations).

    Any grid of at most 128 levels deploys to the same int8 codes and
    kernels.  ``ranking``: a precomputed ``[(layer, rel_loss), ...]`` that
    skips pass 1 (``ptq/select.py`` ranks once for all its candidates).
    ``mixed_tail`` puts ``tail_sensitive_convs`` in the lift set ahead of
    the ranking; the set's size is max(k, the tail's size).  Returns
    ``(graph, qvars, report)`` with ``report.mixed_upgraded`` naming the
    lifted layers."""
    if not 0.0 < mixed_frac <= 1.0:
        raise ValueError(f"mixed_frac must be in (0, 1], got {mixed_frac}")
    if ranking is None:
        _, _, rep1 = run_ptq(graph, variables, calib_x, task=task,
                             init_stride=init_stride, hp=hp, verbose=verbose,
                             **kw)
        ranking = rep1.layer_rel_losses or rep1.layer_losses
    k = max(1, int(round(mixed_frac * len(ranking))))
    tail = tail_sensitive_convs(graph) if mixed_tail else []
    ranked = [name for name, _ in sorted(ranking, key=lambda t: -t[1])
              if name not in tail]
    worst = (tail + ranked)[:max(k, len(tail))]
    lookup = {n.name: n for n in graph.nodes}
    overrides = {}
    for name in worst:
        qcfg = lookup[name].attrs["qcfg"]
        overrides[name] = (max(qcfg.qlvl_w, mixed_qlvl),
                           max(qcfg.qlvl_act, mixed_qlvl))
    if verbose:
        print(f"mixed precision: lifting {k}/{len(ranking)} layers to "
              f"qlvl {mixed_qlvl}: {worst}")
    g2, v2, rep2 = run_ptq(graph, variables, calib_x, task=task,
                           init_stride=init_stride, hp=hp, verbose=verbose,
                           qlvl_overrides=overrides, **kw)
    rep2.mixed_upgraded.extend(worst)
    return g2, v2, rep2
