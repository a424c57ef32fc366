"""PTQ engine: the layer-wise calibration sweep (PyTorch).

Counterpart of the JAX package's ``ptq/engine.py`` at layer granularity:

1. fold BN (a pure graph transform)
2. one captured FP forward collects every qconv's FP output (the
   per-layer regression target)
3. attention weight map + mask pyramid from the FP prediction
4. an eager sweep over the node list: at each qconv the *current* input
   (which carries the quantization error of the layers before it) is
   fake-quantized, the layer is calibrated by ADMM (admm.py), and its
   quantized output feeds the next node

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

    def layer_loss_lines(self) -> List[str]:
        """layer_loss.txt formatting."""
        return [f"{name:45s}:{loss}" for name, loss in self.layer_losses]

    def time_cost_line(self) -> str:
        total = self.fp_forward_seconds + self.calibration_seconds
        return f"{total / 60:.3f} min."


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


def _layer_kw(node, qcfg, p, hp):
    """The calibrate_layer keywords of one qconv."""
    return dict(ksize=node.attrs["kernel_size"], stride=node.attrs["stride"],
                padding=node.attrs["padding"],
                dilation=node.attrs["dilation"], qlvl_w=qcfg.qlvl_w,
                has_bias="bias" in p, hp=hp,
                qlvl_act=qcfg.qlvl_act if qcfg.q_act else None)


def _wait(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def run_ptq(graph: Graph, variables, calib_x, *, task: str, init_stride,
            hp: PTQHyperParams = PTQHyperParams(), att_style: str = "p:0.5",
            num_mask_lvls: int = 5, fold: bool = True, verbose: bool = False,
            mesh=None, granularity: str = "layer",
            qlvl_overrides: Dict[str, Tuple[int, int]] = None,
            block_target: str = "quantized", act_offset: int = 0,
            device="cuda"):
    """Calibrate every qconv of ``graph`` on one NDHWC calibration batch.

    ``variables`` and ``calib_x`` are moved to ``device`` (the card unless
    told ``"cpu"``).  Returns (folded_graph, quantized_variables,
    PTQReport).  After this, ``nnir.apply(folded_graph, qvars, x,
    mode='quantized')`` runs quantized inference (the stored kernels hold
    quantized values; activations are fake-quantized by alpha_act).

    Not ported yet: ``mesh`` (ROADMAP queue 1 item 9), and
    ``granularity='block'``, ``block_target`` and ``act_offset`` (item 7).
    """
    if mesh is not None:
        raise NotImplementedError("mesh-sharded calibration is ROADMAP "
                                  "queue 1 item 9")
    if granularity != "layer" or block_target != "quantized":
        raise NotImplementedError("block-granularity calibration "
                                  "(granularity, block_target) is ROADMAP "
                                  "queue 1 item 7")
    if act_offset:
        raise NotImplementedError("offset activation grids (act_offset) are "
                                  "ROADMAP queue 1 item 7")
    device = torch.device(device)
    variables = nnir.to_device(variables, device)
    calib_x = torch.as_tensor(calib_x).to(device)
    if fold:
        graph, variables = fold_bn(graph, variables)
    if qlvl_overrides:
        graph = apply_qlvl_overrides(graph, qlvl_overrides)
    params = {k: dict(v) for k, v in variables["params"].items()}
    state = variables.get("state", {})
    with ops.exact_f32():
        return _sweep(graph, params, state, calib_x, task, init_stride, hp,
                      att_style, num_mask_lvls, verbose)


def _sweep(graph, params, state, calib_x, task, init_stride, hp, att_style,
           num_mask_lvls, verbose):
    t0 = time.time()
    out_fp, captured = nnir.apply(
        graph, {"params": params, "state": state}, calib_x, mode="fp",
        capture=[n.name for n in graph.qconv_nodes()])
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
            res = calibrate_layer(
                ins[0], y_fp, p["kernel"], p.get("bias"),
                match_pyramid_level(pyramid, y_fp.shape),
                **_layer_kw(node, qcfg, p, hp))
            p["kernel"] = res["kernel"]
            if res["bias"] is not None:
                p["bias"] = res["bias"]
            p["alpha_w"] = res["alpha_w"]
            if res["alpha_act"] is not None:
                p["alpha_act"] = res["alpha_act"]
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
