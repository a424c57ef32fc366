"""Checkpoint interop.

Counterpart of the JAX package's ``models/torch_io.py``.  Graph node names
mirror the reference's torch module paths, so conversion is mechanical:

- conv node ``X``  <->  ``X.weight`` (OIDHW <-> DHWIO), ``X.bias``,
  ``X.alpha_w``, ``X.alpha_act``, ``X.act_k`` (an int32 offset-grid shift);
  a ``linear`` conv's weight is nn.Linear's (out, in), a ``transposed``
  one's ConvTranspose3d's (in, out, f, f, f) (its 1x1 conv to f^3 out
  channels, channel t out + o for tap t = (a f + b) f + c)
- bn node ``X``    <->  ``X.weight`` (scale), ``X.bias``, ``X.running_mean``,
  ``X.running_var``
- group-norm node ``X`` (``group_norm``, or the serving rewrite's
  ``group_norm_k6``) and affine layer-norm node ``X``  <->  ``X.weight``
  (scale), ``X.bias``; a norm without an affine has no keys
- window-attention node ``X``  <->  ``X.relative_position_bias_table``,
  and ``X.relative_position_index`` (MONAI's buffer; written on export,
  checked on load)

``from_jax_variables`` carries the JAX package's variables (as NumPy
arrays) over to the port, key for key.
"""
from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch

from ..nnir import Graph
from ..quant import unpack_int_weight


_GROUP_NORMS = ("group_norm", "group_norm_k6")


def _affine_norm(node) -> bool:
    return ((node.op in _GROUP_NORMS or node.op == "layer_norm")
            and node.attrs.get("affine", True))


def _conv_weight_in(node, w: np.ndarray) -> torch.Tensor:
    """A checkpoint's conv weight as the node's DHWIO kernel."""
    t = torch.from_numpy(np.array(w, np.float32))
    if node.attrs.get("linear"):
        return t.t().reshape(1, 1, 1, *t.t().shape).contiguous()
    f = node.attrs.get("transposed")
    if f:
        cin = t.shape[0]
        return t.permute(0, 2, 3, 4, 1).reshape(1, 1, 1, cin, -1).contiguous()
    return t.permute(2, 3, 4, 1, 0).contiguous()


def _conv_weight_out(node, kernel: np.ndarray) -> np.ndarray:
    """The node's DHWIO kernel as a checkpoint holds it."""
    if node.attrs.get("linear"):
        return np.ascontiguousarray(kernel.reshape(kernel.shape[-2:]).T)
    f = node.attrs.get("transposed")
    if f:
        cin, c8 = kernel.shape[-2:]
        w = kernel.reshape(cin, f, f, f, c8 // f ** 3)
        return np.ascontiguousarray(np.transpose(w, (0, 4, 1, 2, 3)))
    return np.transpose(kernel, (4, 3, 0, 1, 2))


def _to_np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _from_np(v, device) -> torch.Tensor:
    """A NumPy array as a torch tensor on ``device``; a bfloat16 array (the
    ml_dtypes type that ``np.asarray`` gives for a JAX bf16 array, which
    torch cannot take) travels as its uint16 bits."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        bits = torch.tensor(a.view(np.uint16).view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    return torch.tensor(a, device=device)


def from_jax_variables(variables_np, device="cuda") -> Dict:
    """{'params': {node: {k: array}}, 'state': ...} of NumPy arrays (e.g.
    ``jax.tree_util.tree_map(np.asarray, variables)``) -> the same dict of
    torch tensors on ``device``."""
    return {group: {node: {k: _from_np(v, device)
                           for k, v in entries.items()}
                    for node, entries in variables_np.get(group, {}).items()}
            for group in ("params", "state")}


def load_torch_state_dict(graph: Graph, variables, state_dict: Mapping,
                          strict=False):
    """Map a torch-style flat state dict into {'params', 'state'} dicts.

    Returns new variables (input untouched).  Missing keys keep current
    values unless ``strict``."""
    sd = {k: _to_np(v) for k, v in state_dict.items()}
    params = {k: dict(v) for k, v in variables["params"].items()}
    state = {k: dict(v) for k, v in variables.get("state", {}).items()}
    missing = []

    def take(key):
        if key in sd:
            return torch.from_numpy(np.array(sd[key], np.float32))
        missing.append(key)
        return None

    for node in graph.nodes:
        if node.op == "conv":
            w = take(f"{node.name}.weight")
            if w is not None:
                params[node.name]["kernel"] = _conv_weight_in(node, w.numpy())
            if "bias" in params[node.name]:
                b = take(f"{node.name}.bias")
                if b is not None:
                    params[node.name]["bias"] = b
            for alpha in ("alpha_w", "alpha_act"):
                if alpha in params[node.name] and f"{node.name}.{alpha}" in sd:
                    a = take(f"{node.name}.{alpha}")
                    # reference alphas are 0-d/1-element tensors; ours may
                    # be per-output-channel vectors (channel_wise)
                    params[node.name][alpha] = a.reshape(()) if a.numel() == 1 else a
            if f"{node.name}.act_k" in sd:
                # the offset-grid shift (run_ptq act_offset), absent from
                # reference checkpoints
                params[node.name]["act_k"] = torch.tensor(
                    int(np.asarray(sd[f"{node.name}.act_k"]).reshape(())),
                    dtype=torch.int32)
        elif node.op == "window_attention":
            t = take(f"{node.name}.relative_position_bias_table")
            if t is not None:
                params[node.name]["relative_position_bias_table"] = t
            key = f"{node.name}.relative_position_index"
            if key in sd and not np.array_equal(
                    sd[key], _position_index(node)):
                raise ValueError(f"{key} is not MONAI's index of window "
                                 f"{node.attrs['window']}")
        elif node.op == "bn" or _affine_norm(node):
            for ours, theirs in (("scale", "weight"), ("bias", "bias")):
                v = take(f"{node.name}.{theirs}")
                if v is not None:
                    params[node.name][ours] = v
            if node.op != "bn":
                continue
            for ours, theirs in (("mean", "running_mean"),
                                 ("var", "running_var")):
                v = take(f"{node.name}.{theirs}")
                if v is not None:
                    state[node.name][ours] = v
    if strict and missing:
        raise KeyError(f"missing keys in state dict: {missing}")
    return {"params": params, "state": state}


class _Unreadable:
    """Stands in for an object whose class cannot be imported here."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class PermissiveUnpickler(pickle.Unpickler):
    """A pickle reader that gives a placeholder for any class whose module
    is missing: a JAX training snapshot's ``opt_state`` holds optax's state
    classes, and its ``state_dict`` (NumPy arrays) is all the port reads."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _Unreadable


def load_torch_checkpoint(graph: Graph, variables, path: str, strict=False):
    """Load a training checkpoint, ``{'state_dict': ...}`` or a bare state
    dict: torch-serialized (the reference's format) or a plain pickle (the
    training snapshots of either package)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        with open(path, "rb") as f:
            ckpt = PermissiveUnpickler(f).load()
    sd = ckpt.get("state_dict", ckpt)
    return load_torch_state_dict(graph, variables, sd, strict)


def _read_export_state_dict(path: str):
    # PTQ exports written by this project's ptq mission
    if path.endswith(".npz"):
        return np.load(path, allow_pickle=True)["state_dict"].item()
    with open(path, "rb") as f:
        return pickle.load(f)["state_dict"]


def read_export_qlvl_overrides(path: str):
    """The per-layer (qlvl_w, qlvl_act) map a PTQ export carries
    (``__qlvl_overrides__``); {} for uniform-precision exports."""
    return dict(_read_export_state_dict(path).get("__qlvl_overrides__", {}))


def load_int8_checkpoint(graph: Graph, variables, path: str):
    """Load a PTQ int8-packed export (state_in_int8.pkl /
    state_in_int8_compress.npz) and restore FP-valued quantized weights.
    A code outside [0, qlvl_w-1], or a packing grid other than the graph's,
    raises."""
    sd = dict(_read_export_state_dict(path))
    overrides = dict(sd.pop("__qlvl_overrides__", {}))
    for node in graph.qconv_nodes():
        qcfg = node.attrs["qcfg"]
        key = f"{node.name}.weight"
        if not qcfg.q_weight or key not in sd:
            continue
        w = np.asarray(sd[key])
        if w.dtype in (np.uint8, np.int32):
            saved = overrides.get(node.name)
            if saved is not None and int(saved[0]) != qcfg.qlvl_w:
                raise ValueError(
                    f"{node.name}: export was packed at qlvl_w={saved[0]} "
                    f"but the graph expects {qcfg.qlvl_w} (mixed-precision "
                    f"export)")
            if int(w.max(initial=0)) > qcfg.qlvl_w - 1:
                raise ValueError(
                    f"{node.name}: packed code {int(w.max())} exceeds "
                    f"qlvl_w-1={qcfg.qlvl_w - 1} — the export was produced "
                    f"at a different grid than the graph's qcfg")
            alpha = np.asarray(sd[f"{node.name}.alpha_w"])
            sd[key] = unpack_int_weight(w, alpha, qcfg.qlvl_w)
    return load_torch_state_dict(graph, variables, sd)


def _position_index(node) -> np.ndarray:
    from ..kernels.window_attention import relative_position_index

    return relative_position_index(node.attrs["window"]).numpy()


def to_torch_state_dict(graph: Graph, variables) -> Dict[str, np.ndarray]:
    """Export variables as a torch-style flat NumPy state dict."""
    out: Dict[str, np.ndarray] = {}
    params = variables["params"]
    state = variables.get("state", {})
    for node in graph.nodes:
        if node.op == "conv":
            p = params[node.name]
            out[f"{node.name}.weight"] = _conv_weight_out(
                node, _to_np(p["kernel"]))
            for k in ("bias", "alpha_w", "alpha_act", "act_k"):
                if k in p:
                    out[f"{node.name}.{k}"] = _to_np(p[k])
        elif node.op == "window_attention":
            out[f"{node.name}.relative_position_bias_table"] = _to_np(
                params[node.name]["relative_position_bias_table"])
            out[f"{node.name}.relative_position_index"] = _position_index(
                node)
        elif _affine_norm(node):
            p = params[node.name]
            out[f"{node.name}.weight"] = _to_np(p["scale"])
            out[f"{node.name}.bias"] = _to_np(p["bias"])
        elif node.op == "bn":
            p = params[node.name]
            s = state[node.name]
            out[f"{node.name}.weight"] = _to_np(p["scale"])
            out[f"{node.name}.bias"] = _to_np(p["bias"])
            out[f"{node.name}.running_mean"] = _to_np(s["mean"])
            out[f"{node.name}.running_var"] = _to_np(s["var"])
    return out
