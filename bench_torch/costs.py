"""The count arithmetic: the card's published peaks, each served conv's
operations, K1's bytes and the least time of a call.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at
the full 700 W power limit.  Operations count a multiply-add as two.
Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again.
"""
from __future__ import annotations

import re
from typing import Dict, List

from .model import Conv, _triple, convs

HBM_BPS = 3.35e12  # device memory, bytes/s
INT8_OPS = 1979e12  # int8 tensor cores, operations/s
BF16_OPS = 989e12  # bf16 tensor cores
FP32_OPS = 67e12  # float32 off the tensor cores
PEAK = {"int8": INT8_OPS, "bf16": BF16_OPS, "float32": FP32_OPS}


def bound_s(nbytes: float, ops: float, peak: float):
    """(least seconds, what bounds it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def on_k1(c: Conv) -> bool:
    """Runs on K1 in the int8 deployment: an interior 3^3 stride-1 conv
    whose weights and input are both on grids of at most 128 levels."""
    return (c.k == 3 and c.stride == (1, 1, 1) and 0 < c.qlvl_w <= 128
            and 0 < c.qlvl_act <= 128)


def run_type(c: Conv) -> str:
    """The arithmetic a conv of the int8 float32 deployment runs in: K1's
    int8 tensor cores, or float32 (the float convs, and the int8 1x1
    convs off the kernel path, which multiply their codes as float32
    matrices)."""
    return "int8" if on_k1(c) else "float32"


def served_convs(cfg: Dict, patch=None, all_heads: bool = False) -> List[Dict]:
    """Each conv one patch of ``patch`` (the configuration's by default)
    runs: its name, type, output voxels, channels and operations."""
    patch = _triple(patch or cfg["patch"])
    init = _triple(cfg["init_stride"])
    base = tuple(p // s for p, s in zip(patch, init))
    nd = len(cfg["widths"]) // 2

    def extent(stage):
        depth = stage if stage <= nd else 2 * nd - stage
        return tuple(e >> depth for e in base)

    out = []
    for c in convs(cfg):
        if c.head and not all_heads:
            continue
        group, unit = (c.name.split(".") + [""])[:2]
        if group in ("conv0", "final_cls"):
            ext = base
        elif group == "trans_downs":  # TransDown i: after stage i - 1's pool
            ext = extent(int(re.sub(r"\D", "", unit)))
        else:  # UResBlock, TransUp, AuxClassifier i: at stage i - 1
            ext = extent(int(re.sub(r"\D", "", unit)) - 1)
        vox = ext[0] * ext[1] * ext[2]
        out.append(dict(name=c.name, type=run_type(c), k1=on_k1(c),
                        vox=vox, cin=c.cin, cout=c.cout,
                        ops=2 * vox * c.k ** 3 * c.cin * c.cout))
    return out


def k1_ops(cfg: Dict, patch=None) -> int:
    """int8 operations of K1's convs in one patch."""
    return sum(c["ops"] for c in served_convs(cfg, patch) if c["k1"])


def k1_call_bytes(vox: int, cin: int, cout: int, flags: Dict,
                  out_bytes: int = 4) -> int:
    """Bytes one K1 call over ``vox`` output voxels must move: its input
    (int8 codes, or float32 that it quantizes), the int8 weights, the
    float32 scale and bias, its output (the next conv's int8 codes, or
    ``out_bytes`` a value), the residual it adds and the pooled output,
    each once.  ``flags``: the deployed node's ``input_quantized``,
    ``epilogue_quant_for``, ``residual``, ``epilogue_pool``."""
    nbytes = vox * cin * (1 if flags.get("input_quantized") else 4)
    nbytes += 27 * cin * cout + 8 * cout
    out = 1 if flags.get("epilogue_quant_for") else out_bytes
    nbytes += vox * cout * out
    if flags.get("residual"):
        nbytes += vox * cout * out_bytes
    if flags.get("epilogue_pool"):
        nbytes += vox // 8 * cout * out
    return nbytes


def k1_least_s(cfg: Dict, flags: Dict[str, Dict], patches: int,
               patch=None) -> float:
    """Least seconds of one forward's K1 calls over ``patches`` patches:
    per call the larger of its bytes over the memory rate and its
    operations over the int8 peak.  ``flags``: node name -> the deployed
    node's epilogue flags."""
    total = 0.0
    for c in served_convs(cfg, patch):
        if c["k1"]:
            vox = c["vox"] * patches
            nbytes = k1_call_bytes(vox, c["cin"], c["cout"],
                                   flags.get(c["name"], {}))
            total += bound_s(nbytes, c["ops"] * patches, INT8_OPS)[0]
    return total


def peak_s(cfg: Dict, patches: int, patch=None, all_heads=False) -> float:
    """Seconds the convs of one forward over ``patches`` patches take at
    the dense peak of the type each runs in."""
    return sum(c["ops"] * patches / PEAK[c["type"]]
               for c in served_convs(cfg, patch, all_heads))
