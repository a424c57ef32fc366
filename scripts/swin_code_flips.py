#!/usr/bin/env python3
"""Where SwinUNETR's int8 codes amplify a perturbation of its attention,
on one NVIDIA GPU.

    python3 scripts/swin_code_flips.py [--seed N] [--patches N]

Builds the BraTS SwinUNETR cell's network (``bench_torch/configs/
brats_swinunetr_w4a4.json``: the published widths, seeded weights on
4-level grids, every activation range 4/3, the offset-grid layers at k =
1) and serves ``--patches`` patches of 128^3 (2 by default) of the cell's
first study through the served graph twice: once as served, once with
every K7 output moved by one float32 ulp, up or down at random, in half
of its elements (the size of the roundings by which a float32 K7 differs
from the float64 one).  For each of the 65 int8 layers on K1 and K3, in
the order they run, it prints the share of the input codes that differ
between the two runs, and what feeds the layer; then the logits' largest
difference and the share of decisions (logit >= 0) that differ.  Prints
the card's nvidia-smi line first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from bench_torch import (swinunetr_model, swinunetr_program,  # noqa: E402
                         traffic)
from efficientq_tpu_torch.kernels import WRAPPERS  # noqa: E402
from efficientq_tpu_torch.nnir import apply  # noqa: E402
from efficientq_tpu_torch.ptq.deploy import serving_graph  # noqa: E402
from efficientq_tpu_torch.quant import act_codes  # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_torch")
CONFIG = os.path.join(BENCH, "configs", "brats_swinunetr_w4a4.json")
TRAFFIC = os.path.join(BENCH, "traffic",
                       "stream_brats_study_swinunetr.json")


def recorder(codes, perturb, gen):
    """A kernel record whose K1 and K3 keep each call's input codes in
    ``codes`` and whose K7 moves half its outputs by one ulp where
    ``perturb``."""
    def k1(x, w, bias, alpha, scale, qlvl, **kw):
        codes.append(x if kw.get("x_quantized")
                     else act_codes(x, alpha, qlvl, kw.get("act_k", 0)))
        return WRAPPERS.conv3x3_int8(x, w, bias, alpha, scale, qlvl, **kw)

    def k3(x, w, bias, alpha, scale, qlvl, *a, **kw):
        codes.append(act_codes(x, alpha, qlvl, kw.get("act_k", 0)))
        return WRAPPERS.int8_matmul(x, w, bias, alpha, scale, qlvl, *a,
                                    **kw)

    def k7(*args):
        y = WRAPPERS.window_attention(*args)
        if perturb:
            u = torch.rand(y.shape, generator=gen, device=y.device)
            to = torch.where(u < 0.25, -torch.inf, torch.inf)
            y = torch.where(u < 0.5, torch.nextafter(y, to), y)
        return y

    return WRAPPERS._replace(conv3x3_int8=k1, int8_matmul=k3,
                             window_attention=k7)


def code_flips(cfg, seed: int, patches: int, device, patch: int = 128):
    """([(layer, what it reads, codes, share that differ)], the logits'
    largest difference, their largest magnitude, the share of decisions
    that differ) of ``patches`` patches of the first study of ``seed``."""
    sd = swinunetr_model.make_weights(cfg, seed, device)
    dgraph, dvars = swinunetr_program.build(cfg, sd, device)
    sg = serving_graph(dgraph)
    by_name = {n.name: n for n in sg.nodes}
    flagged = [n for n in sg.nodes
               if n.op == "conv" and n.attrs.get("pallas")]
    with open(TRAFFIC) as f:
        shape = tuple(json.load(f)["volume"])
    vol = traffic.make_volume(cfg["num_mod"], shape, seed, device)
    d, h, w = (s - patch for s in shape)
    corners = [(0, 0, 0), (d, h, w), (0, h, 0), (d, 0, w)]
    x = torch.stack([vol[:, z:z + patch, y:y + patch, v:v + patch]
                     for z, y, v in corners[:patches]])
    x = x.permute(0, 2, 3, 4, 1).contiguous()
    runs = []
    for perturb in (False, True):
        codes = []
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.inference_mode():
            logits = apply(sg, dvars, x, mode="quantized",
                           kernels=recorder(codes, perturb, gen))
        runs.append((codes, logits))
    (base, y0), (moved, y1) = runs
    if len(base) != len(flagged):
        raise RuntimeError(f"{len(base)} K1/K3 calls for {len(flagged)} "
                           f"flagged convs")
    rows = []
    for node, a, b in zip(flagged, base, moved):
        src = by_name.get(node.inputs[0])
        rows.append((node.name, src.op if src else node.inputs[0],
                     a.numel(), float((a != b).float().mean())))
    return (rows, float((y0 - y1).abs().max()), float(y0.abs().max()),
            float(((y0 >= 0) != (y1 >= 0)).float().mean()))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 scripts/swin_code_flips.py")
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--patches", type=int, default=2)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(CONFIG) as f:
        cfg = json.load(f)
    rows, gap, peak, flips = code_flips(cfg, args.seed, args.patches,
                                        torch.device("cuda"))
    print(f"{'layer':44s} {'reads':>16s} {'codes':>12s} {'differ':>10s}")
    for name, src, n, share in rows:
        print(f"{name:44s} {src:>16s} {n:12d} {share:10.3g}", flush=True)
    print(f"logits: largest difference {gap:.4g} of {peak:.4g}; decisions "
          f"that differ {flips:.4g}")


if __name__ == "__main__":
    main()
