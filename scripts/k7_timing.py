#!/usr/bin/env python3
"""K7 alone at SwinUNETR's eight window attentions, on one NVIDIA GPU.

    python3 scripts/k7_timing.py [--patches N] [--rounds N]

Builds ``efficientq_tpu_torch/csrc/window_attention.cu`` and runs K7
(``kernels/window_attention.py::window_attention``) at the four stages of
the published SwinUNETR on ``--patches`` patches of 128^3 (8, the BraTS
cell's chunk, by default): 64^3 x 48 channels of 3 heads, 32^3 x 96 of 6,
16^3 x 192 of 12 and 8^3 x 384 of 24, each unshifted and shifted by 3
(window 7).  For each it prints the device time of one call (CUDA events
around ``--rounds`` calls, 5 by default), the float32 rate of the queries
on the unpadded grid (q k^T and p v against the window's 343 keys, a
multiply-add two) and that rate's share of the 67 TFLOP/s float32 peak,
then the total.  Prints the card's nvidia-smi line first and ptxas's
registers and spills of the K7 build.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from efficientq_tpu_torch.kernels import build  # noqa: E402
from efficientq_tpu_torch.kernels import window_attention as K7  # noqa: E402

STAGES = ((64, 48, 3), (32, 96, 6), (16, 192, 12), (8, 384, 24))
FP32_OPS = 67e12
WINDOW = 7


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 scripts/k7_timing.py")
    ap.add_argument("--patches", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("K7 needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    K7._lib()
    for line in build.build_log.get("window_attention.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    total_ms = total_ops = 0.0
    for ext, c, heads in STAGES:
        qkv = torch.randn((args.patches, ext, ext, ext, 3 * c),
                          generator=gen, device=dev)
        table = 0.5 * torch.randn(((2 * WINDOW - 1) ** 3, heads),
                                  generator=gen, device=dev)
        bias = 0.3 * torch.randn(3 * c, generator=gen, device=dev)
        for shift in (0, WINDOW // 2):
            def call():
                return K7.window_attention(qkv, table, bias, heads,
                                           (WINDOW,) * 3, (shift,) * 3)
            call()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record()
            for _ in range(args.rounds):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / args.rounds
            n = min(ext, WINDOW) ** 3
            ops = 4.0 * args.patches * ext ** 3 * c * n
            total_ms += ms
            total_ops += ops
            print(f"{ext}^3 x {c}, {heads} heads, shift {shift}: "
                  f"{ms:.3f} ms, {ops / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * ops / ms / 1e-3 / FP32_OPS:.1f} % of the peak")
    print(f"all eight: {total_ms:.3f} ms, "
          f"{total_ops / total_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * total_ops / total_ms / 1e-3 / FP32_OPS:.1f} % of the peak")
    return 0


if __name__ == "__main__":
    sys.exit(main())
