#!/usr/bin/env python3
"""Where K1's time goes: the kernel against two ablated builds of it, on
one NVIDIA GPU.

    python3 scripts/k1_ablation.py

Builds ``efficientq_tpu_torch/csrc/qconv3d_int8.cu`` three times, with nvcc
and the port's flags: as it is ("full"); with the epilogue skipped ("taps
only": the halo and weight loads and the 27 taps of mma, no output); and
with the tap loop skipped ("epilogue only": the loads and the epilogue of
zero sums).  Each is timed by CUDA graph replay (the median of 5 rounds of
20 replays) at one B = 8 bfloat16 forward's four stage shapes of the
flagship BraTS net, with the block1 (quant) and block2 (codes, bf16
residual with relu, pool where the net pools) epilogues.  The ablated
builds compute wrong outputs: they only time the phases.  Prints the
card's nvidia-smi line and one line per shape.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from efficientq_tpu_torch.kernels import build  # noqa: E402
from efficientq_tpu_torch.kernels import qconv3d as K  # noqa: E402
from efficientq_tpu_torch.quant import act_codes  # noqa: E402

EPILOGUE = ("    if (s % a.nchunks == a.nchunks - 1) {  // the brick is "
            "summed: epilogue\n")
TAPS = "    fragments(0, af[0], bf[0]);\n"
TAPS_END = "\n    if (s % a.nchunks == a.nchunks - 1) {"
# (extent, C = O, pooled): the four stage shapes at a 128^3 patch
SHAPES = [(64, 32, True), (32, 64, True), (16, 128, True), (8, 256, False)]
BATCH = 8


def variants(src: str):
    """The source as it is and its two ablations (runtime-false guards,
    so nothing else of the kernel changes)."""
    assert src.count(EPILOGUE) == 1 and src.count(TAPS) == 1
    taps_only = src.replace(
        EPILOGUE, EPILOGUE.replace("if (", "if (a.dil < 0 && "))
    head, tail = src.split(TAPS)
    body, rest = tail.split(TAPS_END, 1)
    epilogue_only = (head + "    if (a.dil < 0) {\n" + TAPS + body
                     + "\n    }" + TAPS_END + rest)
    return {"full": src, "taps only": taps_only,
            "epilogue only": epilogue_only}


def build_all(srcs):
    out_dir = os.path.join(build.BUILD_DIR, "ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        stem = os.path.join(out_dir, name.replace(" ", "_"))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[name] = (stem + ".so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} build:\n{log}")
        fn = ctypes.CDLL(lib).qconv3d_int8_launch
        fn.argtypes = K._lib().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def graph_ms(fn, reps=20, rounds=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("k1_ablation: no CUDA device; nothing was run")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with open(os.path.join(build.CSRC, "qconv3d_int8.cu")) as f:
        fns = build_all(variants(f.read()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    one = torch.tensor(1.0, device=dev)
    scale = torch.tensor(0.05, device=dev)
    for s, c, pooled in SHAPES:
        x = torch.randn(BATCH, s, s, s, c, device=dev, generator=gen)
        qa = act_codes(x, one, 4)
        w = (2 * torch.randint(0, 4, (3, 3, 3, c, c), device=dev,
                               generator=gen) - 3).to(torch.int8)
        wp = K.pack_weights(w)
        b = torch.randn(c, device=dev, generator=gen)
        res = torch.randn(BATCH, s, s, s, c, device=dev,
                          generator=gen).to(torch.bfloat16)
        for label, kw in (("block1 (quant)", dict(quant_alpha=one,
                                                  quant_qlvl=4)),
                          ("block2 (codes+residual+relu"
                           + ("+pool)" if pooled else ")"),
                           dict(residual=res, residual_relu=True,
                                pool=pooled))):
            row = []
            for name, fn in fns.items():
                K._lib = lambda fn=fn: fn
                ms = graph_ms(lambda: K.qconv3x3_int8_ndhwc(
                    qa, w, b, one, scale, 4, x_quantized=True, w_packed=wp,
                    out_dtype=torch.bfloat16, **kw))
                row.append(f"{name} {ms:.4f} ms")
            print(f"N={BATCH} {s}^3 C=O={c} {label}: " + "  ".join(row),
                  flush=True)
        del x, qa, res


if __name__ == "__main__":
    main()
