#!/usr/bin/env python3
"""Where K1's time goes: the kernel against two ablated builds of it, on
one NVIDIA GPU.

    python3 scripts/k1_ablation.py

Builds ``efficientq_tpu_torch/csrc/qconv3d_int8.cu`` three times, with nvcc
and the port's flags: as it is ("full"); with the epilogue's work skipped
("taps only": the halo and weight loads, the 27 taps of mma and the
sums' hand-off, no output); and with the tap loop skipped ("epilogue
only": the loads and the epilogue of zero sums).  On the overlapped
pipeline (``TilePlan.sums`` > 0) the full build takes about the longer of
the two ablated ones, where the blocks that take turns take about their
sum.  Each is timed by CUDA graph replay (the median of 5 rounds of 20
replays) at the K1 shapes of one forward of eight patches of three nets,
on codes (the float-input pass is not timed):

- the flagship BraTS net's four stages, bfloat16 out: block1 (quant) and
  block2 (bf16 residual with relu, pool where the net pools);
- the LiTS serving net's three stages on the 4 x 8 brick, float32:
  block1 (quant) and block2 (float32 residual with relu, pool in the
  encoder);
- SegResNet's four levels, float32: conv1 (y) and conv2 (float32
  residual).

The ablated builds compute wrong outputs: they only time the phases.
Prints the card's nvidia-smi line and one line per shape and epilogue,
with the tile plan (brick, grid, sums buffers: 0 when the warps take
turns).
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
# where the taps end in a source with the overlapped pipeline: its MMA
# warps release the stage right after them
TAPS_END_OVERLAP = "\n    if constexpr (OVERLAP) mbar_arrive(empty"
# the epilogue's work in a source with the overlapped pipeline (whose
# warps must still hand each brick's buffers over): its calls, and how
# many there are
EPILOGUE_CALLS = {"epilogue_brick<BZ, BY, ": 3}
BATCH = 8
# (net, extent (d, h, w), C = O, output dtype, epilogues): each epilogue
# (label, its keywords, with the residual of the output dtype as "res")
QUANT = ("block1 (quant)", dict(quant_qlvl=4))
SHAPES = [
    ("flagship", (64,) * 3, 32, torch.bfloat16,
     [QUANT, ("block2 (codes+residual+relu+pool)",
              dict(res=True, residual_relu=True, pool=True))]),
    ("flagship", (32,) * 3, 64, torch.bfloat16,
     [QUANT, ("block2 (codes+residual+relu+pool)",
              dict(res=True, residual_relu=True, pool=True))]),
    ("flagship", (16,) * 3, 128, torch.bfloat16,
     [QUANT, ("block2 (codes+residual+relu+pool)",
              dict(res=True, residual_relu=True, pool=True))]),
    ("flagship", (8,) * 3, 256, torch.bfloat16,
     [QUANT, ("block2 (codes+residual+relu)",
              dict(res=True, residual_relu=True))]),
] + [
    ("LiTS", (s,) * 3, c, torch.float32,
     [QUANT, ("block2 (codes+residual+relu+pool)",
              dict(res=True, residual_relu=True, pool=True)),
      ("block2 (codes+residual+relu)", dict(res=True, residual_relu=True))])
    for s, c in ((64, 32), (32, 64), (16, 128))
] + [
    ("SegResNet", (128 >> lv, 192 >> lv, 160 >> lv), 32 << lv,
     torch.float32, [("conv1 (y)", {}), ("conv2 (residual)",
                                         dict(res=True))])
    for lv in range(4)
]


def variants(src: str):
    """The source as it is and its two ablations (runtime-false guards,
    so nothing else of the kernel changes).  A source without the
    overlapped pipeline, whose epilogue is written inline at the brick's
    end, loses that whole block in "taps only"."""
    assert src.count(TAPS) == 1
    overlap = "BAR_FULL" in src
    end = TAPS_END_OVERLAP if overlap else TAPS_END
    if overlap:
        taps_only = src
        for call, count in EPILOGUE_CALLS.items():
            assert src.count(call) == count, call
            taps_only = taps_only.replace(call, "if (a.dil < 0) " + call)
    else:
        assert src.count(EPILOGUE) == 1
        taps_only = src.replace(
            EPILOGUE, EPILOGUE.replace("if (", "if (a.dil < 0 && "))
    head, tail = src.split(TAPS)
    body, rest = tail.split(end, 1)
    epilogue_only = (head + "    if (a.dil < 0) {\n" + TAPS + body
                     + "\n    }" + end + rest)
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
    for net, (d, h, w), c, out_dtype, epilogues in SHAPES:
        qa = act_codes(torch.randn(BATCH, d, h, w, c, device=dev,
                                   generator=gen), one, 4)
        wc = (2 * torch.randint(0, 4, (3, 3, 3, c, c), device=dev,
                                generator=gen) - 3).to(torch.int8)
        wp = K.pack_weights(wc)
        b = torch.randn(c, device=dev, generator=gen)
        res = torch.randn(BATCH, d, h, w, c, device=dev,
                          generator=gen).to(out_dtype)
        plan = K._tile_plan(BATCH, d, h, w, c, c, 1)
        for label, spec in epilogues:
            kw = dict(spec)
            if kw.pop("res", False):
                kw["residual"] = res
            if "quant_qlvl" in kw:
                kw["quant_alpha"] = one
            row = []
            for name, fn in fns.items():
                K._lib = lambda fn=fn: fn
                ms = graph_ms(lambda: K.qconv3x3_int8_ndhwc(
                    qa, wc, b, one, scale, 4, x_quantized=True, w_packed=wp,
                    out_dtype=out_dtype, **kw))
                row.append(f"{name} {ms:.4f} ms")
            print(f"{net} N={BATCH} {d}x{h}x{w} C=O={c} "
                  f"{str(out_dtype).replace('torch.', '')} {label}: "
                  + "  ".join(row) + f"  (brick {plan.brick[:2]}, grid "
                  f"{plan.grid}, sums {getattr(plan, 'sums', 0)})",
                  flush=True)
        del qa, res
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
