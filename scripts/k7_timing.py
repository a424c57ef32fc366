#!/usr/bin/env python3
"""K7 alone at SwinUNETR's eight window attentions, on one NVIDIA GPU.

    python3 scripts/k7_timing.py [--patches N] [--rounds N] [--ablate]

Builds ``efficientq_tpu_torch/csrc/window_attention.cu`` and runs K7
(``kernels/window_attention.py::window_attention``) at the four stages of
the published SwinUNETR on ``--patches`` patches of 128^3 (8, the BraTS
cell's chunk, by default): 64^3 x 48 channels of 3 heads, 32^3 x 96 of 6,
16^3 x 192 of 12 and 8^3 x 384 of 24, each unshifted and shifted by 3
(window 7).  For each it prints the device time of one call (CUDA events
around ``--rounds`` calls, 5 by default), the rate of the queries on the
unpadded grid (q k^T and p v against the window's 343 keys, a
multiply-add two) and that rate's share of 67 TFLOP/s (the float32 peak
off the tensor cores, and the float64 tensor cores' peak), the scores of
K7's tiles (``tile_scores``, padding included) over those of the
queries, and K7's blocks and warps resident on an SM at the stage's
window; then the total.  Prints the card's nvidia-smi line first and
ptxas's registers and spills of the K7 build.  ``--ablate`` also builds
K7 with parts taken out or changed (``variants``: wrong outputs, except
where a name says the outputs are the same) and times each at the 64^3
stage, shift 0 and 3, beside the full kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from efficientq_tpu_torch import kernels  # noqa: E402
from efficientq_tpu_torch.kernels import build  # noqa: E402
from efficientq_tpu_torch.kernels import window_attention as K7  # noqa: E402

STAGES = ((64, 48, 3), (32, 96, 6), (16, 192, 12), (8, 384, 24))
FP32_OPS = 67e12
WINDOW = 7


def resident(c, heads, window, shift):
    """(blocks, warps) of K7 resident on an SM at a launch of this
    geometry."""
    lib = build.load("window_attention.cu")
    fn = lib.effq_window_attention_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    tri = ctypes.c_int * 3
    blocks = fn(c, heads, tri(*window), tri(*(WINDOW,) * 3), tri(*shift))
    return blocks, blocks * K7.THREADS // 32


FAST = """  } else {
    exp_fast(x);
  }"""
MMA = "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
MASK = "if (SHIFTED) x ="
KT = "constexpr int KT = 2 * KG;"
DMAX = "return a > b ? a : b;"
BOUNDS = "__launch_bounds__(THREADS, 2)"
WARPS = "constexpr int WARPS = 8;"


def variants(src: str):
    """K7's source with one part taken out or changed, by name."""
    for part in (FAST, MMA, MASK, KT, DMAX, BOUNDS, WARPS):
        assert src.count(part) == 1, part
    one = "__launch_bounds__(THREADS, 1)"
    return {
        "no exps": src.replace(FAST, "  }"),
        "the toolkit's exp (same outputs)": src.replace(FAST, """  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = exp(x[i]);
  }"""),
        "fmax for the max (same outputs)": src.replace(
            DMAX, "return fmax(a, b);"),
        "no MMAs (their operands kept)": src.replace(MMA, "// "),
        "no mask": src.replace(MASK, "if (false) x ="),
        "keys in tiles of 16": src.replace(KT, "constexpr int KT = KG;"),
        "one block an SM, up to 255 registers": src.replace(BOUNDS, one),
        "12 warps, one block an SM": src.replace(
            WARPS, "constexpr int WARPS = 12;").replace(BOUNDS, one),
    }


def build_variants():
    """Each variant built with the port's nvcc flags, all at once; returns
    {name: (launch function, ptxas's registers and spill stores)}."""
    with open(os.path.join(build.CSRC, "window_attention.cu")) as f:
        srcs = variants(f.read())
    out_dir = os.path.join(build.BUILD_DIR, "k7_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        stem = os.path.join(out_dir, "".join(
            ch if ch.isalnum() else "_" for ch in name))
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
        fn = ctypes.CDLL(lib).effq_window_attention_launch
        fn.argtypes = K7._lib().argtypes
        fn.restype = ctypes.c_int
        fns[name] = (fn, _resources(log))
    return fns


def _resources(log: str) -> str:
    """ptxas's registers and spill stores of each kernel of a build log."""
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return f"registers {'/'.join(regs)}, spill stores {'/'.join(spills)} B"


def _direct(fn, qkv, table, bias, heads, shift, out):
    """One launch of a build's K7 entry point ``fn`` (no wrapper checks)."""
    n, d, h, w, c3 = qkv.shape
    win, full, sh = K7._geometry((d, h, w), (WINDOW,) * 3, (shift,) * 3)
    rc = kernels.on_device(qkv.get_device(), fn, qkv.data_ptr(),
                           bias.data_ptr(), table.data_ptr(), out.data_ptr(),
                           n, d, h, w, c3 // 3, heads, win, full, sh, 0.25)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: cudaError_t {rc}")


def _ms(call, rounds):
    """Device ms of one call: CUDA events around ``rounds`` calls."""
    call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(rounds):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 scripts/k7_timing.py")
    ap.add_argument("--patches", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("K7 needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    K7._lib()
    log = build.build_log.get("window_attention.cu", "")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(line.strip())
    print(f"K7 build: {_resources(log)}")
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
            ms = _ms(call, args.rounds)
            n = min(ext, WINDOW) ** 3
            ops = 4.0 * args.patches * ext ** 3 * c * n
            total_ms += ms
            total_ops += ops
            tiles = K7.tile_scores((ext,) * 3, (WINDOW,) * 3, (shift,) * 3,
                                   args.patches, heads)
            win, sh = K7.window_geometry((ext,) * 3, (WINDOW,) * 3,
                                         (shift,) * 3)
            blocks, warps = resident(c, heads, win, sh)
            print(f"{ext}^3 x {c}, {heads} heads, shift {shift}: "
                  f"{ms:.3f} ms, {ops / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * ops / ms / 1e-3 / FP32_OPS:.1f} % of the peak; "
                  f"tile scores {tiles} ({tiles / (ops / 4 / c * heads):.4f}"
                  f" of the queries'), {blocks} blocks, {warps} warps an SM")
    print(f"all eight: {total_ms:.3f} ms, "
          f"{total_ops / total_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * total_ops / total_ms / 1e-3 / FP32_OPS:.1f} % of the peak")
    if args.ablate:
        t0 = time.perf_counter()
        builds = build_variants()
        print(f"built {len(builds)} variants in "
              f"{time.perf_counter() - t0:.1f} s")
        ext, c, heads = STAGES[0]
        qkv = torch.randn((args.patches, ext, ext, ext, 3 * c),
                          generator=gen, device=dev)
        table = 0.5 * torch.randn(((2 * WINDOW - 1) ** 3, heads),
                                  generator=gen, device=dev)
        bias = 0.3 * torch.randn(3 * c, generator=gen, device=dev)
        out = torch.empty((args.patches, ext, ext, ext, c), device=dev)
        for shift in (0, WINDOW // 2):
            want = K7.window_attention(qkv, table, bias, heads,
                                       (WINDOW,) * 3, (shift,) * 3)
            full = _ms(lambda: _direct(K7._lib(), qkv, table, bias, heads,
                                       shift, out), args.rounds)
            print(f"{ext}^3 x {c}, shift {shift}: the full kernel {full:.3f}"
                  f" ms")
            for name, (fn, ptxas) in builds.items():
                ms = _ms(lambda: _direct(fn, qkv, table, bias, heads, shift,
                                         out), args.rounds)
                same = torch.equal(out, want)
                print(f"  {name}: {ms:.3f} ms ({ms / full:.3f} of the "
                      f"full), outputs equal: {same}; {ptxas}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
