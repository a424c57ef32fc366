#!/usr/bin/env python3
"""K4 alone at the flagship's 1x1 shapes, on one NVIDIA GPU.

    python3 scripts/k4_timing.py [--sweep] [--ablate] [--rounds N]

Builds ``efficientq_tpu_torch/csrc/qmatmul_f32.cu`` and runs K4
(``kernels/qmatmul.py::fused_qact_matmul``) at the twelve shapes of
``chip_smoke.py`` phase 5: the six transition 1x1 convs of the BraTS net at
B = 2 patches with float32 x and B = 8 with bfloat16 x.  At each shape it
checks K4 against its plain version (within 1e-5 max|y|) and prints the
plan of ``_k4_plan``, K4's time per call (events around one call, the
host's time included, median of 20) and as device time (CUDA graph
replay), the same two for float32 ``torch.addmm`` with TF32 off on the
fake-quantized x, and the bound (bytes over 3.35 TB/s against operations
over the 67 TFLOP/s float32 peak).  ``--rounds N`` repeats the K4 timings
N times and prints min / median / max.  ``--sweep`` also times, as device
time, every tiling of ``_k4_candidates`` at each shape (the tuning loop of
the plan), marking the plan's own.  ``--ablate`` also builds the kernel
with parts of its work skipped (runtime-false guards or dead stores, so
the rest compiles as it is) and times each build as device time with the
plan's tiling: without the fake-quant arithmetic (raw x copied into the
k-major tile), without the conversion of x at all, without the FMAs (and
so their operand reads), with neither the FMAs nor the stores of y (the
loads of x and w and the conversion alone), ending after the first slice
(its loads and conversion), and as an empty kernel (the launch alone).  The ablated builds
compute wrong outputs: they only time the parts.  Prints the card's
nvidia-smi line first, then ptxas's registers and spills of each K4 build.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (FP32_OPS, N_BATCH, ONE_BY_ONE, S2D_BATCH,  # noqa: E402
                        _bound, _graph_ms, _median_ms, _ptxas_lines, gpu_line)
from efficientq_tpu_torch import kernels  # noqa: E402
from efficientq_tpu_torch.kernels import build  # noqa: E402
from efficientq_tpu_torch.kernels import qmatmul as KM  # noqa: E402
from efficientq_tpu_torch.quant import fake_quant_act  # noqa: E402


OUT = "  float* out = dst + j * EPP * a.bm + r;\n"
CONVERT = "      if (kk % EVERY == EVERY - 1) {\n"
FMA = ("#pragma unroll\n      for (int i = 0; i < 4; ++i)\n"
       "#pragma unroll\n        for (int j = 0; j < 4 * RN; ++j)\n"
       "          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);\n")
EPILOGUE = "    if (kc == nkc - 1) {  // the tile is summed"
START = "  extern __shared__ __align__(128) char smem[];\n"
PROLOGUE = "  float acc[4][4 * RN];\n"


def variants(src: str):
    """The ablated sources of ``--ablate`` (runtime-false guards, or the
    fake-quant's result replaced by the raw value)."""
    for part in (OUT, CONVERT, FMA, EPILOGUE, START, PROLOGUE):
        assert src.count(part) == 1, part
    no_fma = src.replace(FMA, "      if (a.M < 0)\n" + FMA)
    return {
        "no fake-quant arithmetic": src.replace(
            OUT, OUT + "  if (a.M > 0) {\n    for (int i = 0; i < EPP; ++i)"
            " out[i * a.bm] = f[i];\n    return;\n  }\n"),
        "no conversion": src.replace(
            CONVERT, CONVERT.replace("if (", "if (a.M < 0 && ")),
        "no FMAs": no_fma,
        "loads and conversion only": no_fma.replace(
            EPILOGUE, EPILOGUE.replace("if (", "if (a.M < 0 && ")),
        "the first slice only": src.replace(
            PROLOGUE, "  if (a.M > 0) return;\n" + PROLOGUE),
        "an empty kernel": src.replace(
            START, START + "  if (a.M > 0) return;\n"),
    }


def build_variants():
    """Each ablated source built with the port's nvcc flags, all at once;
    returns {name: launch function}."""
    with open(os.path.join(build.CSRC, "qmatmul_f32.cu")) as f:
        srcs = variants(f.read())
    out_dir = os.path.join(build.BUILD_DIR, "k4_ablation")
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
        fn = ctypes.CDLL(lib).qmatmul_f32_launch
        fn.argtypes = KM._f32_lib().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _direct(x, w, b, alpha, plan, y, fn=None):
    """One K4 launch with a given plan (no wrapper checks), through ``fn``
    (a build's launch function; the kernel's own by default)."""
    call = KM._k4_call(x.shape[0], x.shape[1], w.shape[1],
                       x.dtype == torch.bfloat16, 4, plan)
    rc = kernels.on_device(
        x.get_device(), fn or KM._f32_lib(), x.data_ptr(), w.data_ptr(),
        b.data_ptr(), alpha.data_ptr(), 0.0, y.data_ptr(), call)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError_t {rc} ({plan})")


def _host_us(fn, calls=200):
    """Host time per call in microseconds: ``calls`` calls enqueued back to
    back on the host clock, the synchronise outside the timed region."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k4_timing: no CUDA device; nothing was run")
    print(gpu_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    KM._f32_lib()
    for line in _ptxas_lines(build.build_log.get("qmatmul_f32.cu")):
        print(f"[k4] ptxas: {line}", flush=True)
    ablated = build_variants() if args.ablate else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    alpha = torch.tensor(1.0, device=dev)
    for batch, dt in ((N_BATCH, torch.float32), (S2D_BATCH, torch.bfloat16)):
        tot = dict(k4=0.0, k4_dev=0.0, lib=0.0, lib_dev=0.0, bound=0.0)
        for name, per_patch, k, n in ONE_BY_ONE:
            m = per_patch * batch
            x = (torch.randn(m, k, device=dev, generator=gen) * 0.7).to(dt)
            w = torch.randn(k, n, device=dev, generator=gen) * 0.1
            b = torch.randn(n, device=dev, generator=gen)
            a4 = (x, w, b, alpha, 4)
            got = KM.fused_qact_matmul(*a4)
            ref = KM.fused_qact_matmul_reference(*a4)
            err = float((got - ref).abs().max())
            tol = 1e-5 * float(ref.abs().max())
            if not err <= tol:
                sys.exit(f"K4 at {name} B={batch}: max |diff| {err} > {tol}")
            xq = fake_quant_act(x, alpha, 4)
            rounds = [(_median_ms(lambda: KM.fused_qact_matmul(*a4)),
                       _graph_ms(lambda: KM.fused_qact_matmul(*a4)))
                      for _ in range(args.rounds)]
            tk = statistics.median(r[0] for r in rounds)
            gk = statistics.median(r[1] for r in rounds)
            tl = _median_ms(lambda: torch.addmm(b, xq, w))
            gl = _graph_ms(lambda: torch.addmm(b, xq, w))
            bound, by = _bound(x.element_size() * m * k + 4 * k * n + 4 * n
                               + 4 * m * n, 2 * m * k * n, FP32_OPS)
            plan = KM._k4_plan(m, k, n, dt == torch.bfloat16)
            hk = _host_us(lambda: KM.fused_qact_matmul(*a4))
            hl = _host_us(lambda: torch.addmm(b, xq, w))
            for key, v in (("k4", tk), ("k4_dev", gk), ("lib", tl),
                           ("lib_dev", gl), ("bound", bound)):
                tot[key] += v
            spread = "/".join(f"{min(r[i] for r in rounds):.4f}"
                              f"-{max(r[i] for r in rounds):.4f}"
                              for i in (0, 1))
            print(f"[k4] {name} B={batch} {dt} M={m} K={k} N={n}: K4 "
                  f"{tk:.4f} ms, device {gk:.4f} ms (min-max per call/device "
                  f"over {args.rounds} rounds {spread}); addmm {tl:.4f} ms, "
                  f"device {gl:.4f} ms; bound {bound:.4f} ms ({by}, "
                  f"{bound / gk:.1%} of it as device time); max |diff| "
                  f"{err:.3e}; plan nc={plan.nc} rn={plan.rn} "
                  f"bm={plan.bm} grid={plan.grid} smem={plan.smem}; "
                  f"host us "
                  f"per call enqueued back to back: K4 {hk:.1f}, addmm "
                  f"{hl:.1f}", flush=True)
            if args.sweep:
                y = torch.empty(m, n, device=dev)
                for key, cand in sorted(KM._k4_candidates(
                        m, k, n, dt == torch.bfloat16), key=lambda c: c[0]):
                    g = _graph_ms(lambda: _direct(x, w, b, alpha, cand, y))
                    mark = " <- plan" if cand == plan else ""
                    print(f"[k4]   nc={cand.nc} rn={cand.rn} "
                          f"bm={cand.bm} grid={cand.grid} smem={cand.smem}: "
                          f"device {g:.4f} ms (model {key[0]:.0f}){mark}",
                          flush=True)
                del y
            if ablated:
                y = torch.empty(m, n, device=dev)
                parts = "; ".join(
                    f"{what} {_graph_ms(lambda: _direct(x, w, b, alpha, plan, y, fn)):.4f}"
                    for what, fn in ablated.items())
                print(f"[k4]   ablation, device ms: full {gk:.4f}; {parts}",
                      flush=True)
                del y
            if name == ONE_BY_ONE[-1][0]:  # the host's share of a K4 call
                y = torch.empty(m, n, device=dev)
                print(f"[k4] host us per call: the bare launch (ctypes) "
                      f"{_host_us(lambda: _direct(x, w, b, alpha, plan, y)):.1f}"
                      f", torch.empty of y "
                      f"{_host_us(lambda: torch.empty(m, n, device=dev)):.1f}",
                      flush=True)
                del y
            del x, w, b, xq, got, ref
        print(f"[k4] six convs B={batch} {dt}: K4 {tot['k4']:.4f} ms per "
              f"call, device {tot['k4_dev']:.4f} ms (host per call "
              f"{tot['k4'] - tot['k4_dev']:.4f} ms); addmm {tot['lib']:.4f} "
              f"ms, device {tot['lib_dev']:.4f} ms; bound {tot['bound']:.4f} "
              f"ms ({tot['bound'] / tot['k4_dev']:.1%} of it)", flush=True)


if __name__ == "__main__":
    main()
