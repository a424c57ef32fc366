#!/usr/bin/env python3
"""K3 alone at the flagship's 1x1 shapes, on one NVIDIA GPU.

    python3 scripts/k3_timing.py [--sweep] [--ablate] [--rounds N]

Builds ``efficientq_tpu_torch/csrc/qmatmul_int8.cu`` and runs K3
(``kernels/qmatmul.py::fused_int8_matmul``, weights packed once as the
deployment packs them) at the twelve shapes of ``chip_smoke.py`` phase 5:
the six transition 1x1 convs of the BraTS net at B = 2 patches with
float32 x and B = 8 with bfloat16 x, per-tensor scale on the card.  At each
shape it checks K3 against its plain version (torch.equal) and prints the
plan of ``_k3_plan``, K3's time per call (events around one call, the
host's time included, median of 20) and as device time (CUDA graph
replay), the same two for ``torch._int_mm`` on the codes (int32 out, no
quantization or epilogue), and the bound (bytes over 3.35 TB/s against
operations over the 1,979 TOP/s int8 peak).  ``--rounds N`` repeats the
K3 timings N times and prints min / median / max.  ``--sweep`` also
times, as device time, every tiling of ``_k3_candidates`` at each shape
(the tuning loop of the plan, whose cost constants ``qmatmul._K3_*`` were
set from these times), marking the plan's own.  ``--ablate`` also
builds the kernel with parts of its work skipped (runtime-false guards, so
the rest compiles as it is) and times each build as device time with the
plan's tiling: without the loads of x past the first ring of slices,
without the quantization of x, without the mma steps, without the stores
of y, and as an empty kernel (the launch alone); and one build that stores
y with streaming stores (``__stcs``, right outputs).  The ablated builds
compute wrong outputs: they only time the parts.  Prints
the card's nvidia-smi line first, then ptxas's registers and spills of
each K3 build.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (INT8_OPS, N_BATCH, ONE_BY_ONE, S2D_BATCH,  # noqa: E402
                        _bound, _graph_ms, _int_mm_call, _median_ms,
                        _ptxas_lines, gpu_line)
from efficientq_tpu_torch import kernels  # noqa: E402
from efficientq_tpu_torch.kernels import build  # noqa: E402
from efficientq_tpu_torch.kernels import qmatmul as KM  # noqa: E402
from efficientq_tpu_torch.quant import act_codes  # noqa: E402

START = "  extern __shared__ __align__(128) char smem[];\n"
QUANTIZE = "    for (int e = tid; e < pieces; e += THREADS)\n"
MMA = ("          for (int u = 0; u < MT; ++u) "
       "mma_s8(acc[u][v], af[u], b0, b1);\n")
STORE = "    const bool pairs = (a.N % 2) == 0;\n"
LOAD = "    if (i + a.stages < my_tiles)\n"
FLOAT2 = ("            *reinterpret_cast<float2*>(row + n) = "
          "make_float2(val[0], val[1]);\n")


def variants(src: str):
    """The ablated sources of ``--ablate`` (runtime-false guards)."""
    for part in (START, QUANTIZE, MMA, STORE, LOAD, FLOAT2):
        assert src.count(part) == 1, part
    return {
        "no x loads past the ring": src.replace(
            LOAD, LOAD.replace("if (", "if (a.M < 0 && ")),
        "streaming y stores (st.global.cs)": src.replace(
            FLOAT2, "            __stcs(reinterpret_cast<float2*>(row + n), "
            "make_float2(val[0], val[1]));\n"),
        "no quantization": src.replace(
            QUANTIZE, QUANTIZE.replace("e < pieces", "a.M < 0 && e < pieces")),
        "no mma": src.replace(
            MMA, MMA.replace("u < MT;", "a.M < 0 && u < MT;")),
        "no stores of y": src.replace(
            STORE, "    if (a.M > 0) continue;\n" + STORE),
        "an empty kernel": src.replace(
            START, START + "  if (a.M > 0) return;\n"),
    }


def build_variants():
    """Each ablated source built with the port's nvcc flags, all at once;
    returns {name: launch function}."""
    with open(os.path.join(build.CSRC, "qmatmul_int8.cu")) as f:
        srcs = variants(f.read())
    out_dir = os.path.join(build.BUILD_DIR, "k3_ablation")
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
        fn = ctypes.CDLL(lib).qmatmul_int8_launch
        fn.argtypes = KM._int8_lib().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _direct(x, wp, n, b, alpha, scale, plan, y, fn=None):
    """One K3 launch with a given plan (no wrapper checks), through ``fn``
    (a build's launch function; the kernel's own by default)."""
    call = KM._k3_call(x.shape[0], x.shape[1], n, x.dtype == torch.bfloat16,
                       4, plan)
    rc = kernels.on_device(
        x.get_device(), fn or KM._int8_lib(), x.data_ptr(), wp.data_ptr(),
        scale.data_ptr(), 0.0, 0, b.data_ptr(), alpha.data_ptr(), 0.0,
        y.data_ptr(), call)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError_t {rc} ({plan})")


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
        sys.exit("k3_timing: no CUDA device; nothing was run")
    print(gpu_line(), flush=True)
    KM._int8_lib()
    for line in _ptxas_lines(build.build_log.get("qmatmul_int8.cu")):
        print(f"[k3] ptxas: {line}", flush=True)
    ablated = build_variants() if args.ablate else {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    alpha = torch.tensor(1.0, device=dev)
    scale = torch.tensor(0.05, device=dev)
    for batch, dt in ((N_BATCH, torch.float32), (S2D_BATCH, torch.bfloat16)):
        tot = dict(k3=0.0, k3_dev=0.0, lib=0.0, lib_dev=0.0, bound=0.0)
        for name, per_patch, k, n in ONE_BY_ONE:
            m = per_patch * batch
            x = (torch.randn(m, k, device=dev, generator=gen) * 0.7).to(dt)
            codes = (2 * torch.randint(0, 4, (k, n), device=dev,
                                       generator=gen) - 3).to(torch.int8)
            b = torch.randn(n, device=dev, generator=gen)
            wp = KM.pack_weights_1x1(codes)
            a3 = (x, codes, b, alpha, scale, 4, wp)
            got = KM.fused_int8_matmul(*a3)
            ref = KM.fused_int8_matmul_reference(*a3)
            if not torch.equal(got, ref):
                sys.exit(f"K3 != plain at {name} B={batch}: max |diff| "
                         f"{float((got - ref).abs().max())}")
            rounds = [(_median_ms(lambda: KM.fused_int8_matmul(*a3)),
                       _graph_ms(lambda: KM.fused_int8_matmul(*a3)))
                      for _ in range(args.rounds)]
            tk = statistics.median(r[0] for r in rounds)
            gk = statistics.median(r[1] for r in rounds)
            int_mm = _int_mm_call(act_codes(x, alpha, 4), codes)
            tl = gl = float("nan")
            if int_mm is not None:
                tl, gl = _median_ms(int_mm), _graph_ms(int_mm)
            bound, by = _bound(x.element_size() * m * k + k * n + 8 * n
                               + 4 * m * n, 2 * m * k * n, INT8_OPS)
            plan = KM._k3_plan(m, k, n, dt == torch.bfloat16)
            hk = _host_us(lambda: KM.fused_int8_matmul(*a3))
            for key, v in (("k3", tk), ("k3_dev", gk), ("lib", tl),
                           ("lib_dev", gl), ("bound", bound)):
                tot[key] += v
            spread = "/".join(f"{min(r[i] for r in rounds):.4f}"
                              f"-{max(r[i] for r in rounds):.4f}"
                              for i in (0, 1))
            print(f"[k3] {name} B={batch} {dt} M={m} K={k} N={n}: K3 "
                  f"{tk:.4f} ms, device {gk:.4f} ms (min-max per call/device "
                  f"over {args.rounds} rounds {spread}); _int_mm {tl:.4f} "
                  f"ms, device {gl:.4f} ms; bound {bound:.4f} ms ({by}, "
                  f"{bound / gk:.1%} of it as device time); plan bm={plan.bm}"
                  f" nc={plan.nc} mt={plan.mt} nt={plan.nt} "
                  f"wn={plan.wn} stages={plan.stages} grid={plan.grid} "
                  f"smem={plan.smem}; host us per call enqueued "
                  f"back to back: K3 {hk:.1f}", flush=True)
            y = torch.empty(m, n, device=dev)
            if args.sweep:
                for key, cand in sorted(KM._k3_candidates(
                        m, k, n, dt == torch.bfloat16), key=lambda c: c[0]):
                    g = _graph_ms(lambda: _direct(x, wp, n, b, alpha, scale,
                                                  cand, y))
                    mark = " <- plan" if cand == plan else ""
                    print(f"[k3]   bm={cand.bm} nc={cand.nc} "
                          f"mt={cand.mt} nt={cand.nt} wn={cand.wn} "
                          f"stages={cand.stages} grid={cand.grid} "
                          f"smem={cand.smem}: device {g:.4f} ms "
                          f"(model {key[0]:.0f}){mark}", flush=True)
            if ablated:
                def part(fn):
                    return _graph_ms(lambda: _direct(x, wp, n, b, alpha,
                                                     scale, plan, y, fn))

                parts = "; ".join(f"{what} {part(fn):.4f}"
                                  for what, fn in ablated.items())
                print(f"[k3]   ablation, device ms: full {gk:.4f}; {parts}",
                      flush=True)
            del x, codes, wp, got, ref, y
        print(f"[k3] six convs B={batch} {dt}: K3 {tot['k3']:.4f} ms per "
              f"call, device {tot['k3_dev']:.4f} ms (host per call "
              f"{tot['k3'] - tot['k3_dev']:.4f} ms); _int_mm {tot['lib']:.4f}"
              f" ms, device {tot['lib_dev']:.4f} ms; bound "
              f"{tot['bound']:.4f} ms ({tot['bound'] / tot['k3_dev']:.1%} of "
              f"it)", flush=True)


if __name__ == "__main__":
    main()
