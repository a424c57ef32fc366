#!/usr/bin/env python3
"""K2 alone at the flagship's stem shape, on one NVIDIA GPU.

    python3 scripts/k2_timing.py [--sweep] [--ablate] [--rounds N]

Builds ``efficientq_tpu_torch/csrc/stem_s2d.cu`` and runs K2
(``kernels/stem.py::stem_s2d_conv``, weights packed once as the deployment
packs them, alpha on the card) on the s2d patches of ``chip_smoke.py``
phase 3: the B = 8 patches of a random 155 x 240 x 240 x 4 BraTS volume
(both z parities), C8 = O = 32.  It checks K2 against its plain version
with bfloat16 and float32 output (``chip_smoke._check_stem``), prints the
plan of ``_k2_plan``, K2's time per call (events around one call, the
host's time included, median of 20) and as device time (10-call CUDA
graphs replayed), the same two for cuDNN's bf16 stride-2 conv with bias on
the raw 128^3 x 4 patches, and the bound (bytes over 3.35 TB/s against
multiply-adds over the bf16 tensor-core peak) with K2's share of it.
``--rounds N`` repeats the K2 timings N times and prints min / median /
max.  ``--sweep`` also times, as device time, every tiling of
``_k2_candidates``, marking the plan's own.  ``--ablate`` also builds the
kernel with parts of its work skipped (runtime-false guards, so the rest
compiles as it is) and times each build as device time with the plan's
tiling: without the plane loads past the first fill of the ring, without
the mma steps, without the quantization, without the stores, and as an
empty kernel (the launch alone).  The ablated builds compute wrong
outputs: they only time the parts.  One more build stages each plane's
outputs through shared memory and copies them out with 16-byte stores;
its outputs are checked equal to K2's and both are timed at every
tiling.  Prints the card's nvidia-smi line
first, then ptxas's registers and spills of each K2 build.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (BF16_OPS, OVERLAP, PATCH, VOL_SHAPE,  # noqa: E402
                        _bound, _check_stem, _graph_ms, _median_ms,
                        _ptxas_lines, gpu_line, k2_cost, k2_plan_line,
                        stem_inputs)
from efficientq_tpu_torch.kernels import build  # noqa: E402
from efficientq_tpu_torch.kernels import stem  # noqa: E402

START = "  extern __shared__ __align__(128) char smem[];\n"
LOAD = "    if (i + 2 <= nz)\n"
MMA = ("              mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],"
       "\n")
QUANT = "              codes[k >> 2] |= static_cast<uint32_t>(code_of(y, q))\n"
STORE = "            const long long e0 = (out_plane + m) * a.O + o0;\n"
# the staged-store build: each lane's 8 channels go to a [voxel][O] tile in
# shared memory past the ring, copied out with 16-byte stores after each
# plane (O a multiple of 32 only)
KERNEL_END = "    }\n  }\n}\n\nint align"
SMEM = ("  const long long smem = a.off_ring + static_cast<long long>(SLOTS) *"
        "\n                                          a.slot_bytes;\n")
STAGE_WRITE = """\
            {
              char* st = smem + a.off_ring + SLOTS * a.slot_bytes;
              const int elt = a.out_bf16 ? 2 : 4;
              const int e = m * a.op + o0;
              if (a.out_bf16) {
                *reinterpret_cast<uint4*>(st + e * 2) =
                    make_uint4(bits[0], bits[1], bits[2], bits[3]);
              } else {
                float4* sp = reinterpret_cast<float4*>(st + e * 4);
                sp[0] = make_float4(v[0], v[1], v[2], v[3]);
                sp[1] = make_float4(v[4], v[5], v[6], v[7]);
              }
              *reinterpret_cast<uint2*>(st + band_vox * a.op * elt + e) =
                  make_uint2(codes[0], codes[1]);
              continue;
            }
"""
STAGE_COPY = """\
    }
    __syncthreads();
    {
      char* st = smem + a.off_ring + SLOTS * a.slot_bytes;
      const int elt = a.out_bf16 ? 2 : 4;
      const int ny = store_vox * a.O * elt / 16, nq = store_vox * a.O / 16;
      uint4* gy = reinterpret_cast<uint4*>(static_cast<char*>(a.y) +
                                           out_plane * a.O * elt);
      uint4* gq = reinterpret_cast<uint4*>(a.q + out_plane * a.O);
      const uint4* sy = reinterpret_cast<const uint4*>(st);
      const uint4* sq =
          reinterpret_cast<const uint4*>(st + band_vox * a.op * elt);
      for (int e = tid; e < ny; e += THREADS) gy[e] = sy[e];
      for (int e = tid; e < nq; e += THREADS) gq[e] = sq[e];
    }
  }
}

int align"""


def staged(src: str) -> str:
    """The staged-store source (right outputs where O % 32 == 0)."""
    for part in (STORE, KERNEL_END, SMEM):
        assert src.count(part) == 1, part
    return (src.replace(STORE, STAGE_WRITE + STORE)
            .replace(KERNEL_END, STAGE_COPY)
            .replace(SMEM, SMEM.replace(
                "a.slot_bytes;", "a.slot_bytes +\n"
                "      static_cast<long long>(a.rows) * W * a.op * "
                "(a.out_bf16 ? 3 : 5);")))


STAGED = "staged stores"


def variants(src: str):
    """The ablated sources of ``--ablate`` (runtime-false guards)."""
    for part in (START, LOAD, MMA, QUANT, STORE):
        assert src.count(part) == 1, part
    return {
        "no plane loads past the ring fill": src.replace(
            LOAD, LOAD.replace("if (", "if (a.D < 0 && ")),
        "no mma": src.replace(MMA, "              if (a.D < 0) "
                              + MMA.lstrip()),
        "no quantization": src.replace(QUANT, "              if (a.D < 0) "
                                       + QUANT.lstrip()),
        "no stores": src.replace(STORE, "            if (a.D > 0) continue;\n"
                                 + STORE),
        "an empty kernel": src.replace(
            START, START + "  if (a.D > 0) return;\n"),
        STAGED: staged(src),
    }


def build_variants():
    """Each ablated source built with the port's nvcc flags, all at once;
    returns {name: launch function}."""
    with open(os.path.join(build.CSRC, "stem_s2d.cu")) as f:
        srcs = variants(f.read())
    out_dir = os.path.join(build.BUILD_DIR, "k2_ablation")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        path = os.path.join(out_dir, name.replace(" ", "_"))
        with open(path + ".cu", "w") as f:
            f.write(src)
        procs[name] = (path + ".so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", path + ".so",
             path + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} build:\n{log}")
        for line in _ptxas_lines(log):
            if line.startswith("k-steps 2 (0: run time), bf16"):
                print(f"[k2] ptxas ({name}): {line}", flush=True)
        fn = ctypes.CDLL(lib).stem_s2d_launch
        fn.argtypes = stem._lib().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _direct(fn, x, par, wp, bias, alpha, y, q, call):
    """One launch through ``fn`` (a build's launch function) into y, q."""
    rc = fn(x.data_ptr(), par.data_ptr(), wp.data_ptr(), bias.data_ptr(),
            alpha.data_ptr(), 0.0, y.data_ptr(), q.data_ptr(), call,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {rc}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k2_timing: no CUDA device; nothing was run")
    torch.backends.cudnn.allow_tf32 = False
    print(gpu_line(), flush=True)
    stem._lib()
    for line in _ptxas_lines(build.build_log.get("stem_s2d.cu")):
        print(f"[k2] ptxas: {line}", flush=True)
    ablated = build_variants() if args.ablate else {}
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    c, o = 4, 32
    x, par, we, wo, bias = stem_inputs(gen, args.seed, VOL_SHAPE, c, o, PATCH,
                                       OVERLAP)
    alpha = torch.tensor(1.0, device=dev)
    wp = stem.pack_stem_weights(we, wo)
    a2 = (x, par, we, wo, bias, alpha, 4)
    for dt in (bf16, torch.float32):
        y, q = stem.stem_s2d_conv(*a2, out_dtype=dt, w_packed=wp)
        yr, qr = stem.stem_s2d_conv_reference(*a2, out_dtype=dt)
        torch.cuda.synchronize()
        err, excused = _check_stem(f"flagship {dt}", y, q, yr, qr, 1.0, 4)
        print(f"[k2] flagship B={x.shape[0]} {tuple(x.shape[1:])} -> {o}, "
              f"out {dt}: within tolerance of plain (max |diff| {err:.3e}, "
              f"{excused} codes apart at ties or roundings); plan "
              f"{k2_plan_line(x, o, dt.itemsize)}", flush=True)
        del y, q, yr, qr

    def k2():
        return stem.stem_s2d_conv(*a2, out_dtype=bf16, w_packed=wp)

    rounds = [(_median_ms(k2), _graph_ms(k2)) for _ in range(args.rounds)]
    tk = statistics.median(r[0] for r in rounds)
    gk = statistics.median(r[1] for r in rounds)
    xl = torch.randn(x.shape[0], *PATCH, c, device=dev,
                     generator=gen).to(bf16).permute(0, 4, 1, 2, 3)
    wl = torch.randn(o, c, 3, 3, 3, device=dev, generator=gen, dtype=bf16)
    bl = torch.randn(o, device=dev, generator=gen, dtype=bf16)

    def cudnn():
        return F.conv3d(xl, wl, bl, stride=2, padding=1)

    tl, gl = _median_ms(cudnn), _graph_ms(cudnn)
    nbytes, macs = k2_cost(x, o)
    bound, by = _bound(nbytes, 2 * macs, BF16_OPS)
    spread = "/".join(f"{min(r[i] for r in rounds):.4f}"
                      f"-{max(r[i] for r in rounds):.4f}" for i in (0, 1))
    print(f"[k2] flagship bf16 out: K2 {tk:.4f} ms per call, device "
          f"{gk:.4f} ms (min-max per call/device over {args.rounds} rounds "
          f"{spread}); cuDNN {tl:.4f} ms, device {gl:.4f} ms; bound "
          f"{bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {macs / 1e9:.2f} G "
          f"multiply-adds; {bound / gk:.1%} of it as device time, "
          f"{nbytes / gk / 1e6:.0f} GB/s); K2 / cuDNN per call "
          f"{tk / tl:.2f}, device {gk / gl:.2f}", flush=True)

    b, d1, h, w, c8 = x.shape
    y = torch.empty((b, d1 - 1, h, w, o), dtype=bf16, device=dev)
    q = torch.empty((b, d1 - 1, h, w, o), dtype=torch.int8, device=dev)
    plan = stem._k2_plan(b, d1 - 1, h, w, c8, o)
    if args.sweep:
        for key, cand in sorted(stem._k2_candidates(b, d1 - 1, h, w, c8, o),
                                key=lambda k: k[0]):
            call = stem._k2_call(b, d1 - 1, h, w, c8, o, 4, True, cand)
            g = _graph_ms(lambda: _direct(stem._lib(), x, par, wp, bias,
                                          alpha, y, q, call))
            mark = " <- plan" if cand == plan else ""
            print(f"[k2]   rows={cand.rows} zc={cand.zc} grid={cand.grid} "
                  f"smem={cand.smem}: device {g:.4f} ms (model "
                  f"{key[0]:.0f}){mark}", flush=True)
    if ablated:
        call = stem._k2_call(b, d1 - 1, h, w, c8, o, 4, True)
        parts = "; ".join(
            f"{what} {_graph_ms(lambda: _direct(fn, x, par, wp, bias, alpha, y, q, call)):.4f}"  # noqa: E501
            for what, fn in ablated.items())
        print(f"[k2] ablation, device ms: full {gk:.4f}; {parts}", flush=True)
        # the staged stores against the quad-transposed ones: same bits,
        # and device time at every tiling (staging takes shared memory
        # that can cost the second block of an SM)
        fn = ablated[STAGED]
        y2, q2 = torch.empty_like(y), torch.empty_like(q)
        for cand in sorted((c for _, c in stem._k2_candidates(
                b, d1 - 1, h, w, c8, o)), key=lambda c: (c.rows, c.zc)):
            call = stem._k2_call(b, d1 - 1, h, w, c8, o, 4, True, cand)
            try:
                _direct(stem._lib(), x, par, wp, bias, alpha, y, q, call)
                _direct(fn, x, par, wp, bias, alpha, y2, q2, call)
            except RuntimeError as e:  # its shared memory does not fit
                print(f"[k2]   staged rows={cand.rows} zc={cand.zc}: {e}",
                      flush=True)
                continue
            torch.cuda.synchronize()
            same = torch.equal(y, y2) and torch.equal(q, q2)
            g2 = _graph_ms(lambda: _direct(fn, x, par, wp, bias, alpha, y2,
                                           q2, call))
            g1 = _graph_ms(lambda: _direct(stem._lib(), x, par, wp, bias,
                                           alpha, y, q, call))
            print(f"[k2]   rows={cand.rows} zc={cand.zc}: transposed "
                  f"stores {g1:.4f} ms, staged stores {g2:.4f} ms "
                  f"(outputs {'equal' if same else 'DIFFER'})", flush=True)


if __name__ == "__main__":
    main()
