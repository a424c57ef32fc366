#!/usr/bin/env python3
"""Smoke run of the PyTorch port's int8 serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own lines:

0. setup: the card (as nvidia-smi names it), torch / CUDA / nvcc versions,
   and the K1 build (efficientq_tpu_torch/csrc/qconv3d_int8.cu, nvcc for
   sm_90a) with its build seconds;
1. K1 against its plain PyTorch version on the card, at every conv shape
   and epilogue of the flagship BraTS net (N = 2, 128^3 patches) and at
   dilation 1 and 2: outputs must be identical (torch.equal); then the
   kernel's and the plain version's times (median of 20 launches after 3
   warm-up launches);
2. the serving slice at full width: the BraTS W4A4 preset with weights
   from ``--seed``, BN folded, post-PTQ weights emulated (projected onto
   the alpha grid, alpha_act = 1), exported and reloaded as an int8
   checkpoint, deployed to the fused int8 graph, and 3 synthetic BraTS
   volumes (155 x 240 x 240, 4 modalities) served with 128^3 patches at
   overlap 16, patch batch 2, final head, multilabel hard prediction.
   K1 must have launched 14 times per patch-batch forward; the first
   volume's prediction must match a run with the plain K1 on the card;
   Dice per class against the synthetic labels must be finite.

Then one JSON line describing each kernel of the path, the card's
nvidia-smi line, and the result line.  With no CUDA device, or when any
phase fails, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

K1_SOURCE = "efficientq_tpu_torch/csrc/qconv3d_int8.cu"
K1_REPLACES = "efficientq_tpu/pallas/qconv3d.py:439"
# flagship BraTS stages at a 128^3 patch (init stride 2): (extent, width)
STAGES = [(64, 32), (32, 64), (16, 128), (8, 256), (16, 128), (32, 64),
          (64, 32)]
N_BATCH = 2
VOL_SHAPE = (155, 240, 240)
PATCH, OVERLAP = (128, 128, 128), (16, 16, 16)
AGREE_MIN = 0.9999


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def setup():
    from efficientq_tpu_torch.kernels import build, qconv3d

    smi = gpu_line()
    print(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[setup] python {sys.version.split()[0]}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}  nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    qconv3d._lib()
    print(f"[setup] built K1 ({K1_SOURCE}, sm_90a) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return smi


def _median_ms(fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def phase1(seed: int):
    """K1 against its plain version: bit-exact at every flagship conv
    shape and epilogue, dilation 1 and 2; times at the 14 convs of one
    forward.  Returns (max |difference|, kernel ms, plain ms) over the
    forward's 14 convs."""
    from efficientq_tpu_torch.kernels import qconv3d as K
    from efficientq_tpu_torch.quant import act_codes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    one = torch.tensor(1.0, device=dev)

    def conv_inputs(s, c, per_channel=False):
        x = torch.randn(N_BATCH, s, s, s, c, device=dev, generator=gen)
        w = (2 * torch.randint(0, 4, (3, 3, 3, c, c), device=dev,
                               generator=gen) - 3).to(torch.int8)
        scale = (torch.rand(c, device=dev, generator=gen) * 0.05
                 if per_channel else torch.tensor(0.05, device=dev))
        return dict(x=x, w=w, b=torch.randn(c, device=dev, generator=gen),
                    scale=scale,
                    res=torch.randn(N_BATCH, s, s, s, c, device=dev,
                                    generator=gen))

    def variants(inp, encoder):
        """The epilogue combinations of the fused graph, plus none."""
        qa = act_codes(inp["x"], one, 4)
        return {
            "none": (inp["x"], {}),
            "block1 (quant)": (inp["x"], dict(quant_alpha=one, quant_qlvl=4)),
            "block2 (codes+residual+relu" + ("+pool)" if encoder else ")"): (
                qa, dict(x_quantized=True, residual=inp["res"],
                         residual_relu=True, pool=encoder)),
        }

    max_err = 0.0

    def compare(label, x, inp, kw, dil):
        nonlocal max_err
        args = (x, inp["w"], inp["b"], one, inp["scale"], 4)
        got = K.qconv3x3_int8_ndhwc(*args, dilation=dil, **kw)
        ref = K.qconv3x3_int8_ndhwc_reference(*args, dilation=dil, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            err = float((g.float() - r.float()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(g, r):
                ulp = _max_ulp(g, r) if g.dtype == torch.float32 else "n/a"
                raise SmokeFailure(f"K1 != plain at {label} dil={dil}: max "
                                   f"|diff| {err}, max ulp {ulp}")

    total_k = total_p = 0.0
    checked = 0
    seen = set()
    for i, (s, c) in enumerate(STAGES):
        encoder = i < len(STAGES) // 2
        inp = conv_inputs(s, c)
        geo = (s, c, encoder)
        for name, (x, kw) in variants(inp, encoder).items():
            for dil in ((1, 2) if geo not in seen else (1,)):
                compare(f"stage{i + 1} {s}^3x{c} {name}", x, inp, kw, dil)
                checked += 1
        seen.add(geo)
        for name, (x, kw) in list(variants(inp, encoder).items())[1:]:
            args = (x, inp["w"], inp["b"], one, inp["scale"], 4)
            qa = x if kw.get("x_quantized") else act_codes(x, one, 4)
            kw_q = dict(kw, x_quantized=True)  # time the conv, not the prologue
            tk = _median_ms(lambda: K.qconv3x3_int8_ndhwc(
                qa, *args[1:], **kw_q))
            tp = _median_ms(lambda: K.qconv3x3_int8_ndhwc_reference(
                qa, *args[1:], **kw_q))
            total_k += tk
            total_p += tp
            print(f"[phase1] stage{i + 1} N={N_BATCH} {s}^3 C=O={c} {name}: "
                  f"K1 {tk:.4f} ms  plain {tp:.4f} ms  ({tp / tk:.2f}x)",
                  flush=True)
        del inp
    # per-channel scale, odd extents (VALID pool, masked cells) and a
    # channel count that is not a multiple of 4 (the kernel's scalar tail)
    for s, c, dil in ((64, 32, 1), (9, 8, 2), (7, 3, 1)):
        inp = conv_inputs(s, c, per_channel=True)
        for name, (x, kw) in variants(inp, True).items():
            compare(f"per-channel {s}^3x{c} {name}", x, inp, kw, dil)
            checked += 1
    print(f"[phase1] {checked} comparisons: K1 == plain (torch.equal) "
          f"everywhere; one forward's 14 convs: K1 {total_k:.4f} ms, plain "
          f"{total_p:.4f} ms", flush=True)
    return max_err, total_k, total_p


def build_net(seed: int):
    """BraTS W4A4 preset, BN folded, post-PTQ weights emulated, exported
    as an int8 checkpoint, reloaded and deployed."""
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.kernels.build import BUILD_DIR
    from efficientq_tpu_torch.models import build_uresq, preset_config
    from efficientq_tpu_torch.models import torch_io
    from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
    from efficientq_tpu_torch.quant import fake_quant_weight, pack_int_weight

    cfg = preset_config("brats", quantize=True)
    graph = build_uresq(cfg)
    fgraph, fvars = fold_bn(graph, nnir.init(graph, seed))
    for node in fgraph.qconv_nodes():
        qcfg = node.attrs["qcfg"]
        p = fvars["params"][node.name]
        if qcfg.q_weight:
            alpha = torch.clamp_min(p["kernel"].abs().max(), 1e-8)
            p["kernel"] = fake_quant_weight(p["kernel"], alpha, qcfg.qlvl_w)
            p["alpha_w"] = alpha
        if qcfg.q_act:
            p["alpha_act"] = torch.tensor(1.0)
    # the PTQ export format: packed integer weight codes in an npz
    sd = torch_io.to_torch_state_dict(fgraph, fvars)
    for node in fgraph.qconv_nodes():
        if node.attrs["qcfg"].q_weight:
            sd[f"{node.name}.weight"] = pack_int_weight(
                sd[f"{node.name}.weight"], sd[f"{node.name}.alpha_w"],
                node.attrs["qcfg"].qlvl_w)
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, "smoke_state_in_int8_compress.npz")
    np.savez_compressed(path, state_dict=sd)
    fresh = nnir.init(graph, seed + 1)  # overwritten by the export
    _, fresh = fold_bn(graph, fresh)
    lvars = torch_io.load_int8_checkpoint(fgraph, fresh, path)
    os.remove(path)
    dgraph, dvars = to_int8_inference(fgraph, lvars)
    n_k1 = sum(1 for n in dgraph.nodes if n.attrs.get("pallas"))
    n_int8 = sum(1 for n in dgraph.nodes if n.attrs.get("int8"))
    print(f"[phase2] BraTS W4A4 preset: {n_int8} convs on the int8 path, "
          f"{n_k1} on K1", flush=True)
    check(n_k1 == 14, f"expected 14 K1 convs, got {n_k1}")
    return dgraph, nnir.GraphModule(dgraph, dvars, mode="quantized")


def phase2(seed: int):
    from efficientq_tpu_torch.data.labels import split_label_brats
    from efficientq_tpu_torch.data.synthetic import make_subject
    from efficientq_tpu_torch.eval.metrics import dice
    from efficientq_tpu_torch.eval.sliding import (make_volume_inferencer,
                                                   patch_grid)
    from efficientq_tpu_torch.kernels import qconv3d as K

    dev = torch.device("cuda")
    dgraph, net = build_net(seed)
    net = net.to(dev)
    variables = net.variables

    t0 = time.perf_counter()
    subjects = [make_subject(np.random.default_rng(seed + 100 + i), "brats",
                             VOL_SHAPE) for i in range(3)]
    vols = [torch.from_numpy(np.stack(list(img.values()), axis=-1)[None])
            for img, _ in subjects]
    print(f"[phase2] 3 synthetic BraTS volumes {VOL_SHAPE} x 4 modalities "
          f"made in {time.perf_counter() - t0:.1f} s", flush=True)

    n_patches = len(patch_grid(VOL_SHAPE, PATCH, OVERLAP))
    forwards = -(-n_patches // 2)
    kw = dict(patch_batch=2, mode="quantized", heads=slice(-1, None),
              hard_pred=True, multilabel=True)
    infer = make_volume_inferencer(dgraph, **kw)
    preds, secs = [], []
    torch.cuda.synchronize()
    K.qconv3x3_int8_ndhwc.launches = 0
    for vol in vols:
        t0 = time.perf_counter()
        pred = infer(variables, vol.to(dev), PATCH, OVERLAP)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        preds.append(pred)
    launches = K.qconv3x3_int8_ndhwc.launches
    print(f"[phase2] K1 launches {launches} over {3 * forwards} patch-batch "
          f"forwards ({n_patches} patches per volume, batch 2)", flush=True)
    check(launches == 14 * 3 * forwards,
          f"K1 launched {launches} times, expected {14 * 3 * forwards}")
    vps = 2 / (secs[1] + secs[2])
    print(f"[phase2] seconds per volume {[round(s, 4) for s in secs]}; "
          f"volumes/s over volumes 2-3: {vps:.4f}", flush=True)

    for i, (pred, (_, label)) in enumerate(zip(preds, subjects)):
        check(tuple(pred.shape) == (1, 1, *VOL_SHAPE, 3)
              and pred.dtype == torch.uint8 and int(pred.max()) <= 1,
              f"volume {i + 1}: prediction {tuple(pred.shape)} {pred.dtype}")
        p = pred[0, 0].cpu().numpy()
        target = split_label_brats(label)
        d = [dice(p[..., c], target[c]) for c in range(3)]
        check(all(np.isfinite(d)), f"volume {i + 1}: Dice {d}")
        print(f"[phase2] volume {i + 1} Dice WT/TC/ET vs synthetic labels: "
              f"{[round(x, 6) for x in d]}", flush=True)

    # the same serving run with the plain K1 on the card (launches no K1)
    plain = make_volume_inferencer(
        dgraph, conv3x3_int8=K.qconv3x3_int8_ndhwc_reference, **kw)
    ref = plain(variables, vols[0].to(dev), PATCH, OVERLAP)
    same = int((ref == preds[0]).sum())
    frac = same / ref.numel()
    print(f"[phase2] volume 1, K1 vs plain K1: {same} of {ref.numel()} "
          f"voxel-classes agree ({frac:.8f})", flush=True)
    check(frac >= AGREE_MIN, f"agreement {frac} < {AGREE_MIN}")

    # logits of one patch batch are finite and of the expected shape
    with torch.inference_mode():
        x = vols[0][:, :128, :128, :128].to(dev).expand(2, -1, -1, -1, -1)
        logits = net(x.contiguous(), heads=slice(-1, None))
    check(tuple(logits.shape) == (1, 2, 128, 128, 128, 3)
          and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} not finite")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    smi = setup()
    max_err, ms, plain_ms = phase1(args.seed)
    launches = phase2(args.seed)
    print(json.dumps({"kernels": [{
        "name": "qconv3x3_int8_ndhwc", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
