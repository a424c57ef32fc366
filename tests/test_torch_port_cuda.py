"""The port on a CUDA card: K1 (csrc/qconv3d_int8.cu), K2
(csrc/stem_s2d.cu), K3 (csrc/qmatmul_int8.cu) and K4 (csrc/qmatmul_f32.cu)
against their plain PyTorch versions, and the serving slices of a small net
(int8 float32, s2d bf16, and with the 1x1 convs on K3 or K4) with the
kernels against the same slices with the plain versions.  K1 and K3 must
agree exactly, at float32 and at bfloat16 output and residual: the kernels
accumulate in integers and round their float epilogues as the plain
versions do.  K2 sums bf16
products in float32 on the tensor cores, the plain version in float64:
its float32 output must lie within 1e-4 of max|y|, its bfloat16 output
within one bf16 ulp (or within 1e-4 of max|y| where the value is that
small: at the relu boundary one ulp is tiny), and its int8 codes must be
equal except where the
plain value clip(y/alpha, 0, 1)(n-1) lies within 1e-4 of a .5 tie (or, at
bfloat16, where the two rounded outputs differ).  K4 sums float32 products
with one FMA per term in k order, the plain version in cuBLAS's order (TF32
off): within 1e-5 of max|y|.

The PTQ calibration (``ptq/solver.py``, ``quant.project_by_iter``,
``ptq/engine.py::run_ptq``) runs on cuBLAS and cuSOLVER on the card: its
float32 Grams within 1e-5 of float64 Grams of the same inputs (TF32 would
be about 1e-3 off), the projection within rtol 1e-6 of the CPU's, and a
calibration of a tiny net held against the same calibration on the CPU:
within the tolerances that tests/test_torch_port_ptq.py holds the CPU to
against JAX of one of the outcomes the CPU reaches itself under
rounding-level perturbations.

K1 also at the LiTS preset's 512-channel shapes and at the 16-level grids
of the mixed-precision recipe, and a deployment with offset activation
grids (``act_k``) against its quantized forward.  K1 quantizing a float32
or bfloat16 input itself: equal to the plain version (whose
``act_codes`` quantizes in separate passes) at the nine LiTS block1
shapes, with the residual and pool epilogues, on inputs dense in .5
ties; its codes equal to ``act_codes`` at every grid the kernel takes;
and one call replayed from a CUDA graph.  K1's overlapped pipeline (one
brick's epilogue on warps of their own while the next brick's taps run)
at its plan's edges and at the benchmark's served LiTS and SegResNet
shapes, equal to the plain version, with ``overlapped_launches``
counting the launches that took it.

Training: one train step on the card in exact float32 against the CPU's,
remat and the dropout masks on the card, and ``ops.batch_norm_train``.
The serving loop's upload and readback (``data/prefetch.py::device_feed``,
``eval/validate.py``): the device feed gives the host's batches in order,
uploads on its side stream rather than behind the caller's, and keeps a
pinned staging buffer until its upload has run; ``validate_seg``'s
pipeline gives what serving one volume at a time gives.

The serving extras: the captured inferencers (int8 float32 on the patch
and the column grid, s2d bf16) against the same paths run eagerly, bit for
bit, with the launch counts of the eager paths, and following changed
variables; K1-K4's registered operators against their wrappers (equal);
an artifact exported on the card against the captured path (equal); the
autotuner's sweep and its cache hit.

These tests are marked ``cuda`` and skip without a card.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -m cuda

The K1 cases are shared with test_torch_port_qconv3d.py and the K3/K4
cases with test_torch_port_qmatmul.py, which hold the plain versions
against the JAX package on the CPU.
"""
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from efficientq_tpu_torch import nnir, ops
from efficientq_tpu_torch.data import synthetic
from efficientq_tpu_torch.eval import sliding
from efficientq_tpu_torch.kernels import WRAPPERS
from efficientq_tpu_torch.kernels import qconv3d as K
from efficientq_tpu_torch.kernels import qmatmul as KM
from efficientq_tpu_torch.kernels import stem as K2
from efficientq_tpu_torch.models import UResQConfig, build_uresq
from efficientq_tpu_torch.ptq import deploy, engine, fold_bn, solver
from efficientq_tpu_torch.ptq import to_int8_inference
from efficientq_tpu_torch.quant import fake_quant_weight, project_by_iter

NA = 4  # activation levels (W4A4 preset)

CASES = {
    "plain-c3": dict(c=3),
    "plain-c4-dil2": dict(c=4, dil=2),
    "plain-c8": dict(c=8),
    "quant-c8": dict(c=8, quant=True),
    "quant-c3-dil2": dict(c=3, dil=2, quant=True),
    "residual-c4": dict(c=4, res=True),
    "residual-relu-c8": dict(c=8, res=True, relu=True),
    "pool-even-c4": dict(c=4, pool=True),
    "pool-odd-c4": dict(c=4, pool=True, odd=True),
    "xq-res-relu-pool-c8-dil2": dict(c=8, dil=2, xq=True, res=True,
                                     relu=True, pool=True),
    "xq-c4": dict(c=4, xq=True),
    "per-channel-c8": dict(c=8, per_channel=True),
    "per-channel-res-pool-c3": dict(c=3, per_channel=True, res=True,
                                    pool=True),
}


# K3/K4 cases (M, K, N, x dtype, per-channel scale, bias): sizes the
# kernels' tiles do not divide, both input types, both scale kinds, with
# and without bias
MATMUL_CASES = [
    (70, 12, 20, "f32", False, True),
    (700, 32, 64, "f32", True, True),
    (70, 32, 20, "bf16", True, False),
    (700, 12, 64, "bf16", False, True),
    (70, 12, 64, "f32", True, False),
    (700, 32, 20, "bf16", False, False),
]


def matmul_case(m, k, n, dtype, per_channel, with_bias, seed=0):
    """NumPy inputs of one K3/K4 call: x as float32 (holding bfloat16
    values when ``dtype == "bf16"``), int8 codes, float32 weights."""
    rng = np.random.RandomState(seed + m + k + n)
    x = (np.abs(rng.randn(m, k)) * 0.9).astype(np.float32)
    if dtype == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    codes = (2 * rng.randint(0, 4, size=(k, n)) - 3).astype(np.int8)
    scale = (rng.rand(n).astype(np.float32) * 0.05 if per_channel
             else np.float32(1.1 * 0.3 / 9))
    return dict(x=x, dtype=dtype, codes=codes, alpha=np.float32(1.1),
                scale=scale, w=(rng.randn(k, n) * 0.2).astype(np.float32),
                bias=rng.randn(n).astype(np.float32) if with_bias else None)


def make_case(seed, c, dil=1, quant=False, res=False, relu=False, pool=False,
              odd=False, xq=False, per_channel=False, n=2, shape=None, o=6,
              qlvl=NA, quant_qlvl=8):
    """NumPy inputs of one K1 call (by default N=2, 6^3 or 5x6x7 volume,
    O=6, the W4A4 preset's 4 activation levels and an 8-level next-conv
    quantizer)."""
    rng = np.random.RandomState(seed)
    d, h, w = shape or ((5 if odd else 6), 6, (7 if odd else 6))
    x = (np.abs(rng.randn(n, d, h, w, c)) * 0.8).astype(np.float32)
    alpha = np.float32(0.9)
    if xq:
        x = np.round(np.clip(x / alpha, 0, 1) * (qlvl - 1)).astype(np.int8)
    kw = dict(dilation=dil, residual_relu=relu, pool=pool, x_quantized=xq)
    if quant:
        kw.update(quant_alpha=np.float32(1.3), quant_qlvl=quant_qlvl)
    return dict(
        qlvl=qlvl,
        x=x,
        codes=(2 * rng.randint(0, 4, size=(3, 3, 3, c, o)) - 3).astype(np.int8),
        bias=rng.randn(o).astype(np.float32), alpha=alpha,
        scale=(rng.rand(o).astype(np.float32) * 0.1 if per_channel
               else np.float32(0.0371)),
        residual=rng.randn(n, d, h, w, o).astype(np.float32) if res else None,
        kw=kw)


def run_port(case, fn=K.qconv3x3_int8_ndhwc, device="cpu", bf16=False):
    """One K1 call of the port on ``device``; outputs as NumPy arrays
    (bfloat16 ones as their uint16 bits).  ``bf16``: bfloat16 output and
    residual."""
    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    kw = dict(case["kw"])
    if "quant_alpha" in kw:
        kw["quant_alpha"] = t(kw["quant_alpha"])
    res = t(case["residual"])
    if bf16:
        kw["out_dtype"] = torch.bfloat16
        res = None if res is None else res.to(torch.bfloat16)
    out = fn(t(case["x"]), t(case["codes"]), t(case["bias"]), t(case["alpha"]),
             t(case["scale"]), case.get("qlvl", NA), residual=res, **kw)
    return tuple(
        (o.view(torch.int16) if o.dtype == torch.bfloat16 else o).cpu().numpy()
        for o in (out if isinstance(out, tuple) else (out,)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_k1_matches_plain(name, bf16, cuda):
    case = make_case(sorted(CASES).index(name), **CASES[name])
    before = K.qconv3x3_int8_ndhwc.launches
    got = run_port(case, device=cuda, bf16=bf16)
    ref = run_port(case, K.qconv3x3_int8_ndhwc_reference, device=cuda,
                   bf16=bf16)
    assert K.qconv3x3_int8_ndhwc.launches == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


# K1 cases at the kernel's tile edges (run on the card only): C and O of
# 40, 72 and 256 (partial 32-channel chunks and column tiles, the byte-load
# path where C % 16 != 0), extents below one brick and odd, N = 1 and 3,
# dilation 1 to 9 (a dilation past the brick stages three slabs), every
# epilogue, and every brick of the tile plan ("brick": the one the plan
# picks, (2, 2, 8) when not given).  The overlapped pipeline ("sums": the
# plan's sums buffers, 0 when not given): blocks that walk exactly two
# bricks and two or three, one sums buffer (C > 32, or dilation 2) and two
# (C = 32, resident weights), a ragged last brick in z, y and x with the
# byte-load path, partial chunks and column tiles, every epilogue, a
# residual the producer stages (O a multiple of 4, of 8 at bfloat16) and
# one the epilogue loads itself (O = 70, and 36 at bfloat16); and a 4 x 8
# brick that each block walks once, which takes turns
TILE_CASES = {
    "c40-o72-n3-32cube-dil2-res-relu-pool": dict(
        c=40, o=72, n=3, shape=(32, 32, 32), dil=2, res=True, relu=True,
        pool=True, brick=(4, 8, 8)),
    "c64-o264-n1-6x16x16-xq-res-pool": dict(
        c=64, o=264, n=1, shape=(6, 16, 16), xq=True, res=True, pool=True,
        brick=(4, 4, 8)),
    "c256-o256-n1-8x16x16-quant": dict(
        c=256, o=256, n=1, shape=(8, 16, 16), quant=True, brick=(2, 4, 8)),
    "c40-o72-n1-odd-quant": dict(c=40, o=72, n=1, shape=(5, 6, 7),
                                 quant=True),
    "c72-o40-n3-dil2-res-relu-pool": dict(
        c=72, o=40, n=3, shape=(7, 9, 10), dil=2, res=True, relu=True,
        pool=True, brick=(2, 4, 8)),
    "c256-o256-n1-xq-res-relu-pool": dict(
        c=256, o=256, n=1, shape=(8, 8, 8), xq=True, res=True, relu=True,
        pool=True),
    "c256-o256-n3-dil2-quant": dict(c=256, o=256, n=3, shape=(4, 6, 9),
                                    dil=2, quant=True, brick=(2, 4, 8)),
    "c48-o40-n1-below-brick-pool": dict(c=48, o=40, n=1, shape=(3, 2, 5),
                                        pool=True),
    "c96-o72-n3-per-channel-res": dict(c=96, o=72, n=3, shape=(6, 5, 12),
                                       per_channel=True, res=True),
    "c32-o32-n1-one-voxel": dict(c=32, o=32, n=1, shape=(1, 1, 1)),
    "c64-o64-n3-dil2-xq-res-relu-pool": dict(
        c=64, o=64, n=3, shape=(10, 11, 9), dil=2, xq=True, res=True,
        relu=True, pool=True, brick=(2, 4, 8)),
    "c40-o40-n1-dil3": dict(c=40, o=40, n=1, shape=(9, 8, 17), dil=3),
    "c24-o9-n1-odd-o-res-relu-pool": dict(c=24, o=9, n=1, shape=(6, 7, 6),
                                          res=True, relu=True, pool=True),
    "c16-o72-n1-dil9-pool": dict(c=16, o=72, n=1, shape=(10, 12, 12), dil=9,
                                 pool=True),
    "c32-o32-n3-32cube-dil2-res-relu-pool-overlap": dict(
        c=32, o=32, n=3, shape=(32, 32, 32), dil=2, res=True, relu=True,
        pool=True, brick=(4, 8, 8), sums=1),
    "c64-o64-n2-32cube-quant-one-sums-buffer": dict(
        c=64, o=64, n=2, shape=(32, 32, 32), quant=True, brick=(4, 8, 8),
        sums=1),
    "c128-o128-n1-8x24x88-res-two-bricks-a-block": dict(
        c=128, o=128, n=1, shape=(8, 24, 88), res=True, per_channel=True,
        brick=(4, 8, 8), sums=1),
    "c3-o8-n1-33x31x65-ragged-res-pool-overlap": dict(
        c=3, o=8, n=1, shape=(33, 31, 65), res=True, pool=True,
        brick=(4, 8, 8), sums=2),
    "c40-o70-n2-9x17x33-xq-res-relu-overlap": dict(
        c=40, o=70, n=2, shape=(9, 17, 33), xq=True, res=True, relu=True,
        brick=(4, 8, 8), sums=1),
    "c32-o36-n2-16x32x64-res-relu-pool-overlap": dict(
        c=32, o=36, n=2, shape=(16, 32, 64), res=True, relu=True,
        pool=True, brick=(4, 8, 8), sums=2),
    "c32-o32-n2-16x64x64-quant-overlap": dict(
        c=32, o=32, n=2, shape=(16, 64, 64), quant=True, brick=(4, 8, 8),
        sums=2),
    "c64-o64-n1-32cube-res-one-brick-a-block": dict(
        c=64, o=64, n=1, shape=(32, 32, 32), res=True, brick=(4, 8, 8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_cuda_k1_tiles_match_plain(name, bf16, cuda):
    kw = dict(TILE_CASES[name])
    brick = kw.pop("brick", (2, 2, 8))
    sums = kw.pop("sums", 0)
    case = make_case(100 + sorted(TILE_CASES).index(name), **kw)
    n, (d, h, w), c, o = kw["n"], kw["shape"], kw["c"], kw["o"]
    plan = K._tile_plan(n, d, h, w, c, o, kw.get("dil", 1))
    assert plan.brick == brick and plan.sums == sums
    before = (K.qconv3x3_int8_ndhwc.launches,
              K.qconv3x3_int8_ndhwc.overlapped_launches)
    got = run_port(case, device=cuda, bf16=bf16)
    ref = run_port(case, K.qconv3x3_int8_ndhwc_reference, device=cuda,
                   bf16=bf16)
    assert (K.qconv3x3_int8_ndhwc.launches,
            K.qconv3x3_int8_ndhwc.overlapped_launches) == (
                before[0] + 1, before[1] + (sums > 0))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


# K1 at the LiTS preset's widest shapes and the mixed recipe's 16-level
# grids (run on the card only): C = O = 512 at the bottleneck's extents of
# a 128 x 128 x 64 patch (4^3) and of the 192 x 128 x 64 calibration crop
# (6 x 4 x 4), 256 -> 512 and 512 -> 256, 16-level act-quant prologues and
# next-act-quant epilogues (a 16-level conv feeding a 4-level one and the
# other way round), at the LiTS path's batch of 8 patches
LITS_CASES = {
    "c512-o512-n8-4cube-a16-quant16": dict(
        c=512, o=512, n=8, shape=(4, 4, 4), qlvl=16, quant=True,
        quant_qlvl=16),
    "c512-o512-n8-4cube-a4-res-relu": dict(
        c=512, o=512, n=8, shape=(4, 4, 4), res=True, relu=True),
    "c512-o512-n1-6x4x4-a16-xq-res": dict(
        c=512, o=512, n=1, shape=(6, 4, 4), qlvl=16, xq=True, res=True),
    "c256-o512-n8-4cube-a16-quant4": dict(
        c=256, o=512, n=8, shape=(4, 4, 4), qlvl=16, quant=True,
        quant_qlvl=4),
    "c512-o256-n8-8cube-a4-quant16": dict(
        c=512, o=256, n=8, shape=(8, 8, 8), quant=True, quant_qlvl=16),
    "c256-o256-n8-8cube-a16-pool": dict(
        c=256, o=256, n=8, shape=(8, 8, 8), qlvl=16, pool=True),
    "c32-o32-n8-64cube-a16-quant16": dict(
        c=32, o=32, n=8, shape=(64, 64, 64), qlvl=16, quant=True,
        quant_qlvl=16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(LITS_CASES))
def test_cuda_k1_lits_shapes_match_plain(name, bf16, cuda):
    case = make_case(200 + sorted(LITS_CASES).index(name),
                     **LITS_CASES[name])
    before = K.qconv3x3_int8_ndhwc.launches
    got = run_port(case, device=cuda, bf16=bf16)
    ref = run_port(case, K.qconv3x3_int8_ndhwc_reference, device=cuda,
                   bf16=bf16)
    assert K.qconv3x3_int8_ndhwc.launches == before + 1
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


# K1 at the benchmark's served shapes, on codes, float32 (run on the card
# only): the LiTS serving net's three stages on the 4 x 8 brick with its
# block2 epilogue (a float32 residual with relu, and the encoder's pool)
# at the chunk of 8 and the varied-depth cell's ragged chunks of 1-7;
# SegResNet's four levels at the chunk of 8 with conv2's epilogue (a
# float32 residual) and at 16 x 24 x 20 x 256 conv1's (y alone)
SERVING_CASES = [("lits", (s, s, s), c, n, "residual-relu-pool")
                 for s, c in ((64, 32), (32, 64), (16, 128))
                 for n in range(1, 9)] + [
    ("segresnet", (128 >> lv, 192 >> lv, 160 >> lv), 32 << lv, 8,
     "residual") for lv in range(4)] + [
    ("segresnet", (16, 24, 20), 256, 8, "y")]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "net,shape,c,n,epilogue", SERVING_CASES,
    ids=[f"{net}-{'x'.join(map(str, s))}-c{c}-n{n}-{e}"
         for net, s, c, n, e in SERVING_CASES])
def test_cuda_k1_serving_shapes_match_plain(net, shape, c, n, epilogue,
                                            cuda):
    """torch.equal to the plain K1 at the served shapes, on whichever
    pipeline the plan takes there (counted by ``overlapped_launches``)."""
    seed = 500 + SERVING_CASES.index((net, shape, c, n, epilogue))
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(0, NA, (n, *shape, c), device=cuda, generator=gen,
                      dtype=torch.int8)
    w = (2 * torch.randint(0, NA, (3, 3, 3, c, c), device=cuda,
                           generator=gen) - (NA - 1)).to(torch.int8)
    b = torch.randn(c, device=cuda, generator=gen)
    kw = dict(x_quantized=True, w_packed=K.pack_weights(w))
    if epilogue != "y":
        kw["residual"] = torch.randn(n, *shape, c, device=cuda,
                                     generator=gen)
    if net == "lits":
        kw.update(residual_relu=True, pool=True)
    args = (x, w, b, torch.tensor(LITS_ALPHA, device=cuda),
            torch.tensor(0.002, device=cuda), NA)
    plan = K._tile_plan(n, *shape, c, c, 1)
    before = (K.qconv3x3_int8_ndhwc.launches,
              K.qconv3x3_int8_ndhwc.overlapped_launches)
    got = K.qconv3x3_int8_ndhwc(*args, **kw)
    assert (K.qconv3x3_int8_ndhwc.launches,
            K.qconv3x3_int8_ndhwc.overlapped_launches) == (
                before[0] + 1, before[1] + (plan.sums > 0))
    ref = K.qconv3x3_int8_ndhwc_reference(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)
    del got, ref, kw
    torch.cuda.empty_cache()


def tie_dense(alpha, qlvl, bf16=False):
    """Float32 inputs at the edges of K1's input quantizer
    ``rint(clip(x / alpha, 0, 1) * (qlvl - 1))``: the 17 x 17 floats
    around fl(fl((k + 0.5) / (qlvl - 1)) * alpha) (17 quotients, 17 x
    around each), which hold x whose float32 quotient and product land
    exactly on a .5 tie (rounded half to even), and their neighbours;
    zeros, negatives, the clip's ends and values far past it.  With
    ``bf16`` the values rounded to bfloat16 and their bfloat16 neighbours
    (bfloat16 x lands on a tie only where alpha and qlvl - 1 are powers of
    two)."""
    qmax, a = np.float32(qlvl - 1), np.float32(abs(alpha))
    ties = np.arange(qlvl - 1, dtype=np.float32) + np.float32(0.5)
    off = np.arange(-8, 9)

    def around(v):
        return (v.view(np.int32)[:, None] + off).astype(np.int32).view(
            np.float32).ravel()

    x = around((around((ties / qmax).astype(np.float32)) * a)
               .astype(np.float32))
    x = np.concatenate([x, -x[::7], np.float32(
        [0.0, -0.0, a, np.nextafter(a, 0), np.nextafter(a, np.inf), 2 * a,
         1e3, -1e3, 3e38, -3e38])]).astype(np.float32)
    if bf16:
        bits = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
        x = torch.cat([bits, bits + 1, bits - 1]).view(
            torch.bfloat16).float().numpy()
    return np.unique(x[np.isfinite(x)])


def tie_input(shape, alpha, qlvl, dtype, device, seed):
    """x of ``shape`` on ``device``: half of its elements drawn from
    ``tie_dense(alpha, qlvl)``, half |N(0, 1)| * alpha * 1.2, so every
    part of the volume (its edges too) holds ties, negatives, zeros and
    values past the clip; in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.from_numpy(tie_dense(alpha, qlvl, dtype == torch.bfloat16)
                            ).to(device)
    pick = pool[torch.randint(len(pool), shape, device=device,
                              generator=gen)]
    rand = torch.randn(shape, device=device, generator=gen).abs() * (
        1.2 * abs(alpha))
    half = torch.rand(shape, device=device, generator=gen) < 0.5
    return torch.where(half, pick, rand).to(dtype)


# the LiTS serving net's nine block1 convs (UResBlock1-9
# Layer1.block1.conv) at a 128 x 128 x 64 patch: (extent, C = O).  Each
# takes a float input (the stem's, a TransDown's or K5's output) that K1
# quantizes to 4 levels, and emits block2's 4-level codes
# (epilogue_quant_for, kernels/epilogue.py rule 1)
LITS_BLOCK1 = [(64, 32), (32, 64), (16, 128), (8, 256), (4, 512), (8, 256),
               (16, 128), (32, 64), (64, 32)]
LITS_ALPHA = 4 / 3  # the benchmark configuration's 4-level activation range


def _block1_call(i, dtype, device, epilogue, n=8):
    """(args, kwargs) of K1 at LiTS block i + 1 (N = 8 patches) with a
    tie-dense float input of ``dtype``; ``epilogue``: "quant" (the served
    graph's), "residual" (a residual with relu, ``dtype`` out) or "pool"
    (``dtype`` out and the pool)."""
    s, c = LITS_BLOCK1[i]
    gen = torch.Generator(device=device).manual_seed(300 + i)
    x = tie_input((n, s, s, s, c), LITS_ALPHA, NA, dtype, device, 400 + i)
    w = (2 * torch.randint(0, NA, (3, 3, 3, c, c), device=device,
                           generator=gen) - (NA - 1)).to(torch.int8)
    b = torch.randn(c, device=device, generator=gen)
    alpha = torch.tensor(LITS_ALPHA, device=device)
    kw = dict(w_packed=K.pack_weights(w))
    if epilogue == "quant":
        kw.update(quant_alpha=alpha, quant_qlvl=NA)
    elif epilogue == "residual":
        kw.update(residual=torch.randn(n, s, s, s, c, device=device,
                                       generator=gen).to(dtype),
                  residual_relu=True, out_dtype=dtype)
    else:
        kw.update(pool=True, out_dtype=dtype)
    return (x, w, b, alpha, torch.tensor(0.002, device=device), NA), kw


def _check_float_k1(args, kw):
    """The float-input K1 call equals the plain version (torch.equal), is
    one launch, and quantized its input in its prologue."""
    before = (K.qconv3x3_int8_ndhwc.launches,
              K.qconv3x3_int8_ndhwc.prologue_quant_launches)
    got = K.qconv3x3_int8_ndhwc(*args, **kw)
    assert (K.qconv3x3_int8_ndhwc.launches,
            K.qconv3x3_int8_ndhwc.prologue_quant_launches) == (
                before[0] + 1, before[1] + 1)
    ref = K.qconv3x3_int8_ndhwc_reference(*args, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("i", range(len(LITS_BLOCK1)),
                         ids=[f"UResBlock{i + 1}-{s}cube-c{c}"
                              for i, (s, c) in enumerate(LITS_BLOCK1)])
def test_cuda_k1_float_input_at_lits_block1(i, dtype, cuda):
    """K1 quantizing its float32 or bfloat16 input in its prologue, at the
    LiTS block1 shapes with the served graph's quant epilogue: torch.equal
    to the plain version, whose act_codes quantizes in separate passes."""
    _check_float_k1(*_block1_call(i, dtype, cuda, "quant"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("epilogue", ["residual", "pool"])
@pytest.mark.parametrize("i", [1, 3], ids=["32cube-c64", "8cube-c256"])
def test_cuda_k1_float_input_with_residual_and_pool(i, epilogue, dtype,
                                                    cuda):
    _check_float_k1(*_block1_call(i, dtype, cuda, epilogue))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("qlvl,alpha", [(2, 1.1), (3, 1.1), (4, 4 / 3),
                                        (4, 0.37), (4, 3e-18), (16, 2.5),
                                        (128, 0.9), (4, -0.8)])
def test_cuda_k1_prologue_codes_are_exact(qlvl, alpha, dtype, cuda):
    """With the identity at the centre tap, scale 1 and no bias, y is the
    input's code itself: K1's prologue codes (thresholds at 2-4 levels,
    the divide at 16 and 128 levels, an extreme or negative alpha) equal
    act_codes bit for bit on ``tie_dense``'s values, at +-inf and random;
    NaN gives code 0, as the clip takes it."""
    from efficientq_tpu_torch.quant import act_codes

    c = 32
    x = np.concatenate([tie_dense(alpha, qlvl, dtype == "bf16"),
                        np.float32([np.inf, -np.inf, np.nan]),
                        np.random.RandomState(qlvl).randn(4096).astype(
                            np.float32) * np.float32(abs(alpha))])
    x = np.resize(x, (-(-x.size // (8 * c)) * 8, c)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda).reshape(1, -1, 1, 8, c)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    w = torch.zeros(3, 3, 3, c, c, dtype=torch.int8, device=cuda)
    w[1, 1, 1] = torch.eye(c, dtype=torch.int8, device=cuda)
    at = torch.tensor(alpha, device=cuda)
    before = K.qconv3x3_int8_ndhwc.prologue_quant_launches
    y = K.qconv3x3_int8_ndhwc(xt, w, None, at, 1.0, qlvl)
    torch.cuda.synchronize()
    assert K.qconv3x3_int8_ndhwc.prologue_quant_launches == before + 1
    nan = torch.isnan(xt)
    assert int(nan.sum()) > 0 and torch.equal(y[nan], torch.zeros_like(
        y[nan]))
    assert torch.equal(y[~nan], act_codes(xt, at, qlvl)[~nan].float())


@pytest.mark.cuda
def test_cuda_k1_float_input_replays_in_a_cuda_graph(cuda):
    """A float-input K1 call (packed weights, alphas on the card) on the
    overlapped pipeline is captured in a CUDA graph, and its replay equals
    the eager call."""
    args, kw = _block1_call(1, torch.float32, cuda, "quant", n=2)
    assert K._tile_plan(*args[0].shape, 64, 1).sums > 0
    before = K.qconv3x3_int8_ndhwc.overlapped_launches
    eager = K.qconv3x3_int8_ndhwc(*args, **kw)
    assert K.qconv3x3_int8_ndhwc.overlapped_launches == before + 1
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.qconv3x3_int8_ndhwc(*args, **kw)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and bool(eager.any())


@pytest.mark.cuda
def test_cuda_k1_takes_float32_or_bfloat16_input(cuda):
    codes = torch.zeros(3, 3, 3, 8, 4, dtype=torch.int8, device=cuda)
    for dt in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            K.qconv3x3_int8_ndhwc(torch.zeros(1, 4, 4, 4, 8, dtype=dt,
                                              device=cuda), codes, None,
                                  1.0, 1.0, NA)
    with pytest.raises(ValueError, match="one alpha"):
        K.qconv3x3_int8_ndhwc(torch.zeros(1, 4, 4, 4, 8, device=cuda), codes,
                              None, torch.ones(8, device=cuda), 1.0, NA)


@pytest.mark.cuda
def test_cuda_act_k_deployment_matches_quantized_forward(cuda):
    """Offset activation grids (``act_k``) on three convs of the small net:
    deployed to int8 on the card, those convs stay off K1 and its fused
    epilogues (signed codes on the integer conv), every other interior 3^3
    conv runs on K1, and the forward computes the undeployed quantized
    forward (within 2e-4, the CPU test's level)."""
    fg, fv = small_net(1, 0.8)
    names = [n.name for n in fg.qconv_nodes()
             if n.attrs["qcfg"].q_act and n.attrs["qcfg"].q_weight
             and n.attrs["kernel_size"] == (3, 3, 3)]
    chosen = {names[1]: 1, names[2]: 2, names[-1]: 3}
    for name, k in chosen.items():
        fv["params"][name]["act_k"] = torch.tensor(k, dtype=torch.int32)
    dg, dv = to_int8_inference(fg, fv)
    for name in chosen:
        a = dg.node(name).attrs
        assert a["act_k"] == chosen[name] and a.get("int8")
        assert not a.get("pallas") and not a.get("input_quantized")
    x = torch.from_numpy(np.abs(np.random.RandomState(2).randn(
        2, 32, 32, 32, 4)).astype(np.float32)).to(cuda)
    ref = nnir.apply(fg, nnir.to_device(fv, cuda), x, mode="quantized")
    flagged = sum(1 for n in dg.nodes if n.attrs.get("pallas"))
    assert flagged > 0
    before = K.qconv3x3_int8_ndhwc.launches
    got = nnir.apply(dg, nnir.to_device(dv, cuda), x, mode="quantized")
    assert K.qconv3x3_int8_ndhwc.launches - before == flagged
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_cuda_k1_rejects_mismatched_weights(cuda):
    x = torch.zeros(1, 4, 4, 4, 8, device=cuda)
    codes = torch.zeros(3, 3, 3, 8, 4, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="packed weights"):
        K.qconv3x3_int8_ndhwc(x, codes, None, 1.0, 1.0, NA,
                              w_packed=K.pack_weights(codes[..., :2]))
    with pytest.raises(ValueError, match="scale"):
        K.qconv3x3_int8_ndhwc(x, codes, None, 1.0,
                              torch.ones(3, device=cuda), NA)


def small_net(seed, alpha_act, **cfg):
    """The folded post-PTQ graph of a small W4A4 net (widths 8-16-8, 4
    modalities) and its variables on the CPU: weights projected onto the
    alpha_w = max|w| grid, every alpha_act set."""
    cfg = UResQConfig(**dict(
        dict(num_mod=4, num_classes=3, depth_config=[1, 1, 1],
             width_config=[8, 16, 8], dilation_config=[1, 1, 1],
             init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid",
             ds="simple", quantize=True, qlvl_w=4, qlvl_act=4,
             q_first=(256, -1), q_last=(256, -1)), **cfg))
    graph = build_uresq(cfg)
    fg, fv = fold_bn(graph, nnir.init(graph, seed, device="cpu"))
    for node in fg.qconv_nodes():
        q = node.attrs["qcfg"]
        p = fv["params"][node.name]
        if q.q_weight:
            a = torch.clamp_min(p["kernel"].abs().max(), 1e-8)
            p["kernel"] = fake_quant_weight(p["kernel"], a, q.qlvl_w)
            p["alpha_w"] = a
        if q.q_act:
            p["alpha_act"] = torch.tensor(alpha_act)
    return fg, fv


def _serve_int8(cuda):
    """The int8 deployment of the dilated small net on the card, a
    volume, and the float32 serving options of test_cuda_serving_slice_*."""
    fg, fv = small_net(0, 0.8, dilation_config=[1, 2, 1], ds_depth_limit=3,
                       fuse_bn=True)
    dg, dv = to_int8_inference(fg, fv)
    net = nnir.GraphModule(dg, dv, mode="quantized").to(cuda)
    images, _ = synthetic.make_subject(np.random.default_rng(0), "brats",
                                       (36, 40, 44))
    vol = torch.from_numpy(np.stack(list(images.values()), -1)[None]).to(cuda)
    kw = dict(patch_batch=2, mode="quantized", heads=slice(-1, None),
              hard_pred=True, multilabel=True)
    return dg, net, vol, kw


@pytest.mark.cuda
def test_cuda_serving_slice_matches_plain_k1(cuda):
    dg, net, vol, kw = _serve_int8(cuda)
    before = K.qconv3x3_int8_ndhwc.launches
    got = sliding.make_volume_inferencer(dg, capture=False, **kw)(
        net.variables, vol, (32, 32, 32), (8, 8, 8))
    n_forwards = -(-len(sliding.patch_grid((36, 40, 44), 32, 8)) // 2)
    assert K.qconv3x3_int8_ndhwc.launches - before == 6 * n_forwards
    ref = sliding.make_volume_inferencer(
        dg, kernels=WRAPPERS._replace(
            conv3x3_int8=K.qconv3x3_int8_ndhwc_reference),
        capture=False, **kw)(net.variables, vol, (32, 32, 32), (8, 8, 8))
    assert got.shape == (1, 1, 36, 40, 44, 3) and got.dtype == torch.uint8
    assert torch.equal(got, ref)


def _live_1x1_flags(graph, heads=slice(-1, None)):
    live = nnir.live_nodes(graph, graph.outputs[heads])
    return sum(1 for n in graph.nodes if n.name in live
               and n.attrs.get("pallas") and n.attrs["kernel_size"] == (1, 1, 1))


@pytest.mark.cuda
def test_cuda_serving_slice_include_1x1_equals_unflagged(cuda):
    """K3 equals the unfused int8 1x1 route bit for bit, so the int8 slice
    with ``include_1x1`` serves the predictions of the slice without it."""
    dg, net, vol, kw = _serve_int8(cuda)
    pg = KM.to_pallas_inference(dg, include_1x1=True)
    n_k3 = _live_1x1_flags(pg)
    assert n_k3 > 0
    before = KM.fused_int8_matmul.launches
    got = sliding.make_volume_inferencer(pg, capture=False, **kw)(
        net.variables, vol, (32, 32, 32), (8, 8, 8))
    n_forwards = -(-len(sliding.patch_grid((36, 40, 44), 32, 8)) // 2)
    assert KM.fused_int8_matmul.launches - before == n_k3 * n_forwards
    ref = sliding.make_volume_inferencer(dg, capture=False, **kw)(
        net.variables, vol, (32, 32, 32), (8, 8, 8))
    assert torch.equal(got, ref)


def stem_inputs(depth, c, o, device, seed=0, hw=32, patch=16):
    """s2d patches of a (depth, hw, hw) volume on the standard grid (both
    z parities when the depth allows), the s2d weights of a random 3^3
    stem kernel, and a bias."""
    rng = np.random.RandomState(seed)
    vol = torch.from_numpy(rng.randn(1, depth, hw, hw, c).astype(np.float32))
    starts = sliding.patch_grid((depth, hw, hw), patch, patch // 4)
    x, par = K2.extract_s2d_patches(vol, starts, (patch,) * 3)
    w3 = rng.randn(3, 3, 3, c, o).astype(np.float32) * 0.2
    we, wo = (torch.from_numpy(w).to(device, torch.bfloat16)
              for w in K2.s2d_stem_weights(w3))
    bias = torch.from_numpy(rng.randn(o).astype(np.float32) * 0.1)
    return x.to(device), par.to(device), we, wo, bias.to(device)


def check_stem(y, q, yr, qr, alpha, qlvl):
    """K2's outputs against the plain version's, at the module's
    tolerances; returns the number of codes excused as ties."""
    assert y.dtype == yr.dtype and y.shape == yr.shape and q.shape == qr.shape
    yf, rf = y.float(), yr.float()
    diff = (yf - rf).abs()
    tol = 1e-4 * float(rf.abs().max())
    if y.dtype == torch.float32:
        assert float(diff.max()) <= tol
        rounded_apart = torch.zeros_like(q, dtype=torch.bool)
    else:  # one bf16 ulp: adjacent bit patterns of non-negative values,
        # or within the float32 tolerance near 0 (the relu boundary)
        ulps = (y.view(torch.int16).int() - yr.view(torch.int16).int()).abs()
        assert not bool(((ulps > 1) & (diff > tol)).any())
        rounded_apart = ulps > 0
    pre = torch.clamp(rf / alpha, 0.0, 1.0) * (qlvl - 1)
    tie = ((pre - pre.floor()) - 0.5).abs() <= 1e-4
    bad = (q != qr) & ~tie & ~rounded_apart
    assert not bool(bad.any()), int(bad.sum())
    return int(((q != qr) & (tie | rounded_apart)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("depth,c,o", [(22, 4, 8), (23, 4, 8), (23, 4, 32),
                                       (21, 1, 40)])
def test_cuda_k2_matches_plain(depth, c, o, out, cuda):
    x, par, we, wo, bias = stem_inputs(depth, c, o, cuda, seed=depth + o)
    if depth % 2:
        assert 0 < int(par.sum()) < par.numel()  # both parities
    alpha, qlvl = 0.7, 4
    before = K2.stem_s2d_conv.launches
    y, q = K2.stem_s2d_conv(x, par, we, wo, bias, alpha, qlvl, out_dtype=out)
    yr, qr = K2.stem_s2d_conv_reference(x, par, we, wo, bias, alpha, qlvl,
                                        out_dtype=out)
    torch.cuda.synchronize()
    assert K2.stem_s2d_conv.launches == before + 1
    check_stem(y, q, yr, qr, alpha, qlvl)
    assert int(q.max()) == qlvl - 1 and int(q.min()) == 0


@pytest.mark.cuda
def test_cuda_k2_rejects_mismatched_shapes(cuda):
    x, par, we, wo, bias = stem_inputs(22, 4, 8, cuda)
    with pytest.raises(ValueError, match="w_odd"):
        K2.stem_s2d_conv(x, par, we, wo[:, :-8], bias, 1.0, 4)
    with pytest.raises(ValueError, match="parities"):
        K2.stem_s2d_conv(x, par[:-1], we, wo, bias, 1.0, 4)
    with pytest.raises(ValueError, match="bfloat16 patches"):
        K2.stem_s2d_conv(x.float(), par, we, wo, bias, 1.0, 4)


def raw_stem_inputs(b, d, h, w, c, o, parities, device, seed=0):
    """K2's inputs drawn directly: (b, d + 1, h, w, 8c) random bfloat16
    patches (plane 0 real data in every patch), the given parities, the
    s2d weights of a random 3^3 kernel and a bias."""
    rng = np.random.RandomState(seed + b + d + h + w + c + o)
    x = torch.from_numpy((rng.randn(b, d + 1, h, w, 8 * c) * 0.8).astype(
        np.float32)).to(device, torch.bfloat16)
    par = torch.tensor(parities, dtype=torch.int32, device=device)
    w3 = rng.randn(3, 3, 3, c, o).astype(np.float32) * 0.2
    we, wo = (torch.from_numpy(v).to(device, torch.bfloat16)
              for v in K2.s2d_stem_weights(w3))
    bias = torch.from_numpy(rng.randn(o).astype(np.float32) * 0.1)
    return x, par, we, wo, bias.to(device)


def k2_plan(rows, zc):
    """A K2 tiling by hand (the launch reads rows and zc)."""
    return K2.K2Plan(rows, zc, (0, 0), 256, 0)


# (B, D, H, W, C, O, parities, tiling or None for the plan's): planes of
# 12 x 20 (no band height divides both), C = 1, O = 40, B = 1, D = 1,
# z chunks of 4 planes over odd patches (chunk boundaries at 4 and 8), and
# C = 5, 8 and 9 (3 and 4 k-steps per tap, and the run-time count)
K2_EDGES = {
    "c5-ksteps3": (1, 3, 6, 10, 5, 16, [1], None),
    "c8-ksteps4": (1, 3, 6, 10, 8, 8, [0], None),
    "c9-ksteps-at-run-time": (2, 3, 6, 10, 9, 8, [0, 1], None),
    "12x20-c1-o40-b2": (2, 9, 12, 20, 1, 40, [1, 0], None),
    "12x20-c4-o8-b1-odd": (1, 6, 12, 20, 4, 8, [1], None),
    "12x20-c4-o8-b1-even": (1, 6, 12, 20, 4, 8, [0], None),
    "d1-5x6-both": (2, 1, 5, 6, 4, 8, [0, 1], None),
    "zchunks-odd-o32": (2, 11, 12, 20, 4, 32, [1, 1], (4, 4)),
    "rows3-o20": (2, 5, 7, 9, 1, 20, [0, 1], (3, 2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(K2_EDGES))
def test_cuda_k2_edge_shapes_match_plain(name, out, cuda):
    b, d, h, w, c, o, parities, tiling = K2_EDGES[name]
    x, par, we, wo, bias = raw_stem_inputs(b, d, h, w, c, o, parities, cuda)
    alpha = torch.tensor(0.7, device=cuda)
    before = K2.stem_s2d_conv.launches
    if tiling is None:
        y, q = K2.stem_s2d_conv(x, par, we, wo, bias, alpha, 4,
                                out_dtype=out)
    else:
        y, q = K2._launch(x, par, we, wo, bias, alpha, 4, out,
                          plan=k2_plan(*tiling))
    yr, qr = K2.stem_s2d_conv_reference(x, par, we, wo, bias, alpha, 4,
                                        out_dtype=out)
    torch.cuda.synchronize()
    assert K2.stem_s2d_conv.launches == before + 1
    check_stem(y, q, yr, qr, 0.7, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_k2_every_tiling_matches_plain(out, cuda):
    """Every tiling that K2's plan chooses among gives the same bits (each
    output's sum runs in the same order whatever block computes it), and
    they match the plain version."""
    x, par, we, wo, bias = raw_stem_inputs(2, 9, 12, 20, 4, 40, [1, 0], cuda)
    wp = K2.pack_stem_weights(we, wo)
    yr, qr = K2.stem_s2d_conv_reference(x, par, we, wo, bias, 0.7, 4,
                                        out_dtype=out)
    plans = [p for _, p in K2._k2_candidates(2, 9, 12, 20, 32, 40)]
    assert len(plans) >= 8
    first = None
    for plan in plans:
        got = K2._launch(x, par, we, wo, bias, 0.7, 4, out, wp, plan=plan)
        torch.cuda.synchronize()
        if first is None:
            first = got
            check_stem(*got, yr, qr, 0.7, 4)
        for g, f in zip(got, first):
            assert torch.equal(g, f), plan


def _bf16_parts(v):
    """float32 values v -> three bfloat16 arrays whose sum is v exactly, in
    any order (each part a piece of v's significand)."""
    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    hi = bf16(v)
    mid = bf16((v - hi).astype(np.float32))
    lo = bf16((v - hi - mid).astype(np.float32))
    finite = np.isfinite(v)
    assert (hi[finite].astype(np.float64) + mid[finite] + lo[finite]
            == v[finite].astype(np.float64)).all()
    return hi, mid, lo


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("qlvl,alpha", [(2, 1.1), (3, 1.1), (4, 1.1),
                                        (4, 0.37), (4, 3e-18), (16, 2.5),
                                        (128, 0.9), (4, -0.8)])
def test_cuda_k2_threshold_codes_are_exact(qlvl, alpha, out, cuda):
    """K2's codes (thresholds at 2-4 levels, the divide otherwise) equal
    the plain version's divide for stem outputs at, and one float (at
    bfloat16 output one bfloat16) either side of, every code's tie, at the
    clip, at +-0, large and random.  The weights make output o of voxel v
    the exact sum of input channels o, o + 8 and o + 16 of the voxel's
    plane 1, which hold three bfloat16 parts of the value; the bias puts
    NaN, +inf and -inf on three more channels: NaN gives code 0, +inf the
    top code (alpha > 0), -inf (relu'd to 0) code 0."""
    from efficientq_tpu_torch.quant import act_codes

    rng = np.random.RandomState(qlvl)
    qmax = np.float32(qlvl - 1)
    a = np.float32(abs(alpha))
    ties = ((np.arange(qlvl, dtype=np.float32) + np.float32(0.5)) / qmax
            * a).astype(np.float32)
    if out == torch.bfloat16:  # the output's own grid
        ties = torch.from_numpy(ties).to(torch.bfloat16)
        bits = ties.view(torch.int16)
        v = torch.cat([bits, bits + 1, bits - 1]).view(
            torch.bfloat16).float().numpy()
    else:
        v = np.concatenate([np.nextafter(ties, -np.inf), ties,
                            np.nextafter(ties, np.inf)])
    edges = np.float32([0.0, -0.0, a, -a, np.nextafter(a, 0), 1e-30, 3e38])
    v = np.concatenate([v, edges, np.abs(rng.randn(2048) * a)]).astype(
        np.float32)
    h, w, o = 32, 48, 8
    vals = np.resize(v, (h, w, 5))  # outputs 0-4; 5-7 from the bias
    x = np.zeros((1, 2, h, w, 32), np.float32)
    for k, part in enumerate(_bf16_parts(vals)):
        x[0, 1, :, :, 8 * k:8 * k + 5] = part
    wt = np.zeros((2, 4 * 32, o), np.float32)
    for c in range(24):  # tap (kd2, kh2, kw2) = (1, 1, 1): plane 1, (h, w)
        wt[1, 3 * 32 + c, c % 8] = 1.0
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    we = torch.from_numpy(wt).to(cuda, torch.bfloat16)
    par = torch.zeros(1, dtype=torch.int32, device=cuda)
    bias = torch.tensor([0.0] * 5 + [float("nan"), float("inf"),
                                     float("-inf")], device=cuda)
    at = torch.tensor(alpha, device=cuda)
    y, q = K2.stem_s2d_conv(xt, par, we, we, bias, at, qlvl, out_dtype=out)
    yr, qr = K2.stem_s2d_conv_reference(xt, par, we, we, bias, at, qlvl,
                                        out_dtype=out)
    torch.cuda.synchronize()
    assert torch.equal(y[..., :5], yr[..., :5])
    assert torch.equal(q[..., :5], qr[..., :5])
    assert torch.equal(q[..., :5], act_codes(y[..., :5], at, qlvl))
    top = qlvl - 1 if alpha > 0 else 0
    for ch, code in ((5, 0), (6, top), (7, 0)):
        assert bool((q[..., ch] == code).all()), (ch, code)


@pytest.mark.cuda
def test_cuda_k2_call_replays_in_a_cuda_graph(cuda):
    """A lean call (packed weights, alpha, bias and parities on the card)
    is captured in a CUDA graph, and its replay equals the eager call."""
    x, par, we, wo, bias = raw_stem_inputs(2, 9, 12, 20, 4, 32, [1, 0], cuda)
    wp = K2.pack_stem_weights(we, wo)
    alpha = torch.tensor(0.7, device=cuda)
    args = (x, par, we, wo, bias, alpha, 4)
    eager = K2.stem_s2d_conv(*args, out_dtype=torch.bfloat16, w_packed=wp)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K2.stem_s2d_conv(*args, out_dtype=torch.bfloat16, w_packed=wp)
    for t in out:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for g, e in zip(out, eager):
        assert torch.equal(g, e)


@pytest.mark.cuda
def test_cuda_s2d_slice_matches_plain_kernels(cuda):
    """The s2d bf16 serving slice of a small net with K2 and K1 against the
    same slice with their plain versions; one K2 and 6 K1 launches per
    patch-batch forward."""
    fg, fv = small_net(1, 1.0)
    dg, dv = to_int8_inference(fg, fv)
    images, _ = synthetic.make_subject(np.random.default_rng(1), "brats",
                                       (39, 48, 48))
    vol = np.stack(list(images.values()), -1)[None]
    kw = dict(multilabel=True, heads=slice(-1, None), device=cuda)
    infer = deploy.make_s2d_volume_inferencer(dg, dv, **kw)
    k1, k2 = K.qconv3x3_int8_ndhwc.launches, K2.stem_s2d_conv.launches
    got = infer(None, vol, (32, 32, 32), (8, 8, 8))
    assert K2.stem_s2d_conv.launches - k2 == 1  # the whole grid: 1 forward
    assert K.qconv3x3_int8_ndhwc.launches - k1 == 6
    # eager: the plain K2 reads the parities on the host
    plain = deploy.make_s2d_volume_inferencer(
        dg, dv, kernels=WRAPPERS._replace(
            conv3x3_int8=K.qconv3x3_int8_ndhwc_reference,
            stem_conv=K2.stem_s2d_conv_reference), capture=False, **kw)
    ref = plain(None, vol, (32, 32, 32), (8, 8, 8))
    assert got.shape == (1, 1, 39, 48, 48, 3) and got.dtype == torch.uint8
    assert float((got == ref).float().mean()) >= 0.999


def _matmul_args(case, device):
    x = torch.as_tensor(case["x"], device=device)
    if case["dtype"] == "bf16":
        x = x.to(torch.bfloat16)

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return x, t


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=["-".join(map(str, c)) for c in MATMUL_CASES])
def test_cuda_k3_matches_plain(case, cuda):
    c = matmul_case(*case)
    x, t = _matmul_args(c, cuda)
    args = (x, t(c["codes"]), t(c["bias"]), t(c["alpha"]), t(c["scale"]), NA)
    before = KM.fused_int8_matmul.launches
    got = KM.fused_int8_matmul(*args)
    ref = KM.fused_int8_matmul_reference(*args)
    torch.cuda.synchronize()
    assert KM.fused_int8_matmul.launches == before + 1
    assert got.dtype == ref.dtype == torch.float32
    assert torch.equal(got, ref)


# the flagship's six transition 1x1 convs at one patch: (M, K, N)
FLAGSHIP_1X1 = [(32768, 32, 64), (4096, 64, 128), (512, 128, 256),
                (512, 256, 128), (4096, 128, 64), (32768, 64, 32)]


def k3_case(m, k, n, dtype, per_channel, with_bias, layout, device, seed=0):
    """The inputs of one K3 call on ``device``: (x, codes, bias, alpha,
    scale).  Layout "offset": a contiguous x whose data starts 1 element
    past an allocation (the element-load staging)."""
    c = matmul_case(m, k, n, dtype, per_channel, with_bias, seed)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    full = torch.as_tensor(c["x"], device=device).to(dt)
    if layout == "offset":
        buf = torch.empty(m * k + 1, device=device, dtype=dt)
        x = buf[1:].view(m, k)
        x.copy_(full)
        assert x.data_ptr() % 16 and x.is_contiguous()
    else:
        x = full
    return (x, torch.as_tensor(c["codes"], device=device),
            None if c["bias"] is None else torch.as_tensor(c["bias"],
                                                           device=device),
            torch.tensor(c["alpha"], device=device),
            torch.as_tensor(c["scale"], device=device))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", [c + ("",) for c in MATMUL_CASES]
    + [(m // 8, k, n, "bf16", True, True, "") for m, k, n in FLAGSHIP_1X1]
    + [(m // 32, k, n, "f32", False, False, "") for m, k, n in FLAGSHIP_1X1],
    ids=lambda c: "-".join(map(str, c)).rstrip("-"))
def test_cuda_k3_every_plan_matches_plain(case, cuda):
    """Every tiling that K3's plan chooses among, not only its choice."""
    x, codes, b, alpha, scale = k3_case(*case, device=cuda)
    ref = KM.fused_int8_matmul_reference(x, codes, b, alpha, scale, NA)
    wp = KM.pack_weights_1x1(codes)
    m, k = x.shape
    plans = [p for _, p in KM._k3_candidates(m, k, codes.shape[1],
                                             x.dtype == torch.bfloat16)]
    assert len(plans) >= 2
    for plan in plans:
        got = KM._launch_int8(x, codes, b, alpha, scale, NA, wp, plan=plan)
        assert torch.equal(got, ref), plan


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(70, 12, 20, "bf16", True, True, ""),
                                  (700, 20, 64, "bf16", False, False, ""),
                                  (700, 12, 33, "f32", True, True, "offset"),
                                  (4097, 64, 128, "bf16", False, True,
                                   "offset"),
                                  (333, 264, 264, "f32", True, False,
                                   "offset")],
                         ids=["k12-bf16", "k20-bf16", "offset-f32",
                              "offset-bf16", "k264-offset"])
def test_cuda_k3_element_loads_match_plain(case, cuda):
    """x rows that are not 16-byte aligned (K * element size not a
    multiple of 16, or a misaligned x) take the element-load staging."""
    x, codes, b, alpha, scale = k3_case(*case, device=cuda)
    got = KM.fused_int8_matmul(x, codes, b, alpha, scale, NA)
    ref = KM.fused_int8_matmul_reference(x, codes, b, alpha, scale, NA)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("qlvl,alpha", [(2, 1.1), (3, 1.1), (4, 1.1),
                                        (4, 0.37), (4, 3e-18), (16, 2.5),
                                        (128, 0.9), (4, -0.8)])
def test_cuda_k3_threshold_codes_are_exact(qlvl, alpha, dtype, cuda):
    """With identity weight codes and scale 1, y is the activation code
    itself.  The threshold codes (2-4 levels; bfloat16 x compared as its
    bits) equal the plain version's divide bit for bit for x at, and one
    float (or one bfloat16) either side of, every code's tie, at the clip,
    at +-inf and +-0, and random; 16 and 128 levels and a negative alpha
    take the kernel's divide.  NaN gives code 0, as the clip takes it; an
    infinity the code of its side of the clip."""
    from efficientq_tpu_torch.quant import act_codes

    rng = np.random.RandomState(qlvl)
    qmax = np.float32(qlvl - 1)
    a = np.float32(alpha)
    ties = ((np.arange(qlvl, dtype=np.float32) + np.float32(0.5)) / qmax
            * abs(a)).astype(np.float32)
    near = np.concatenate([np.nextafter(ties, -np.inf), ties,
                           np.nextafter(ties, np.inf)])
    edges = np.float32([0.0, -0.0, abs(a), -abs(a), np.nextafter(abs(a), 0),
                        1e-38, 3e38, np.inf, -np.inf, np.nan])
    x = np.concatenate([near, edges,
                        (rng.randn(4096) * abs(a)).astype(np.float32)])
    x = np.resize(x, (-(-x.size // 64), 64)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    if dtype == "bf16":  # the values rounded, and their bf16 neighbours
        bits = xt.to(torch.bfloat16).view(torch.int16)
        xt = torch.cat([bits, bits + 1, bits - 1]).view(torch.bfloat16)
    eye = torch.eye(64, dtype=torch.int8, device=cuda)
    at = torch.tensor(alpha, device=cuda)
    y = KM.fused_int8_matmul(xt, eye, None, at, 1.0, qlvl)
    torch.cuda.synchronize()
    nan = torch.isnan(xt)
    assert torch.equal(y[~nan], act_codes(xt, at, qlvl)[~nan].float())
    top = float(qlvl - 1)
    want = {float("nan"): 0.0, float("inf"): top if alpha > 0 else 0.0,
            float("-inf"): 0.0 if alpha > 0 else top}
    for v, code in want.items():
        at_v = nan if v != v else xt.float() == v
        assert int(at_v.sum()) > 0
        assert torch.equal(y[at_v], torch.full_like(y[at_v], code)), v


@pytest.mark.cuda
def test_cuda_k3_alpha_and_scale_kinds_agree(cuda):
    """alpha as a Python number, a CPU tensor, a card tensor and a card
    tensor of another dtype; the per-tensor scale as a number, a 0-d and a
    one-element card tensor and expanded to (N,): the same y."""
    x, codes, b, alpha, _ = k3_case(700, 32, 64, "bf16", False, True, "",
                                    device=cuda)
    s = 0.0371
    st = torch.tensor(s, device=cuda)
    ys = [KM.fused_int8_matmul(x, codes, b, a, st, NA)
          for a in (1.1, torch.tensor(1.1), alpha,
                    alpha.double().reshape(1))]
    ys += [KM.fused_int8_matmul(x, codes, b, alpha, sc, NA)
           for sc in (s, st.reshape(1), st.expand(64).contiguous(),
                      torch.tensor(s))]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    assert torch.equal(ys[0], KM.fused_int8_matmul_reference(
        x, codes, b, alpha, st, NA))


@pytest.mark.cuda
def test_cuda_k3_call_replays_in_a_cuda_graph(cuda):
    """A lean call (packed weights, alpha and a 0-d scale on the card) is
    captured in a CUDA graph, and its replay equals the eager call."""
    x, codes, b, alpha, _ = k3_case(4096, 128, 64, "bf16", False, True, "",
                                    device=cuda)
    scale = torch.tensor(0.0371, device=cuda)
    wp = KM.pack_weights_1x1(codes)
    eager = KM.fused_int8_matmul(x, codes, b, alpha, scale, NA, wp)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = KM.fused_int8_matmul(x, codes, b, alpha, scale, NA, wp)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=["-".join(map(str, c)) for c in MATMUL_CASES])
def test_cuda_k4_matches_plain(case, cuda):
    c = matmul_case(*case)
    x, t = _matmul_args(c, cuda)
    args = (x, t(c["w"]), t(c["bias"]), t(c["alpha"]), NA)
    before = KM.fused_qact_matmul.launches
    got = KM.fused_qact_matmul(*args)
    ref = KM.fused_qact_matmul_reference(*args)
    torch.cuda.synchronize()
    assert KM.fused_qact_matmul.launches == before + 1
    assert got.dtype == ref.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# K4 cases at the edges of its tiling (run on the card only): (M, K, N, x
# dtype, bias, layout).  M is a number or "tile-1" / "tile+1", one row short
# of or past the plan's row tile.  Layout "slice": x is a column slice of an
# (M, K + 1) array; "offset": a contiguous x whose data starts 1 element
# past an allocation (the element-load staging); "zero-row": rows of x at
# or below 0, clipped to 0 by alpha, so their y is the bias.
K4_CASES = [
    (1, 1, 1, "f32", True, ""),
    (1, 12, 3, "bf16", False, ""),
    ("tile-1", 32, 32, "bf16", True, ""),
    ("tile+1", 64, 32, "f32", False, "zero-row"),
    ("tile-1", 64, 64, "f32", True, ""),
    ("tile+1", 32, 64, "bf16", True, "zero-row"),
    (4097, 128, 256, "bf16", True, ""),
    (4097, 256, 128, "f32", False, ""),
    ("tile+1", 128, 128, "bf16", False, "slice"),
    (4097, 264, 264, "f32", True, "slice"),
    (4097, 12, 256, "bf16", True, ""),
    ("tile-1", 264, 3, "bf16", True, "zero-row"),
    (4097, 1, 64, "f32", True, ""),
    (1, 256, 264, "bf16", False, "slice"),
    ("tile+1", 128, 1, "f32", True, "offset"),
    (4097, 64, 128, "bf16", True, "offset"),
    ("tile-1", 256, 256, "f32", False, "offset"),
    (4097, 32, 32, "f32", False, ""),
]


def k4_case(m, k, n, dtype, with_bias, layout, device, seed=0):
    """The inputs of one K4 call on ``device``: (x, w, bias, alpha)."""
    bf16 = dtype == "bf16"
    if isinstance(m, str):
        bm = KM._k4_plan(1 << 20, k, n, bf16).bm
        m = bm - 1 if m == "tile-1" else bm + 1
    rng = np.random.RandomState(seed + k + n)
    x = (rng.randn(m, k + 1) * 0.7).astype(np.float32)
    if layout == "zero-row":
        x[0] = -np.abs(x[0])
        x[m // 2] = 0.0
    dt = torch.bfloat16 if bf16 else torch.float32
    full = torch.from_numpy(x).to(device, dt)
    if layout == "slice":
        x = full[:, 1:]
    elif layout == "offset":
        x = full.reshape(-1)[1:m * k + 1].view(m, k)
        assert x.data_ptr() % 16 and x.is_contiguous()
    else:
        x = full[:, :k].contiguous()
    w = torch.from_numpy((rng.randn(k, n) * 0.2).astype(np.float32))
    b = torch.from_numpy(rng.randn(n).astype(np.float32))
    return (x, w.to(device), b.to(device) if with_bias else None,
            torch.tensor(1.1, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES,
                         ids=["-".join(map(str, c)).rstrip("-")
                              for c in K4_CASES])
def test_cuda_k4_tiles_match_plain(case, cuda):
    x, w, b, alpha = k4_case(*case, device=cuda)
    before = KM.fused_qact_matmul.launches
    got = KM.fused_qact_matmul(x, w, b, alpha, NA)
    ref = KM.fused_qact_matmul_reference(x, w, b, alpha, NA)
    torch.cuda.synchronize()
    assert KM.fused_qact_matmul.launches == before + 1
    assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if case[-1] == "zero-row":  # clipped to 0: the bias (or 0) exactly
        want = torch.zeros_like(got[0]) if b is None else b
        assert torch.equal(got[0], want)
        assert torch.equal(got[x.shape[0] // 2], want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1500, 64, 32, "bf16", True, ""),
                                  (1500, 32, 64, "f32", False, "slice"),
                                  (700, 128, 256, "bf16", True, ""),
                                  (700, 256, 128, "f32", True, "offset")],
                         ids=["64x32", "32x64", "128x256", "256x128"])
def test_cuda_k4_every_tiling_matches_plain(case, cuda):
    """Every tiling that the plan chooses among, not only its choice."""
    x, w, b, alpha = k4_case(*case, device=cuda)
    ref = KM.fused_qact_matmul_reference(x, w, b, alpha, NA)
    m, k = x.shape
    plans = [p for _, p in KM._k4_candidates(m, k, w.shape[1],
                                             x.dtype == torch.bfloat16)]
    assert len(plans) >= 2
    for plan in plans:
        got = KM._launch_f32(x, w, b, alpha, NA, plan=plan)
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), plan


@pytest.mark.cuda
@pytest.mark.parametrize("qlvl,alpha", [(2, 1.1), (4, 1.1), (4, 0.37),
                                        (16, 2.5), (255, 0.9), (256, 0.9),
                                        (300, 1.3), (4, -0.8)])
def test_cuda_k4_fake_quant_is_exact(qlvl, alpha, cuda):
    """With identity weights y is fq(x) itself: equal to the plain
    fake-quant bit for bit (up to the sign of zero) for x at and one float
    either side of every code's tie, at the clip, and random: 2 and 4
    levels by thresholds, more levels or a negative alpha by the divides."""
    from efficientq_tpu_torch.quant import fake_quant_act

    rng = np.random.RandomState(qlvl)
    d = np.float32(1.0 / (qlvl - 1))
    mids = (np.arange(qlvl, dtype=np.float32) + np.float32(0.5)) * d
    mids = (mids * np.float32(abs(alpha))).astype(np.float32)
    near = np.concatenate([np.nextafter(mids, -np.inf), mids,
                           np.nextafter(mids, np.inf)])
    edges = np.float32([0.0, -0.0, abs(alpha), -abs(alpha), 1e-38, 3e38,
                        np.inf, -np.inf, np.nan])
    x = np.concatenate([near, edges, (rng.randn(4096) * abs(alpha))
                        .astype(np.float32)])
    x = np.resize(x, (-(-x.size // 64), 64)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    a = torch.tensor(alpha, device=cuda)
    y = KM.fused_qact_matmul(xt, torch.eye(64, device=cuda), None, a, qlvl)
    want = fake_quant_act(xt, a, qlvl)
    torch.cuda.synchronize()
    finite = torch.isfinite(xt)  # the kernel's clip takes NaN to code 0
    assert torch.equal(y[finite], want[finite])
    assert not bool(torch.isnan(y).any())


@pytest.mark.cuda
def test_cuda_k4_alpha_by_value_and_on_the_card(cuda):
    """alpha as a Python number, a CPU tensor and a card tensor of another
    dtype: the same y."""
    x, w, b, alpha = k4_case(700, 32, 64, "bf16", True, "", device=cuda)
    ys = [KM.fused_qact_matmul(x, w, b, a, NA)
          for a in (1.1, torch.tensor(1.1), alpha,
                    alpha.double().reshape(1))]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


@pytest.mark.cuda
def test_cuda_qmatmul_rejects_mismatched_shapes(cuda):
    x = torch.zeros(8, 12, device=cuda)
    codes = torch.zeros(12, 4, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="weight codes"):
        KM.fused_int8_matmul(x, codes[:8], None, 1.0, 1.0, NA)
    with pytest.raises(ValueError, match="scale"):
        KM.fused_int8_matmul(x, codes, None, 1.0,
                             torch.ones(3, device=cuda), NA)
    with pytest.raises(ValueError, match="weights"):
        KM.fused_qact_matmul(x, codes.float()[:8], None, 1.0, NA)
    with pytest.raises(ValueError, match="float32 or bfloat16 x"):
        KM.fused_qact_matmul(x.half(), codes.float(), None, 1.0, NA)


@pytest.mark.cuda
def test_cuda_mixed_k4_slice_matches_plain_k4(cuda):
    """The mixed deployment with ``include_1x1`` on the s2d bf16 path: K2,
    K1 and K4 against the same slice with the plain K4."""
    fg, fv = small_net(1, 1.0)
    mg, mv = to_int8_inference(fg, fv, only_kernel_sizes={(3, 3, 3)})
    pg = KM.to_pallas_inference(mg, include_1x1=True)
    n_k4 = _live_1x1_flags(pg)
    assert n_k4 > 0
    images, _ = synthetic.make_subject(np.random.default_rng(1), "brats",
                                       (39, 48, 48))
    vol = np.stack(list(images.values()), -1)[None]
    kw = dict(multilabel=True, heads=slice(-1, None), device=cuda)
    before = KM.fused_qact_matmul.launches
    got = deploy.make_s2d_volume_inferencer(pg, mv, **kw)(
        None, vol, (32, 32, 32), (8, 8, 8))
    assert KM.fused_qact_matmul.launches - before == n_k4  # 1 forward
    ref = deploy.make_s2d_volume_inferencer(
        pg, mv, kernels=WRAPPERS._replace(
            qact_matmul=KM.fused_qact_matmul_reference), **kw)(
        None, vol, (32, 32, 32), (8, 8, 8))
    assert got.shape == (1, 1, 39, 48, 48, 3) and got.dtype == torch.uint8
    assert float((got == ref).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True], ids=["unw", "att"])
def test_cuda_gram_stats_are_exact_float32(weighted, cuda):
    """The float32 Grams on the card against float64 Grams of the same
    inputs on the card: within 1e-5, which TF32's 10-bit mantissa would
    miss by two orders."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.abs(rng.standard_normal((2, 12, 14, 10, 16)))
                         .astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.standard_normal((2, 12, 14, 10, 8))
                         .astype(np.float32)).to(cuda)
    att = (torch.rand(2, 12, 14, 10, device=cuda) + 0.5 if weighted
           else None)
    geo = ((3, 3, 3), (1, 1, 1), (1, 1, 1))
    with ops.exact_f32():
        got = solver.compute_gram_stats(x, y, att, *geo,
                                        max_chunk_elems=1 << 18)
        want = solver.compute_gram_stats(
            x.double(), y.double(), None if att is None else att.double(),
            *geo)
    for name in ("A_att", "B_att", "A_unw", "B_unw", "yy_att", "yy_unw"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == torch.float32
        scale = float(w.abs().max())
        assert float((g.double() - w).abs().max()) <= 1e-5 * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("lo,num_lvl", [(0.0, 4), (-1.0, 4), (-1.0, 256)])
def test_cuda_project_by_iter_matches_cpu(lo, num_lvl, cuda):
    v = np.random.default_rng(1).standard_normal((64, 3000)).astype(
        np.float32)
    v = np.abs(v) if lo == 0.0 else v * 0.1
    a_c, b_c = project_by_iter(torch.from_numpy(v), num_lvl, lo, 1.0)
    a_g, b_g = project_by_iter(torch.from_numpy(v).to(cuda), num_lvl, lo,
                               1.0)
    assert a_g.is_cuda and b_g.is_cuda
    assert abs(float(a_g) / float(a_c) - 1.0) <= 1e-6
    t = (np.clip(v / float(a_c), lo, 1.0) - lo) * (num_lvl - 1) / (1.0 - lo)
    free = np.abs(t - np.floor(t) - 0.5) > 1e-5
    np.testing.assert_array_equal(b_g.cpu().numpy()[free], b_c.numpy()[free])


def _chip_smoke():
    """chip_smoke.py (at the repository's root), loaded by its path: its
    tiny-fixture calibration and outcome helpers."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_cuda_run_ptq_matches_cpu(cuda):
    """The tiny fixture of tests/test_ptq_e2e.py calibrated on the card
    lies within the CPU tests' tolerances (codes equal on >= 0.99, layer
    losses within 1e-2, alpha_act within 1e-5, argmax >= 0.99, class
    counts equal) of one of the outcomes the CPU itself reaches when its
    Grams are perturbed at float32 rounding level (1e-7): ADMM projects
    onto the grid at every step, so the fixture has several equally valid
    outcomes (on the CPU alone: layer losses 16 % and alpha_act 9.7 %
    apart), and the card's rounding picks one of them."""
    cs = _chip_smoke()
    fg, qv, rep = cs.tiny_calibration(cuda)
    assert rep.output_q.is_cuda and qv["params"][fg.qconv_nodes()[0].name][
        "kernel"].is_cuda
    card = cs.tiny_outcome((fg, qv, rep))
    cpu = cs.cpu_rounding_outcomes()
    best = max(cpu, key=lambda o: cs.outcome_gaps(card, o)[0])
    assert cs.within_cpu_tolerances(*cs.outcome_gaps(card, best))


@pytest.mark.cuda
def test_cuda_run_ptq_holds_exact_f32(cuda, monkeypatch):
    """TF32 is off at every layer of the sweep on the card, and the
    caller's flags come back."""
    seen = []
    real = engine.calibrate_layer

    def spy(*a, **k):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(engine, "calibrate_layer", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _chip_smoke().tiny_calibration(cuda)
    assert len(seen) == 10 and all(f == (False, False) for f in seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def _batches(n, shape=(2, 4, 40, 48, 56), seed=0):
    """``n`` host arrays, float32 images and uint8 label maps in turn, so
    that the staging buffers are reused at two sizes and dtypes."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) if i % 2 == 0 else
            rng.integers(0, 3, shape[:1] + shape[2:]).astype(np.uint8)
            for i in range(n)]


@pytest.mark.cuda
def test_cuda_device_feed_gives_host_batches_in_order(cuda):
    """Every array reaches the card equal to the host's, in order,
    including a larger one than the staging buffers held."""
    from efficientq_tpu_torch.data.prefetch import device_feed

    batches = _batches(8) + _batches(4, shape=(3, 4, 40, 48, 60), seed=1)
    got = list(device_feed(batches, device=cuda))
    assert len(got) == len(batches)
    for x, a in zip(got, batches):
        assert x.is_cuda and x.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(x.cpu().numpy(), a)


def _one_side_stream(monkeypatch, cuda):
    """The stream every device feed of the test uploads on."""
    from efficientq_tpu_torch.data import prefetch

    side = torch.cuda.Stream(cuda)
    monkeypatch.setattr(prefetch, "_side_stream", lambda device: side)
    return side


@pytest.mark.cuda
def test_cuda_device_feed_copies_on_a_side_stream(cuda, monkeypatch):
    """The upload runs on the feed's side stream, not behind the caller's:
    with the caller's stream busy in a sleep kernel, the first batch
    arrives on the card (read on a third stream) while the caller's stream
    still runs."""
    from efficientq_tpu_torch.data.prefetch import device_feed

    batches = _batches(6)
    other = torch.cuda.Stream(cuda)
    side = _one_side_stream(monkeypatch, cuda)
    # warm the pinned and device caches, so that no allocation call can
    # wait for the sleep below
    list(device_feed(batches, device=cuda))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e9))  # about 1.5-2 s on the caller's stream
    feed = device_feed(batches, device=cuda)
    x = next(feed)
    assert side != torch.cuda.current_stream(cuda)
    time.sleep(0.3)
    with torch.cuda.stream(other):
        y = x.clone()
    other.synchronize()
    assert not torch.cuda.current_stream(cuda).query()
    np.testing.assert_array_equal(y.cpu().numpy(), batches[0])
    torch.cuda.synchronize()
    list(feed)


@pytest.mark.cuda
def test_cuda_device_feed_keeps_staging_until_uploaded(cuda, monkeypatch):
    """With the upload stream held back, the host must not refill a
    staging buffer before the upload that reads it has run: each batch on
    the card equals its own host batch, not a later one."""
    from efficientq_tpu_torch.data.prefetch import device_feed

    batches = _batches(10)
    side = _one_side_stream(monkeypatch, cuda)
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e9))
    got = list(device_feed(batches, device=cuda))
    torch.cuda.synchronize()
    for x, a in zip(got, batches):
        np.testing.assert_array_equal(x.cpu().numpy(), a)


@pytest.mark.cuda
def test_cuda_validate_seg_pipeline_equals_one_volume_at_a_time(cuda):
    """validate_seg's 1-deep pipeline (pinned side-stream upload, readback
    on a second side stream before the next volume's kernels) gives the
    predictions and metrics of serving each volume alone, on K1."""
    from efficientq_tpu_torch.data.datasets import Loader
    from efficientq_tpu_torch.data.labels import split_label_brats
    from efficientq_tpu_torch.eval.metrics import SegMetricMC
    from efficientq_tpu_torch.eval.validate import validate_seg

    dg, net, _, kw = _serve_int8(cuda)
    kw = dict(kw, heads=None)
    subjects = [synthetic.make_subject(np.random.default_rng(s), "brats",
                                       (36, 40, 44)) for s in range(4)]
    data = [(np.stack(list(img.values())), split_label_brats(lab))
            for img, lab in subjects]
    n_mo = len(dg.outputs)
    got = []

    def recording(*a):
        out = infer(*a)
        got.append(out)
        return out

    infer = sliding.make_volume_inferencer(dg, capture=False, **kw)
    before = K.qconv3x3_int8_ndhwc.launches
    sm = validate_seg(dg, net.variables, Loader(data), None, n_mo, 3,
                      patch_size=(32, 32, 32), overlap=(8, 8, 8),
                      mode="quantized", infer=recording, device=cuda)
    assert K.qconv3x3_int8_ndhwc.launches > before
    want = [SegMetricMC(3) for _ in range(n_mo)]
    for (img, lab), pred in zip(data, got):
        x = torch.from_numpy(np.moveaxis(img, 0, -1)[None]).to(cuda)
        one = infer(net.variables, x, (32, 32, 32), (8, 8, 8))
        assert torch.equal(one, pred)
        for i in range(-n_mo, 0):
            want[i].evaluate_append_pred(
                np.moveaxis(one[i, 0].cpu().numpy(), -1, 0), lab, True)
    assert len(got) == 4
    for a, b in zip(sm, want):
        assert a.get_metric() == b.get_metric()


# ---------------------------------------------------------------------------
# training (train/trainer.py, nnir.apply(train=True, remat=), ops)

TRAIN_NET = dict(num_mod=2, num_classes=3, depth_config=[1, 1, 1],
                 width_config=[8, 16, 8], dilation_config=[1, 1, 1],
                 init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid",
                 ds="simple", ds_depth_limit=3)


def _train_batch(seed=0, n=2, size=16):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 2, size, size, size).astype(np.float32)
    y = rs.randint(0, 3, (n, size, size, size))
    return torch.from_numpy(x), torch.from_numpy(y)


def _one_step(device, root, **kw):
    from types import SimpleNamespace

    from efficientq_tpu_torch.train import Trainer

    g = build_uresq(UResQConfig(**TRAIN_NET))
    tr = Trainer(g, nnir.init(g, 0, device="cpu"),
                 SimpleNamespace(trainloader=[None]), loss_name="hybrid",
                 num_mo=len(g.outputs), n_class=3, base_lr=0.01, max_epoch=1,
                 snapshot_root=str(root), device=device, **kw)
    x, y = _train_batch()
    loss, _ = tr.train_step(x.to(device), y.to(device))
    grads = {k: t.grad.detach().cpu() for k, t in tr._leaves.items()}
    state = {n: {k: v.cpu() for k, v in s.items()}
             for n, s in tr.variables["state"].items()}
    return float(loss), grads, state


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda, tmp_path):
    """One train step (forward, loss, backward) on the card in exact
    float32 against the CPU's on the same weights and batch: the loss
    within rtol 1e-5, every gradient within 1e-5 + 1e-4 of its leaf's
    largest entry, the new BN running stats within rtol 1e-5."""
    cpu = _one_step("cpu", tmp_path / "cpu")
    card = _one_step(cuda, tmp_path / "card", tf32=False)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for k, g in cpu[1].items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(card[1][k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 + 1e-4 * scale, err_msg=k)
    for n, s in cpu[2].items():
        for k in s:
            np.testing.assert_allclose(card[2][n][k].numpy(), s[k].numpy(),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_cuda_remat_and_dropout_masks(cuda, monkeypatch):
    """At dropout 0.5 on the card: remat=3 gives the plain forward's heads
    bit for bit (the same masks), with deterministic cuDNN; the gradients
    within 1e-5 of each leaf's largest entry, the smoke's tolerance for
    the same check: the CUDA backwards of max pooling and trilinear
    upsampling add with atomics, so the gradients vary from run to run
    (measured up to 1.15e-6 here, 1.435e-6 in the smoke); and the masks
    are the CPU's (the heads within 1e-4)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    g = build_uresq(UResQConfig(**dict(TRAIN_NET, drop_rate=0.5)))
    assert any(n.op == "dropout" for n in g.nodes)
    x, y = _train_batch(seed=1)
    runs = {}
    for name, device, remat in (("plain", cuda, 0), ("remat", cuda, 3),
                                ("cpu", "cpu", 0)):
        v = nnir.init(g, 0, device=device)
        leaves = {f"{n}.{k}": t.requires_grad_()
                  for n, e in v["params"].items() for k, t in e.items()}
        out, _ = nnir.apply(g, v, ops.ncdhw_to_ndhwc(x.to(device)),
                            train=True, seed=5, remat=remat)
        with ops.exact_f32():
            out.float().square().mean().backward()
        runs[name] = (out.detach().cpu(),
                      {k: t.grad.cpu() for k, t in leaves.items()})
    assert torch.equal(runs["plain"][0], runs["remat"][0])
    for k, gp in runs["plain"][1].items():
        scale = float(gp.abs().max())
        assert float((runs["remat"][1][k] - gp).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(runs["plain"][0], runs["cpu"][0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_tie_gradients_match_cpu(cuda):
    """``ops.relu`` and ``quant.clip`` on the card, whose numeric bounds
    reach the CUDA op as 0-d CPU tensors: the CPU's values and gradients,
    half the gradient at each tie, as ``jnp.maximum`` and ``jnp.clip``."""
    from efficientq_tpu_torch import quant

    for fn in (ops.relu, lambda t: quant.clip(t, 0.0, 1.0)):
        out = {}
        for dev in ("cpu", cuda):
            t = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0], device=dev,
                             requires_grad=True)
            y = fn(t)
            y.sum().backward()
            out[dev] = (y.detach().cpu(), t.grad.cpu())
        assert torch.equal(out["cpu"][0], out[cuda][0])
        assert torch.equal(out["cpu"][1], out[cuda][1])
        assert 0.5 in out[cuda][1].tolist()


@pytest.mark.cuda
def test_cuda_batch_norm_train_matches_cpu(cuda):
    rs = np.random.RandomState(2)
    args = [torch.from_numpy(a) for a in (
        (rs.randn(2, 8, 9, 10, 16) * 3 + 1).astype(np.float32),
        rs.rand(16).astype(np.float32) + 0.5,
        rs.randn(16).astype(np.float32),
        rs.randn(16).astype(np.float32) * 0.1,
        rs.rand(16).astype(np.float32) + 0.5)]
    want = ops.batch_norm_train(*args)
    got = ops.batch_norm_train(*[a.to(cuda) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the serving extras: the captured inferencers (eval/sliding.py), K1-K4 as
# registered operators (kernels/library.py), artifacts (export.py) and the
# autotuner (eval/autotune.py)

def _launch_counts():
    return (K.qconv3x3_int8_ndhwc.launches, K2.stem_s2d_conv.launches,
            KM.fused_int8_matmul.launches, KM.fused_qact_matmul.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,pb", [("patch", 2), ("column", 2),
                                     ("patch", 3), ("patch", 8)],
                         ids=["patch", "column", "patch-ragged-b3",
                              "patch-one-chunk-b8"])
def test_cuda_captured_int8_equals_eager(grid, pb, cuda):
    """The captured int8 float32 path equals the eager one bit for bit on
    every call, and the launch counts are the eager path's: 6 K1 per
    forward.  The full chunk is captured once, when it comes a second time
    in a row (in the first volume, or in the second where a volume is one
    chunk), and replayed after; a ragged last chunk runs eagerly."""
    dg, net, vol, kw = _serve_int8(cuda)
    kw = dict(kw, patch_batch=pb, serve_grid=grid,
              stride_div=8 if grid == "column" else None)
    eager = sliding.make_volume_inferencer(dg, capture=False, **kw)
    infer = sliding.make_volume_inferencer(dg, **kw)
    want = eager(net.variables, vol, (32, 32, 32), (8, 8, 8))
    n = len(sliding.patch_grid(
        (40 if grid == "column" else 36, 40, 44),
        (40, 32, 32) if grid == "column" else 32,
        (0, 8, 8) if grid == "column" else 8))
    forwards = -(-n // pb)
    for i in range(3):
        before = K.qconv3x3_int8_ndhwc.launches
        got = infer(net.variables, vol, (32, 32, 32), (8, 8, 8))
        torch.cuda.synchronize()
        assert K.qconv3x3_int8_ndhwc.launches - before == 6 * forwards
        assert torch.equal(got, want)
        assert infer.captured.captures == (1 if i or n // pb > 1 else 0)


@pytest.mark.cuda
def test_cuda_captured_s2d_equals_eager(cuda):
    """The s2d bf16 path with its patch forward captured equals the same
    path run eagerly (``capture=False``), bit for bit; 1 K2 and 6 K1
    launches a forward, on the capture and on replays."""
    fg, fv = small_net(1, 1.0)
    dg, dv = to_int8_inference(fg, fv)
    images, _ = synthetic.make_subject(np.random.default_rng(1), "brats",
                                       (39, 48, 48))
    vol = np.stack(list(images.values()), -1)[None]
    kw = dict(multilabel=True, heads=slice(-1, None), device=cuda,
              patch_batch=4)
    infer = deploy.make_s2d_volume_inferencer(dg, dv, **kw)
    forwards = -(-len(sliding.patch_grid((39, 48, 48), 32, 8)) // 4)
    assert forwards == 2
    outs = []
    for _ in range(2):
        k1, k2 = K.qconv3x3_int8_ndhwc.launches, K2.stem_s2d_conv.launches
        outs.append(infer(None, vol, (32, 32, 32), (8, 8, 8)))
        assert K2.stem_s2d_conv.launches - k2 == forwards
        assert K.qconv3x3_int8_ndhwc.launches - k1 == 6 * forwards
    assert infer.captured.captures == 1
    eager = deploy.make_s2d_volume_inferencer(dg, dv, capture=False, **kw)
    assert eager.captured is None
    want = eager(None, vol, (32, 32, 32), (8, 8, 8))
    for got in outs:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_captured_follows_changed_variables(cuda):
    """No replay on stale weights: an in-place change of alpha_act, and a
    new variable set, are each followed by a capture of their own and the
    eager result."""
    dg, net, vol, kw = _serve_int8(cuda)
    infer = sliding.make_volume_inferencer(dg, **kw)
    eager = sliding.make_volume_inferencer(dg, capture=False, **kw)
    v = net.variables
    args = (vol, (32, 32, 32), (8, 8, 8))
    first = infer(v, *args)
    assert torch.equal(first, eager(v, *args))
    assert infer.captured.captures == 1  # 4 chunks of 2: the 2nd captured
    node = next(n.name for n in dg.nodes if n.attrs.get("pallas"))
    v["params"][node]["alpha_act"].mul_(0.5)  # in place
    changed = infer(v, *args)
    assert torch.equal(changed, eager(v, *args))
    assert not torch.equal(changed, first)
    v2 = {g: {n: {k: t.clone() for k, t in e.items()}
              for n, e in v[g].items()} for g in v}
    v2["params"][node]["alpha_act"].mul_(3.0)
    third = infer(v2, *args)
    assert torch.equal(third, eager(v2, *args))
    assert not torch.equal(third, changed)
    v["params"][node]["alpha_act"].mul_(2.0)  # back to the first set
    assert torch.equal(infer(v, *args), first)
    assert infer.captured.captures == 4


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["plain-c8", "quant-c8", "residual-relu-c8",
                                  "pool-even-c4", "xq-res-relu-pool-c8-dil2",
                                  "per-channel-c8"])
def test_cuda_k1_operator_equals_wrapper(name, bf16, cuda):
    """effq::qconv3x3_int8 (through its adapter) launches K1 once and
    equals the wrapper's call, every output."""
    from efficientq_tpu_torch.kernels import library

    case = make_case(sorted(CASES).index(name), **CASES[name])
    before = K.qconv3x3_int8_ndhwc.launches
    got = run_port(case, library.qconv3x3_int8, device=cuda, bf16=bf16)
    assert K.qconv3x3_int8_ndhwc.launches == before + 1
    want = run_port(case, device=cuda, bf16=bf16)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_k2_k3_k4_operators_equal_wrappers(cuda):
    from efficientq_tpu_torch.kernels import library

    x, par, we, wo, bias = stem_inputs(23, 4, 8, cuda)
    alpha = torch.tensor(0.7, device=cuda)
    for g, w in zip(library.stem_s2d_conv(x, par, we, wo, bias, alpha, 4,
                                          torch.bfloat16),
                    K2.stem_s2d_conv(x, par, we, wo, bias, alpha, 4,
                                     torch.bfloat16)):
        assert torch.equal(g, w)
    c = matmul_case(*MATMUL_CASES[0])
    xm, t = _matmul_args(c, cuda)
    args = (xm, t(c["codes"]), t(c["bias"]), t(c["alpha"]), t(c["scale"]), NA)
    assert torch.equal(library.fused_int8_matmul(*args),
                       KM.fused_int8_matmul(*args))
    args = (xm, t(c["w"]), t(c["bias"]), t(c["alpha"]), NA)
    before = _launch_counts()
    assert torch.equal(library.fused_qact_matmul(*args),
                       KM.fused_qact_matmul(*args))
    assert _launch_counts()[3] - before[3] == 2


@pytest.mark.cuda
def test_cuda_artifact_equals_captured_path(cuda, tmp_path):
    """An artifact exported on the card (K1 as effq::qconv3x3_int8) serves
    what the captured inferencer serves, replaying its program from CUDA
    graphs with the K1 launches of the direct path."""
    from efficientq_tpu_torch import export

    dg, net, vol, kw = _serve_int8(cuda)
    ep, batch = export.export_patch_model(dg, net.variables, (32, 32, 32),
                                          4, patch_batch=2, device=cuda)
    path = str(tmp_path / "a.zip")
    export.save_serving_artifact(path, ep, {"batch": batch,
                                            "patch_size": [32, 32, 32]})
    art = export.load_serving_artifact(path)
    art.check_platform(cuda)
    with pytest.raises(RuntimeError, match="cuda"):
        art.check_platform("cpu")
    infer = art.volume_inferencer(patch_batch=2, multilabel=True)
    want = sliding.make_volume_inferencer(dg, **kw)(
        net.variables, vol, (32, 32, 32), (8, 8, 8))
    forwards = -(-len(sliding.patch_grid((36, 40, 44), 32, 8)) // 2)
    for _ in range(2):
        before = K.qconv3x3_int8_ndhwc.launches
        got = infer(None, vol, (32, 32, 32), (8, 8, 8))
        torch.cuda.synchronize()
        assert K.qconv3x3_int8_ndhwc.launches - before == 6 * forwards
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_autotune_sweeps_then_hits_the_cache(cuda, tmp_path,
                                                  monkeypatch, capsys):
    from efficientq_tpu_torch.eval import autotune

    monkeypatch.setenv("EFFQ_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    dg, net, vol, _ = _serve_int8(cuda)
    kw = dict(mode="quantized", heads=slice(-1, None))
    pb = autotune.choose_patch_batch(dg, net.variables, vol, 32, 8,
                                     tune="force", **kw)
    out = capsys.readouterr().out
    n = len(sliding.patch_grid((36, 40, 44), 32, 8))
    assert pb in autotune._candidates(n) and "-> patch_batch" in out
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})  # the disk entry

    def boom(*a, **k):
        raise AssertionError("measured on a cache hit")

    monkeypatch.setattr(sliding, "make_volume_inferencer", boom)
    assert autotune.choose_patch_batch(dg, net.variables, vol, 32, 8,
                                       tune="auto", **kw) == pb
