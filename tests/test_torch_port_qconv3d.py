"""K1 (the int8 3^3 conv with fused epilogues): the port's plain version
against the JAX package's Pallas kernel (interpret mode) and its XLA
realization ``_xla_qconv3x3``.  The cases are shared with
test_torch_port_cuda.py, which holds the CUDA kernel against the plain
version on a card.

K1's input quantizer (its pass for a float input) is emulated step by
step in NumPy float32 and by its thresholds, and held equal to
``act_codes``; the benchmark's served graphs are read for which K1 nodes
take a float input (nine in LiTS, none in SegResNet).

Tolerances.  int8 outputs are compared exactly.  float32 outputs equal
``_xla_qconv3x3`` exactly: the port computes the same ops in the same
order (exact integer accumulation, then ``* scale`` and ``+ bias`` rounded
separately).  The interpret-mode Pallas kernel is compiled by XLA's CPU
backend, which fuses ``acc * scale + bias`` into one FMA, so there the
float32 outputs agree to within 1 ulp of the largest operand of that
multiply-add (and of the residual add after it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu.pallas.qconv3d import _xla_qconv3x3
from efficientq_tpu.pallas.qconv3d import qconv3x3_int8_ndhwc as jax_k1
from efficientq_tpu_torch.kernels import qconv3d as K
from efficientq_tpu_torch.kernels.build import SMEM_BLOCK, SMEM_SM, SMS
from efficientq_tpu_torch.quant import act_codes
from test_torch_port_cuda import (CASES, LITS_BLOCK1, NA, make_case,
                                  run_port, tie_dense)


def _jax(case):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = jax_k1(j(case["x"]), j(case["codes"]), j(case["bias"]),
                 jnp.float32(case["alpha"]), j(case["scale"]), NA,
                 interpret=True, residual=j(case["residual"]), **case["kw"])
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                         else (out,)))


def _xla(case):
    kw = case["kw"]
    x = jnp.asarray(case["x"])
    qa = x if kw["x_quantized"] else jnp.round(
        jnp.clip(x / case["alpha"], 0.0, 1.0) * (NA - 1)).astype(jnp.int8)
    res = None if case["residual"] is None else jnp.asarray(case["residual"])
    out = _xla_qconv3x3(qa, jnp.asarray(case["codes"]),
                        jnp.asarray(case["bias"]), jnp.asarray(case["scale"]),
                        kw["dilation"], jnp.float32, res, kw["residual_relu"],
                        jnp.float32(kw.get("quant_alpha", 1.0)),
                        kw.get("quant_qlvl", 0), kw["pool"])
    return tuple(np.asarray(o) for o in (out if isinstance(out, tuple)
                                         else (out,)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k1_matches_jax(name):
    case = make_case(sorted(CASES).index(name), **CASES[name])
    got, xla, pallas = run_port(case), _xla(case), _jax(case)
    assert [g.shape for g in got] == [r.shape for r in xla]
    # FMA bound for the interpret-mode kernel: 1 ulp of the largest operand
    bound = np.abs(case["bias"])
    if case["residual"] is not None:
        bound = bound + np.abs(case["residual"]).max()
    for g, x, p in zip(got, xla, pallas):
        assert g.dtype == x.dtype == p.dtype
        np.testing.assert_array_equal(g, x)
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, p)
        else:
            ulp = np.spacing((np.abs(g) + bound).astype(np.float32))
            assert np.all(np.abs(g - p) <= ulp), np.abs(g - p).max()


def test_pack_weights_layout():
    """packed[tap, o, c] holds input channel c of output channel o (the
    mma's B fragment runs along c); channels past C, up to the next
    multiple of 32, are zero."""
    rng = np.random.RandomState(0)
    codes = rng.randint(-7, 8, size=(3, 3, 3, 37, 2)).astype(np.int8)
    packed = K.pack_weights(torch.from_numpy(codes)).numpy()
    assert packed.shape == (27, 2, 64) and packed.dtype == np.int8
    flat = codes.reshape(27, 37, 2)
    np.testing.assert_array_equal(packed[:, :, :37],
                                  flat.transpose(0, 2, 1))
    assert not packed[:, :, 37:].any()


# (N, D, H, W, C, O, dilation): the flagship's 14 convs at the s2d batch
# (8) and the float32 batch (2), and odd, small and wide geometries
PLAN_CASES = [
    (8, 64, 64, 64, 32, 32, 1), (2, 64, 64, 64, 32, 32, 2),
    (8, 32, 32, 32, 64, 64, 1), (2, 32, 32, 32, 64, 64, 1),
    (8, 16, 16, 16, 128, 128, 1), (2, 16, 16, 16, 128, 128, 2),
    (8, 8, 8, 8, 256, 256, 1), (2, 8, 8, 8, 256, 256, 1),
    (1, 5, 6, 7, 3, 6, 1), (3, 1, 1, 1, 8, 3, 1), (2, 9, 9, 9, 40, 72, 2),
    (1, 3, 17, 2, 72, 40, 1), (4, 7, 13, 11, 256, 256, 3),
    (1, 6, 6, 6, 4, 6, 9), (8, 64, 64, 64, 32, 32, 40),
]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=["x".join(map(str, c)) for c in PLAN_CASES])
def test_tile_plan_covers_each_output_once(case):
    """Every output voxel and channel belongs to exactly one block; bricks
    are even and start on even coordinates, so no 2x2x2 pool cell spans
    two blocks; the grid and shared memory are what the launch takes."""
    n, d, h, w, c, o, dil = case
    plan = K._tile_plan(n, d, h, w, c, o, dil)
    gx, gy = plan.grid
    bz, by, bx = plan.brick
    assert (bz, by) in K._BRICKS and bx == 8
    assert plan.threads == (512 if plan.sums else bz * by * bx)
    assert plan.threads % 32 == 0
    assert plan.smem == K._smem_bytes(plan.brick, c, dil, plan.sums)
    assert plan.smem <= SMEM_BLOCK
    assert 1 <= gx <= plan.n_bricks == int(np.prod(plan.bricks))
    assert gy * plan.bn >= o > (gy - 1) * plan.bn
    owned = np.zeros((n, d, h, w), np.int32)
    for block in range(gx):
        for b in range(block, plan.n_bricks, gx):
            ni, z0, y0, x0 = K._brick_origin(plan, b)
            assert z0 % bz == y0 % by == x0 % bx == 0
            owned[ni, z0:z0 + bz, y0:y0 + by, x0:x0 + bx] += 1
    assert (owned == 1).all()  # each column tile walks the same bricks


def test_tile_plan_fills_the_card_at_the_flagship():
    """At the flagship's first stage the blocks fill every SM with the
    threads it holds and are the largest bricks (on the overlapped
    pipeline: one block of 512 threads an SM), and the widest convs still
    spread over every SM."""
    big = K._tile_plan(8, 64, 64, 64, 32, 32, 1)
    assert big.brick == (4, 8, 8) and big.sums == 2
    assert big.grid[0] >= SMS and big.grid[0] * big.threads >= SMS * 512
    for n in (2, 8):
        plan = K._tile_plan(n, 8, 8, 8, 256, 256, 1)
        assert plan.grid[0] * plan.grid[1] >= SMS


# the launch's own arithmetic (csrc/qconv3d_int8.cu, qconv3d_int8_launch),
# written out again: a stage is the halo's rows of 48 bytes (rounded up to
# 128) and, past one 32-channel chunk, the chunk's weights; taking turns a
# stage must also hold the brick's sums (rows of 36 words), overlapped
# the sums have buffers of their own, each with a float32 tile of the
# brick's residual, and the pipeline 8 mbarriers (128 bytes); one chunk's
# weights stay resident
def _launch_smem(brick, c, dil, sums):
    bz, by, bx = brick
    rows = 1
    for b in brick:
        rows *= b + 2 * min(dil, b)
    halo = (rows * 48 + 127) // 128 * 128
    chunks = -(-c // 32)
    loads = halo + (27 * 32 * 32 if chunks > 1 else 0)
    staged = bz * by * bx * 36 * 4
    stage = (max(loads, staged) if not sums else loads + 127) // 128 * 128
    tile = bz * by * bx * 32 * 4
    return (2 * stage + (0 if chunks > 1 else 27 * 32 * 32)
            + sums * (staged + tile) + (128 if sums else 0))


# (N, D, H, W, C, O, dilation) -> sums buffers of the plan (0: taking
# turns): blocks that walk many bricks (64^3 at C = 32, with the weights
# resident: two buffers; C > 32, chunked: one); a 2^3-brick-a-block grid at
# O = 128 and the grids just above and below it; bricks a block that
# differ by one; one buffer at C = 32 and dilation 2, none at C > 32 and
# dilation 2 or at dilation 3; the smaller bricks, and 4 x 8 bricks one a
# block
OVERLAP_CASES = [
    ((8, 64, 64, 64, 32, 32, 1), 2), ((8, 32, 32, 32, 64, 64, 1), 1),
    ((8, 16, 16, 16, 128, 128, 1), 1), ((5, 16, 16, 16, 128, 128, 1), 1),
    ((4, 16, 16, 16, 128, 128, 1), 0), ((1, 8, 24, 88, 128, 128, 1), 1),
    ((1, 8, 24, 80, 128, 128, 1), 0), ((3, 32, 32, 32, 32, 32, 2), 1),
    ((2, 32, 32, 32, 64, 64, 2), 0), ((2, 32, 32, 32, 32, 32, 3), 0),
    ((8, 8, 8, 8, 256, 256, 1), 0), ((8, 4, 4, 4, 512, 512, 1), 0),
    ((1, 32, 32, 32, 64, 64, 1), 0), ((8, 16, 24, 20, 256, 256, 1), 1),
    ((2, 9, 17, 33, 40, 72, 1), 1), ((1, 33, 31, 65, 3, 8, 1), 2),
]


@pytest.mark.parametrize("case,sums", OVERLAP_CASES,
                         ids=["x".join(map(str, c)) for c, _ in OVERLAP_CASES])
def test_tile_plan_takes_the_overlapped_pipeline(case, sums):
    """The 4 x 8 x 8 brick takes the overlapped pipeline where every block
    walks two or more bricks (n_bricks >= 2 grid[0]) and its shared memory
    fits: two sums buffers where they fit, else one.  Its footprint is the
    launch's arithmetic, its blocks one an SM (8 MMA warps, 4 epilogue
    warps and 4 producer warps), its grid every SM's block over the column
    tiles; the plans that take turns keep their footprint and blocks."""
    n, d, h, w, c, o, dil = case
    plan = K._tile_plan(*case)
    assert plan.sums == sums
    assert plan.smem == _launch_smem(plan.brick, c, dil, plan.sums)
    gy = plan.grid[1]
    if sums:
        assert plan.brick == (4, 8, 8) and plan.threads == 512
        assert plan.grid[0] == min(plan.n_bricks, SMS // gy)
        assert plan.n_bricks >= 2 * plan.grid[0]
        assert plan.smem <= SMEM_BLOCK
        assert sums == 2 or _launch_smem(plan.brick, c, dil, 2) > SMEM_BLOCK
        assert SMEM_SM // (plan.smem + 1024) >= 1
    else:
        per_sm = min(SMEM_SM // (plan.smem + 1024), 512 // plan.threads)
        assert plan.grid[0] == min(plan.n_bricks, SMS * max(1, per_sm) // gy)
        assert plan.brick != (4, 8, 8) or (
            plan.n_bricks < 2 * min(plan.n_bricks, SMS // gy)
            or _launch_smem(plan.brick, c, dil, 1) > SMEM_BLOCK)


def _lits_k1_shapes():
    """(D, H, W, C, O) of each K1 conv of the LiTS serving net at its
    patch: cubes of the voxels ``costs.served_convs`` counts (the patch
    over the stem's stride is 64^3)."""
    from bench_torch import costs

    out = []
    for conv in costs.served_convs(_bench_config("lits_uresq_w4a4.json")):
        if conv["k1"]:
            s = round(conv["vox"] ** (1 / 3))
            assert s ** 3 == conv["vox"]
            out.append((s, s, s, conv["cin"], conv["cout"]))
    return out


def _segresnet_k1_shapes():
    """(D, H, W, C, O) of each of SegResNet's 24 K1 convs at its patch."""
    from bench_torch import segresnet_model

    cfg = _bench_config("brats_segresnet_w4a4.json")
    return [(*(p >> c.level for p in cfg["patch"]), c.cin, c.cout)
            for c in segresnet_model.convs(cfg) if segresnet_model.on_k1(c)]


@pytest.mark.parametrize("net,patches,want", [
    ("lits", 8, 12), ("lits", 3, 8), ("lits", 1, 4), ("lits", 5, 12),
    ("segresnet", 8, 24), ("segresnet", 1, 24)])
def test_overlapped_launches_per_chunk(net, patches, want):
    """K1 launches that take the overlapped pipeline in one chunk, pinned:
    in a LiTS chunk of 8 the 12 convs of 64^3 x 32, 32^3 x 64 and
    16^3 x 128 of its 18 (8 of 18 in the fixed cell's ragged chunk of 3,
    as ``chip_smoke.py`` phase 12's volume ends); all 24 of SegResNet's."""
    shapes = _lits_k1_shapes() if net == "lits" else _segresnet_k1_shapes()
    assert len(shapes) == (18 if net == "lits" else 24)
    plans = [K._tile_plan(patches, *s, 1) for s in shapes]
    assert sum(p.sums > 0 for p in plans) == want


def test_captured_replays_add_the_overlapped_count(monkeypatch):
    """``kernels.COUNTERS`` lists ``overlapped_launches``, and a replay of
    a captured forward adds its forward's count (the CUDA graph faked:
    this machine has no card): an eager call, a capture and its replay,
    and a second replay count three forwards."""
    from efficientq_tpu_torch.eval import sliding
    from efficientq_tpu_torch.kernels import COUNTERS as counted

    class Graph:
        def replay(self):
            pass

    class Capture:
        def __init__(self, graph):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    fn = K.qconv3x3_int8_ndhwc
    assert (fn, "overlapped_launches") in counted

    def forward(v, x):  # as a chunk of K1 launches on the card counts
        fn.launches += 18
        fn.overlapped_launches += 12
        return x * v

    cf = sliding.CapturedForward(forward)
    cf.use(torch.tensor(2.0))
    before = (fn.launches, fn.overlapped_launches)
    try:
        for _ in range(3):
            cf(torch.ones(8, 2))
        assert cf.captures == 1
        assert (fn.launches - before[0],
                fn.overlapped_launches - before[1]) == (54, 36)
    finally:
        fn.launches, fn.overlapped_launches = before


def test_wrapper_dispatches_by_device():
    """CPU tensors take the plain version and count no launch."""
    case = make_case(0, **CASES["plain-c4-dil2"])
    before = K.qconv3x3_int8_ndhwc.launches
    np.testing.assert_array_equal(
        run_port(case)[0], run_port(case, K.qconv3x3_int8_ndhwc_reference)[0])
    assert K.qconv3x3_int8_ndhwc.launches == before
    assert K.qconv3x3_int8_ndhwc.prologue_quant_launches == 0
    with pytest.raises(ValueError, match="CUDA or"):
        K.qconv3x3_int8_ndhwc(torch.zeros(1, 2, 2, 2, 4, device="meta"),
                              torch.zeros(3, 3, 3, 4, 4, dtype=torch.int8),
                              None, 1.0, 1.0, NA)


# K1's input quantizer (csrc/act_code.cuh: act_code, code_threshold,
# quant_setup, code_of) emulated in NumPy float32, whose division and
# product round to nearest as the kernel's __fdiv_rn and __fmul_rn do


def prologue_product(x, alpha, qlvl):
    """act_code's value before it rounds: x divided by alpha, clamped to
    [0, 1], multiplied by qlvl - 1."""
    with np.errstate(over="ignore"):  # a quotient past float32: inf
        q = (np.float32(x) / np.float32(alpha)).astype(np.float32)
    q = np.minimum(np.maximum(q, np.float32(0.0)), np.float32(1.0))
    return (q * np.float32(qlvl - 1)).astype(np.float32)


def prologue_divide(x, alpha, qlvl):
    """act_code step by step: divide, clamp to [0, 1], multiply by
    qlvl - 1, round half to even."""
    return np.rint(prologue_product(x, alpha, qlvl))


def prologue_thresholds(alpha, qlvl):
    """quant_setup's thresholds: per code c the first of the 32 floats
    around fl(fl((c - 0.5) / (qlvl - 1)) * alpha) whose code reaches c,
    when the first does not; None where the kernel takes the divide (more
    than 4 levels, alpha outside [2^-60, 2^60], a window that misses)."""
    a, qmax = np.float32(alpha), np.float32(qlvl - 1)
    if qlvl > 4 or not 2.0 ** -60 <= alpha <= 2.0 ** 60:
        return None
    out = []
    for c in range(1, qlvl):
        mid = np.float32(np.float32(np.float32(c) - np.float32(0.5)) / qmax)
        mid = np.array([np.float32(mid * a)], np.float32).view(np.uint32)
        window = (mid + np.arange(32, dtype=np.uint32) - np.uint32(16)).view(
            np.float32)
        hit = prologue_divide(window, a, qlvl) >= c
        if not hit.any() or hit[0]:
            return None
        out.append(window[np.argmax(hit)])
    return out


def prologue_codes(x, alpha, qlvl):
    """code_of: the count of thresholds x reaches, else act_code."""
    t = prologue_thresholds(alpha, qlvl)
    if t is None:
        return prologue_divide(x, alpha, qlvl)
    return sum((x >= ti).astype(np.float32) for ti in t)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("qlvl,alpha", [(2, 1.1), (3, 1.1), (3, 0.5),
                                        (4, 4 / 3), (4, 0.37), (4, 1.0),
                                        (4, 3e-18), (16, 2.5), (4, -0.8)])
def test_prologue_quantizer_emulation_matches_act_codes(qlvl, alpha, bf16):
    """K1's prologue quantizer, emulated step by step in float32 (divide,
    clamp, multiply, round half to even) and by its thresholds, equals
    act_codes on a tie-dense grid: float32 x whose quotient and product
    land exactly on .5 ties (bfloat16 x, widened exactly, lands on them
    where alpha is a power of two and the levels 2 or 3), their
    neighbours, zeros, negatives and values past the clip."""
    rng = np.random.RandomState(qlvl)
    x = np.concatenate([tie_dense(alpha, qlvl, bf16), (rng.randn(4096) * abs(
        alpha)).astype(np.float32)])
    xt = torch.from_numpy(x)
    if bf16:
        xt = xt.to(torch.bfloat16)
        x = xt.float().numpy()
    want = act_codes(xt, torch.tensor(alpha), qlvl).numpy().astype(
        np.float32)
    np.testing.assert_array_equal(prologue_divide(x, alpha, qlvl), want)
    thresholds = prologue_thresholds(alpha, qlvl)
    assert (thresholds is not None) == (qlvl <= 4 and alpha > 0)
    np.testing.assert_array_equal(prologue_codes(x, alpha, qlvl), want)
    if alpha > 0 and (not bf16 or (qlvl in (2, 3)
                                   and np.log2(alpha) % 1 == 0)):
        v = prologue_product(x, alpha, qlvl)
        assert int((v - np.floor(v) == 0.5).sum()) >= qlvl - 1


def _bench_config(name):
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_torch", "configs", name)
    with open(path) as f:
        return json.load(f)


def test_lits_float_input_k1_nodes_are_the_nine_block1_convs():
    """In the LiTS serving graph K1 quantizes its own input at exactly the
    nine block1 convs (a float input that also feeds the residual, so no
    producer emits its codes): 9 of its 18 launches a forward add to
    ``prologue_quant_launches``; the block2 convs read block1's codes."""
    from bench_torch import program
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.models import build_uresq
    from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
    from efficientq_tpu_torch.ptq.deploy import serving_graph

    cfg = _bench_config("lits_uresq_w4a4.json")
    graph = build_uresq(program._config(cfg))
    dgraph, _ = to_int8_inference(*fold_bn(graph, nnir.init(
        graph, 0, device="cpu")))
    flags = program.k1_flags(serving_graph(dgraph))
    float_in = sorted(n for n, f in flags.items()
                      if not f["input_quantized"])
    assert len(flags) == 18
    assert float_in == [f"u_blocks.UResBlock{i}.Layer1.block1.conv"
                        for i in range(1, len(LITS_BLOCK1) + 1)]
    assert all(flags[n]["epilogue_quant_for"] == n.replace("block1",
                                                           "block2")
               for n in float_in)


def test_segresnet_k1_nodes_all_read_codes():
    """In SegResNet's serving graph K6 hands every K1 conv its codes, so
    no K1 launch quantizes a float input there."""
    from bench_torch import segresnet_program
    from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference

    cfg = _bench_config("brats_segresnet_w4a4.json")
    dgraph, _ = to_int8_inference(*fold_bn(
        *segresnet_program._graph_and_init(cfg)))
    flags = segresnet_program.k1_flags(dgraph)
    assert len(flags) == 24
    assert all(f["input_quantized"] for f in flags.values())


def test_captured_replays_add_the_prologue_count():
    """A CUDA-graph replay adds its forward's prologue quantizations, as
    it adds the launches."""
    from efficientq_tpu_torch.kernels import COUNTERS as counted

    assert (K.qconv3x3_int8_ndhwc, "launches") in counted
    assert (K.qconv3x3_int8_ndhwc, "prologue_quant_launches") in counted
