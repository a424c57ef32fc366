"""K6 (``csrc/groupnorm.cu``, ``kernels/groupnorm.py``) on a CUDA card,
against its plain version on the same card.

The plain version takes the statistics in two float64 passes; K6 combines
per-block float64 statistics by Chan's formula, in another order.  Both
round them once to float32 (the group's mean, the channel scales
gamma / sqrt(var + eps)) and take the same float32 steps after, so their
outputs are equal but where a float64 statistic lies within its rounding
error (about 1e-16 of it) of a float32 rounding boundary: on these
inputs, never.  Hence ``torch.equal``, for the codes as for the floats.

Shapes: every GroupNorm of the SegResNet cell at its chunk of 8 patches of
128 x 192 x 160 (32 channels at full resolution to 256 at an eighth, the
codes that K1 reads, and the head's ReLU'd float32), then small and odd
extents, 1 and 2 channels a group (vectors of 1 and 2), bfloat16 inputs, a
group spanning a warp, a partial last block.  Under a CUDA graph
(``CapturedForward``) K6 equals it eagerly and a replay counts its
launches.  A BraTS study of 155 x 240 x 240 served by
``_build_infer`` on the full-width SegResNet launches K6 25 times a
chunk (a replay too, with the elements its GroupNorms normalized), K1 24
times and K5 3 times, and a chunk's logits on the kernels
equal those on their plain versions.

These tests are marked ``cuda`` and skip without a card.  This file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_port_groupnorm_cuda.py -q --noconftest -m cuda
"""
import pytest
import torch

from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.eval import sliding, validate
from efficientq_tpu_torch.kernels import WRAPPERS
from efficientq_tpu_torch.kernels import groupnorm as K6
from efficientq_tpu_torch.kernels import library
from efficientq_tpu_torch.kernels import qconv3d as K1
from efficientq_tpu_torch.kernels import upsample as K5
from efficientq_tpu_torch.models import SegResNetConfig, build_segresnet
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from efficientq_tpu_torch.ptq.deploy import serving_graph
from efficientq_tpu_torch.quant import fake_quant_weight

# (shape, groups): the cell's GroupNorms at 8 patches of 128 x 192 x 160
CELL = {
    "level0_c32": ((8, 128, 192, 160, 32), 8),
    "level1_c64": ((8, 64, 96, 80, 64), 8),
    "level2_c128": ((8, 32, 48, 40, 128), 8),
    "level3_c256": ((8, 16, 24, 20, 256), 8),
}
EDGES = {
    "odd_c8_cg1": ((2, 3, 5, 7, 8), 8),
    "odd_c16_cg2": ((3, 5, 3, 7, 16), 8),
    "c4_cg4": ((2, 9, 7, 5, 4), 1),
    "c512_g2": ((2, 4, 5, 6, 512), 2),   # a group spans two warps
    "c1024_g32": ((1, 3, 4, 5, 1024), 32),
    "tail": ((2, 17, 13, 11, 32), 8),    # a partial last block
}
ALPHA = 4.0 / 3.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    # an offset and a spread per channel, as a conv's output has
    x = (torch.randn(shape, generator=gen, device=device)
         * (0.5 + torch.rand(c, generator=gen, device=device))
         + torch.randn(c, generator=gen, device=device))
    gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device=device)
    beta = 0.2 * torch.randn(c, generator=gen, device=device)
    return x.to(dtype), gamma, beta


def _check(shape, g, dtype, device, seed, **kw):
    x, gamma, beta = _inputs(shape, dtype, device, seed)
    before = K6.group_norm.launches
    got = K6.group_norm(x, gamma, beta, g, 1e-5, **kw)
    torch.cuda.synchronize()
    assert K6.group_norm.launches - before == 1
    want = K6.group_norm_reference(x, gamma, beta, g, 1e-5, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELL))
def test_cuda_k6_codes_equal_plain_at_the_cell_shapes(name, cuda):
    shape, g = CELL[name]
    codes = _check(shape, g, torch.float32, cuda, 1,
                   quant_alpha=torch.tensor(ALPHA, device=cuda),
                   quant_qlvl=4)
    assert codes.dtype == torch.int8
    # the codes K1 reads: every level of the 4-level grid occurs
    assert set(torch.unique(codes).tolist()) == {0, 1, 2, 3}


@pytest.mark.cuda
def test_cuda_k6_head_float_relu_equals_plain(cuda):
    y = _check(CELL["level0_c32"][0], 8, torch.float32, cuda, 2, relu=True)
    assert float(y.min()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["codes", "relu", "float"])
@pytest.mark.parametrize("name", sorted(EDGES))
def test_cuda_k6_equals_plain_at_edge_shapes(name, mode, dtype, cuda):
    shape, g = EDGES[name]
    kw = {"codes": dict(quant_alpha=ALPHA, quant_qlvl=4),
          "relu": dict(relu=True), "float": {}}[mode]
    _check(shape, g, torch.float32 if dtype == "f32" else torch.bfloat16,
           cuda, 3, **kw)


@pytest.mark.cuda
def test_cuda_k6_operator_equals_the_wrapper(cuda):
    x, gamma, beta = _inputs((2, 4, 6, 8, 32), torch.float32, cuda, 4)
    alpha = torch.tensor(ALPHA, device=cuda)
    before = K6.group_norm.launches
    got = library.group_norm(x, gamma, beta, 8, 1e-5, False, alpha, 4)
    assert K6.group_norm.launches - before == 1
    assert torch.equal(got, K6.group_norm(x, gamma, beta, 8, 1e-5, False,
                                          alpha, 4))


@pytest.mark.cuda
def test_cuda_k6_refuses_shapes_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 2, 2, 24, device=cuda)
    ones = torch.ones(24, device=cuda)
    with pytest.raises(ValueError, match="powers of two"):
        K6.group_norm(x, ones, ones, 8)
    # more than 32 groups of two channels (one channel a group, the
    # InstanceNorm, takes a pass of its own up to 1024 channels)
    x = torch.zeros(1, 2, 2, 2, 128, device=cuda)
    ones = torch.ones(128, device=cuda)
    with pytest.raises(ValueError, match="at most 32 groups"):
        K6.group_norm(x, ones, ones, 64)
    wide = torch.zeros(1, 2, 2, 2, 2048, device=cuda)
    with pytest.raises(ValueError, match="at most 1024 channels"):
        K6.group_norm(wide, wide[0, 0, 0, 0] + 1, wide[0, 0, 0, 0], 2048)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K6.group_norm(x.half(), ones, ones, 8)


@pytest.mark.cuda
def test_cuda_k6_captured_equals_eager(cuda):
    """Two GroupNorms of a ResBlock in one forward, replayed from a CUDA
    graph, equal the same forward run eagerly; each replay counts its two
    launches."""
    _, gamma, beta = _inputs((1, 1, 1, 1, 32), torch.float32, cuda, 5)
    v = {"gamma": gamma, "beta": beta,
         "alpha": torch.tensor(ALPHA, device=cuda)}

    def forward(v, x):
        h = K6.group_norm(x, v["gamma"], v["beta"], 8, relu=True)
        return K6.group_norm(h + x, v["gamma"], v["beta"], 8,
                             quant_alpha=v["alpha"], quant_qlvl=4)

    cap = sliding.CapturedForward(forward)
    cap.use(v)
    for i in range(4):
        x, _, _ = _inputs((4, 16, 16, 16, 32), torch.float32, cuda, 10 + i)
        before = K6.group_norm.launches
        got = cap(x)
        assert K6.group_norm.launches - before == 2
        assert torch.equal(got, forward(v, x)), i
    assert cap.captures == 1


def _post_ptq(cfg, seed=0):
    """The full-width graph, deployed, with post-PTQ variables: each kernel
    on its alpha_w = max|w| grid, alpha_act 4/3, GroupNorm affines drawn
    from the seed, the six signed-input convs on the offset grid k = 1."""
    graph = build_segresnet(cfg)
    fg, fv = fold_bn(graph, nnir.init(graph, seed, device="cpu"))
    gen = torch.Generator().manual_seed(seed)
    for node in fg.nodes:
        p = fv["params"].get(node.name)
        if node.op == "group_norm":
            p["scale"] = 1.0 + 0.2 * torch.randn(p["scale"].shape,
                                                 generator=gen)
            p["bias"] = 0.2 * torch.randn(p["bias"].shape, generator=gen)
        q = node.attrs.get("qcfg") if node.op == "conv" else None
        if q is None:
            continue
        if q.q_weight:
            a = p["kernel"].abs().max()
            p["kernel"] = fake_quant_weight(p["kernel"], a, q.qlvl_w)
            p["alpha_w"] = a
        if q.q_act:
            p["alpha_act"] = torch.tensor(ALPHA)
            if node.attrs["kernel_size"] == (1, 1, 1) or \
                    node.attrs["stride"] == (2, 2, 2):
                p["act_k"] = torch.tensor(1, dtype=torch.int32)
    return to_int8_inference(fg, fv)


@pytest.mark.cuda
def test_cuda_brats_study_launches_k6_before_every_k1(cuda):
    cfg = SegResNetConfig(num_mod=4, num_classes=3, init_filters=32,
                          quantize=True, qlvl_w=4, qlvl_act=4,
                          q_first=(256, -1), q_last=(256, -1))
    dg, dv = _post_ptq(cfg)
    dv = nnir.to_device(dv, cuda)
    patch, overlap = (128, 192, 160), (16, 16, 16)
    gen = torch.Generator(device=cuda).manual_seed(6)
    vol = torch.randn((1, 155, 240, 240, 4), generator=gen, device=cuda)
    infer = validate._build_infer(
        dg, dv, vol, patch, overlap, mode="quantized", patch_batch="auto",
        multilabel=True, compute_dtype=None, serve_stem="direct",
        heads=slice(-1, None), device=cuda, tune_serving="off")
    counters = (K6.group_norm, K1.qconv3x3_int8_ndhwc,
                K5.upsample_trilinear3d)
    for study in range(3):  # eager, captured, replayed: one chunk of 8
        before = [fn.launches for fn in counters]
        elements = K6.group_norm.elements
        pred = infer(dv, vol, patch, overlap)
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(counters, before)] == \
            [25, 24, 3], study
        # the GroupNorms of a patch by level: 5 at full resolution (two
        # ResBlocks' and the head's), 6, 6, and 8 at an eighth
        per_patch = (128 * 192 * 160 * 32 * 5 + 64 * 96 * 80 * 64 * 6
                     + 32 * 48 * 40 * 128 * 6 + 16 * 24 * 20 * 256 * 8)
        assert K6.group_norm.elements - elements == 8 * per_patch
        assert pred.shape == (1, 1, 155, 240, 240, 3)
    assert infer.captured.captures == 1
    served = serving_graph(dg)
    xb = torch.randn((2, *patch, 4), generator=gen, device=cuda)
    with torch.inference_mode():
        got = nnir.apply(served, dv, xb, mode="quantized",
                         heads=slice(-1, None))
        want = nnir.apply(
            served, dv, xb, mode="quantized", heads=slice(-1, None),
            kernels=WRAPPERS._replace(
                conv3x3_int8=K1.qconv3x3_int8_ndhwc_reference,
                upsample=K5.upsample_trilinear3d_reference,
                group_norm=K6.group_norm_reference))
    assert torch.equal(got, want)
