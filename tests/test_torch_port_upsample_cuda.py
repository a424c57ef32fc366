"""K5 (``csrc/upsample3d.cu``, ``kernels/upsample.py``) on a CUDA card,
against its plain version, ``F.interpolate`` plus the add, on the same
card.

K5 nests the eight terms as aten does and contracts them into FMAs as
PyTorch's build of aten's kernel does, so the two agree bit for bit: on
dyadic inputs, where every sum is exact, and on random normal inputs,
where the roundings must fall alike.  Shapes: the LiTS serving graph's
five upsamples at 8 patches (the decoder's four with their skips, the
head's channels-minor and channels-first), odd extents, 2, 3, 5 and 6
channels, (8, 8, 4) and (4, 4, 2) heads, factors of 3, bfloat16 and mixed
types, and a deep column whose output passes 2**31 elements.  The kernel
under a CUDA graph (``CapturedForward``) equals it eagerly, and a LiTS
volume of 256 x 256 x 128 served by ``_build_infer`` launches it 5 times
a chunk.

These tests are marked ``cuda`` and skip without a card.  This file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_port_upsample_cuda.py -q --noconftest -m cuda
"""
import pytest
import torch

from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.eval import sliding, validate
from efficientq_tpu_torch.kernels import library
from efficientq_tpu_torch.kernels import qconv3d as K
from efficientq_tpu_torch.kernels import upsample as K5
from efficientq_tpu_torch.models import build_uresq, preset_config
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference

# (input shape, factors, channels_first, with skip): the LiTS serving
# graph's upsamples at 8 patches of 128 x 128 x 64
LITS = {
    "TransUp5": ((8, 4, 4, 4, 256), (2, 2, 2), False, True),
    "TransUp6": ((8, 8, 8, 8, 128), (2, 2, 2), False, True),
    "TransUp7": ((8, 16, 16, 16, 64), (2, 2, 2), False, True),
    "TransUp8": ((8, 32, 32, 32, 32), (2, 2, 2), False, True),
    "head": ((8, 64, 64, 64, 3), (2, 2, 1), False, False),
    "head_cf": ((8, 3, 64, 64, 64), (2, 2, 1), True, False),
}
EDGES = {
    "odd_c3": ((2, 3, 5, 7, 3), (2, 2, 2), False, True),
    "odd_c32": ((2, 3, 5, 7, 32), (2, 2, 2), False, True),
    "odd_c2": ((2, 3, 5, 7, 2), (2, 2, 2), False, True),
    "odd_c6": ((2, 3, 5, 7, 6), (2, 2, 2), False, True),
    "odd_c5": ((2, 3, 5, 7, 5), (2, 2, 2), False, True),
    "odd_cf": ((2, 5, 3, 5, 7), (2, 2, 2), True, True),
    "aux_c3": ((2, 4, 8, 8, 3), (8, 8, 4), False, False),
    "aux_c3_cf": ((2, 3, 4, 8, 8), (4, 4, 2), True, False),
    "ones": ((2, 3, 5, 7, 8), (1, 1, 1), False, True),
}
CASES = {**LITS, **EDGES}
# factors that are not powers of two: weights off the dyadic grid (random
# inputs only)
ODD_FACTORS = {
    "f3_c6": ((1, 3, 5, 7, 6), (3, 2, 1), False, True),
    "f3_cf": ((1, 2, 3, 5, 7), (2, 3, 3), True, False),
}
TYPES = {"f32": (torch.float32, torch.float32),
         "bf16": (torch.bfloat16, torch.bfloat16),
         "bf16_f32skip": (torch.bfloat16, torch.float32),
         "f32_bf16skip": (torch.float32, torch.bfloat16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")
    return torch.device("cuda")


def _out_shape(shape, f, cf):
    if cf:
        n, c, d, h, w = shape
        return (n, c, d * f[0], h * f[1], w * f[2])
    n, d, h, w, c = shape
    return (n, d * f[0], h * f[1], w * f[2], c)


def _dyadic(shape, dtype, gen, device):
    """Integers over 16 in [-4, 4): 7 significant bits, so every sum of the
    interpolation is exact in float32 and bfloat16 holds each input."""
    return (torch.randint(-64, 64, shape, generator=gen, device=device)
            .float() / 16).to(dtype)


def _both(shape, f, cf, skip, xt, st, device, make):
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    x = make(shape, xt, gen, device)
    s = make(_out_shape(shape, f, cf), st, gen, device) if skip else None
    got = K5.upsample_trilinear3d(x, f, s, channels_first=cf)
    want = K5.upsample_trilinear3d_reference(x, f, s, channels_first=cf)
    return x, s, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("types", sorted(TYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_k5_equals_plain_on_dyadic_inputs(name, types, cuda):
    shape, f, cf, skip = CASES[name]
    xt, st = TYPES[types]
    if not skip and st != xt:
        pytest.skip("the skip's type applies only with a skip")
    before = K5.upsample_trilinear3d.launches
    _, _, got, want = _both(shape, f, cf, skip, xt, st, cuda, _dyadic)
    torch.cuda.synchronize()
    assert K5.upsample_trilinear3d.launches - before == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted({**CASES, **ODD_FACTORS}))
def test_cuda_k5_equals_plain_on_random_inputs(name, types, cuda):
    shape, f, cf, skip = {**CASES, **ODD_FACTORS}[name]
    xt, st = TYPES[types]

    def normal(shape, dtype, gen, device):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    _, _, got, want = _both(shape, f, cf, skip, xt, st, cuda, normal)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_k5_column_output_past_2_31_elements(cuda):
    """A deep column at the decoder's last stage, 32 channels: the output
    holds 2,214,592,512 elements, so its offsets need 64 bits."""
    shape = (2, 264, 128, 128, 32)
    out = _out_shape(shape, (2, 2, 2), False)
    assert torch.Size(out).numel() > 2 ** 31
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = _dyadic(shape, torch.float32, gen, cuda)
    got = K5.upsample_trilinear3d(x, 2)
    want = K5.upsample_trilinear3d_reference(x, 2)
    assert torch.equal(got, want)
    del want
    tail = got[-1, -3:].clone()  # the last planes, past 2**31
    del got
    want_tail = K5.upsample_trilinear3d_reference(x[-1:, -2:], 2)[0, -3:]
    assert torch.equal(tail, want_tail)


@pytest.mark.cuda
def test_cuda_k5_operator_equals_the_wrapper(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _dyadic((2, 4, 4, 4, 16), torch.float32, gen, cuda)
    s = _dyadic((2, 8, 8, 8, 16), torch.bfloat16, gen, cuda)
    before = K5.upsample_trilinear3d.launches
    got = library.upsample_trilinear3d(x, 2, s)
    assert K5.upsample_trilinear3d.launches - before == 1
    assert torch.equal(got, K5.upsample_trilinear3d(x, 2, s))


@pytest.mark.cuda
def test_cuda_k5_refuses_a_skip_of_another_shape(cuda):
    x = torch.zeros(1, 2, 2, 2, 4, device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        K5.upsample_trilinear3d(x, 2, torch.zeros(1, 4, 4, 4, 3,
                                                  device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K5.upsample_trilinear3d(x.half(), 2)


@pytest.mark.cuda
def test_cuda_k5_captured_equals_eager(cuda):
    """The decoder's fused pair and the head in one forward, replayed from a
    CUDA graph, equal the same forward run eagerly; each replay counts its
    two launches."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    skip = torch.randn((4, 16, 16, 16, 32), generator=gen, device=cuda)
    v = {"skip": skip}

    def forward(v, x):
        y = K5.upsample_trilinear3d(x, 2, v["skip"])
        return K5.upsample_trilinear3d(y[..., :3].contiguous(), (2, 2, 1))

    cap = sliding.CapturedForward(forward)
    cap.use(v)
    xs = [torch.randn((4, 8, 8, 8, 32), generator=gen, device=cuda)
          for _ in range(4)]
    for i, x in enumerate(xs):
        before = K5.upsample_trilinear3d.launches
        got = cap(x)
        assert K5.upsample_trilinear3d.launches - before == 2
        assert torch.equal(got, forward(v, x)), i
    assert cap.captures == 1


@pytest.mark.cuda
def test_cuda_lits_volume_launches_k5_five_times_a_chunk(cuda):
    """A 256 x 256 x 128 LiTS volume on the benchmark's path: 27 patches in
    chunks of 8 (3 full, captured from the second, and a ragged one), the
    four fused decoder upsamples and the head on K5 in each."""
    cfg = preset_config("lits", quantize=True, qlvl_w=4, qlvl_act=4,
                        q_first=(256, -1), q_last=(256, -1))
    graph = build_uresq(cfg)
    dg, dv = to_int8_inference(*fold_bn(graph, nnir.init(graph, 0,
                                                        device="cpu")))
    dv = nnir.to_device(dv, cuda)
    vol = torch.rand((1, 256, 256, 128, 1), device=cuda)
    patch, overlap = (128, 128, 64), (16, 16, 16)
    infer = validate._build_infer(
        dg, dv, vol, patch, overlap, mode="quantized", patch_batch="auto",
        multilabel=False, compute_dtype=None, serve_stem="direct",
        heads=slice(-1, None), device=cuda, tune_serving="off")
    for _ in range(2):
        k5, k1 = K5.upsample_trilinear3d.launches, K.qconv3x3_int8_ndhwc.launches
        pred = infer(dv, vol, patch, overlap)
        torch.cuda.synchronize()
        assert pred.shape == (1, 1, 256, 256, 128)
        assert K5.upsample_trilinear3d.launches - k5 == 20
        assert K.qconv3x3_int8_ndhwc.launches - k1 == 18 * 4
