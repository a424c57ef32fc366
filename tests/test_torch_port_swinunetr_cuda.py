"""SwinUNETR's kernels on a CUDA card: K7 (``csrc/window_attention.cu``)
against its plain version, K1's and K3's offset-grid codes, K1 at 768
channels, K6 at one channel a group, and the served chunk's launches.

K7 and its plain version compute in float64, in other orders, and round
once: at the cell's four stage shapes (8 patches of 128^3: 64^3 x 48
channels of 3 heads, 32^3 x 96 of 6, 16^3 x 192 of 12, 8^3 x 384 of 24;
the grids padded to 70, 35, 21 and 14), shifted and not, they are equal
but where a float64 value straddles a float32 rounding boundary: at most
one element in 10^5 differs, by at most one float32 ulp.  A window that shrinks to the grid's
extent, on one axis or all, takes MONAI's index of the configured window;
so do windows whose tokens are no multiple of K7's tiles of 16 (1, 30 and
245 tokens), scores spread wide enough that exp underflows inside a key
tile, and a shifted stage without a qkv bias.  Under a CUDA graph K7
equals it eagerly and a replay counts its launches and its tiles' scores.

The offset grid's codes: with the identity as weights (K3's 1x1, K1's
centre tap) a kernel's output is its codes, so ``torch.equal`` holds them
to ``act_codes(x, alpha, levels, k)`` on inputs dense in ties (every
half-step of the grid, and the floats next to it), at 2 to 256 levels.

These tests are marked ``cuda`` and skip without a card.  This file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_port_swinunetr_cuda.py -q --noconftest -m cuda
"""
import pytest
import torch

from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.eval import sliding
from efficientq_tpu_torch.kernels import REFERENCES, WRAPPERS
from efficientq_tpu_torch.kernels import groupnorm as K6
from efficientq_tpu_torch.kernels import qconv3d as K1
from efficientq_tpu_torch.kernels import qmatmul as K3
from efficientq_tpu_torch.kernels import window_attention as K7
from efficientq_tpu_torch.models import SwinUNETRConfig, build_model
from efficientq_tpu_torch.ops import layer_norm
from efficientq_tpu_torch.ptq import to_int8_inference
from efficientq_tpu_torch.ptq.deploy import serving_graph
from efficientq_tpu_torch.quant import act_codes

pytestmark = pytest.mark.cuda

# (grid extent, channels, heads) of the cell's four stages
STAGES = {
    "stage1": (64, 48, 3),
    "stage2": (32, 96, 6),
    "stage3": (16, 192, 12),
    "stage4": (8, 384, 24),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    return torch.device("cuda")


def _attention_inputs(n, extent, c, heads, device, seed, window=7,
                      spread=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    d, h, w = (extent,) * 3 if isinstance(extent, int) else extent
    qkv = spread * torch.randn((n, d, h, w, 3 * c), generator=gen,
                               device=device)
    rows = (2 * window - 1) ** 3
    table = 0.5 * torch.randn((rows, heads), generator=gen, device=device)
    bias = 0.3 * torch.randn(3 * c, generator=gen, device=device)
    return qkv, table, bias


def _close(got, want):
    differ = got != want
    share = float(differ.float().mean())
    assert share <= 1e-5, share
    if share:
        ulp = torch.finfo(torch.float32).eps * want[differ].abs()
        assert bool(((got - want)[differ].abs() <= ulp).all())


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage,n", [("stage1", 2), ("stage1", 8),
                                     ("stage2", 2), ("stage3", 8),
                                     ("stage4", 8)])
def test_k7_matches_plain_at_the_cells_stages(cuda, stage, n, shift):
    extent, c, heads = STAGES[stage]
    qkv, table, bias = _attention_inputs(n, extent, c, heads, cuda, 7)
    before = K7.window_attention.launches
    scores = K7.window_attention.tile_scores
    got = K7.window_attention(qkv, table, bias, heads, (7,) * 3, (shift,) * 3)
    assert K7.window_attention.launches == before + 1
    assert K7.window_attention.tile_scores - scores == K7.tile_scores(
        (extent,) * 3, (7,) * 3, (shift,) * 3, n, heads)
    want = K7.window_attention_reference(qkv, table, bias, heads, (7,) * 3,
                                         (shift,) * 3)
    _close(got, want)


@pytest.mark.parametrize("extent,shift", [
    ((4, 4, 4), 3),        # every axis shrinks: window 4^3, no shift
    ((5, 9, 16), 3),       # one axis shrinks: the others shift
    ((7, 8, 15), 3),       # an extent equal to the window shrinks it
    ((13, 10, 9), 0),
    ((1, 1, 1), 3),        # a window of one token
    ((2, 3, 5), 3),        # 30 tokens: no multiple of a tile
    ((16, 9, 5), 3),       # 7 x 7 x 5 = 245 tokens, two axes shifted
])
def test_k7_shrunk_and_ragged_windows(cuda, extent, shift):
    qkv, table, bias = _attention_inputs(2, extent, 32, 2, cuda, 11)
    got = K7.window_attention(qkv, table, bias, 2, (7,) * 3, (shift,) * 3)
    want = K7.window_attention_reference(qkv, table, bias, 2, (7,) * 3,
                                         (shift,) * 3)
    _close(got, want)
    # no qkv bias: padded keys and values are zeros
    got = K7.window_attention(qkv, table, None, 2, (7,) * 3, (shift,) * 3)
    want = K7.window_attention_reference(qkv, table, None, 2, (7,) * 3,
                                         (shift,) * 3)
    _close(got, want)


def test_k7_in_a_cuda_graph(cuda):
    qkv, table, bias = _attention_inputs(2, 16, 64, 4, cuda, 3)
    eager = K7.window_attention(qkv, table, bias, 4, (7,) * 3, (3,) * 3)

    def forward(_v, x):
        return K7.window_attention(x, table, bias, 4, (7,) * 3, (3,) * 3)

    cap = sliding.CapturedForward(forward)
    cap.use({})
    cap(qkv)  # eager, then captured at the second call of the shape
    cap(qkv)
    before = K7.window_attention.launches
    scores = K7.window_attention.tile_scores
    out = cap(qkv)
    assert torch.equal(out, eager)
    assert cap.captures == 1
    assert K7.window_attention.launches == before + 1
    assert K7.window_attention.tile_scores - scores == K7.tile_scores(
        (16,) * 3, (7,) * 3, (3,) * 3, 2, 4)


@pytest.mark.parametrize("spread", [4.5, 10.0])
@pytest.mark.parametrize("shift", [0, 3])
def test_k7_wide_scores(cuda, spread, shift):
    """Scores of std spread^2 about 0 (to about +-80 at 4.5, +-400 at 10):
    within a tile of keys exp underflows (at 10 to 0) beside scores near
    the row's max, and where the block shifts the -100 mask moves whole
    rows of a tile below the rest."""
    qkv, table, bias = _attention_inputs(2, 21, 48, 3, cuda, 5,
                                         spread=spread)
    got = K7.window_attention(qkv, table, bias, 3, (7,) * 3, (shift,) * 3)
    want = K7.window_attention_reference(qkv, table, bias, 3, (7,) * 3,
                                         (shift,) * 3)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def test_k7_written_out_exp_is_the_toolkits(cuda):
    """K7's exp, written out so a thread's exps interleave, equals the
    toolkit's float64 exp bit for bit: densely over [-746, 0] (softmax's
    range, the fast path to -708.4 and the slow one past it), on random
    values of every size, and on zeros, infinities, NaN, subnormals and
    the ends of the fast path."""
    import ctypes

    from efficientq_tpu_torch.kernels import build, on_device
    fn = build.load("window_attention.cu").effq_window_attention_exp_check
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    f64 = dict(dtype=torch.float64, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(17)
    edge = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                         float("nan"), 5e-324, -5e-324,
                         2.2250738585072014e-308,
                         -708.3964185322641, -708.39641853226, -708.4,
                         708.3964185322641, 709.78, 709.79, -745.13,
                         -745.14, -745.1332191019411, 1e-300, -1e-300], **f64)
    x = torch.cat([
        torch.linspace(-746.0, 0.0, 1 << 21, **f64),
        -746.0 * torch.rand(1 << 20, generator=gen, **f64),
        torch.randn(1 << 20, generator=gen, **f64)
        * torch.exp2(torch.randint(-60, 11, (1 << 20,), generator=gen,
                                   device=cuda).to(torch.float64)),
        edge, torch.nextafter(edge, torch.zeros_like(edge))])
    written, toolkit = torch.empty_like(x), torch.empty_like(x)
    assert on_device(torch.cuda.current_device(), fn, x.data_ptr(),
                     written.data_ptr(), toolkit.data_ptr(), x.numel()) == 0
    torch.cuda.synchronize()
    same = (written.view(torch.int64) == toolkit.view(torch.int64)) | (
        written.isnan() & toolkit.isnan())
    assert bool(same.all()), x[~same][:8].tolist()


def test_k7_shifted_stage_without_qkv_bias(cuda):
    extent, c, heads = STAGES["stage2"]
    qkv, table, _ = _attention_inputs(2, extent, c, heads, cuda, 13)
    got = K7.window_attention(qkv, table, None, heads, (7,) * 3, (3,) * 3)
    want = K7.window_attention_reference(qkv, table, None, heads, (7,) * 3,
                                         (3,) * 3)
    _close(got, want)


def _tie_dense(alpha, levels, k, device, n=4096):
    """Inputs at every half-step of the grid around its range, and the
    floats next to each."""
    qmax = levels - 1
    m = torch.arange(-2 * (k + 2), 2 * (qmax - k + 2) + 1, device=device,
                     dtype=torch.float32)
    base = m * 0.5 * alpha / qmax
    vals = torch.cat([base, torch.nextafter(base, base - 1),
                      torch.nextafter(base, base + 1),
                      base * (1 + 2 ** -23)])
    return vals.repeat(-(-n // vals.numel()))[:n]


@pytest.mark.parametrize("levels,k", [(2, 1), (3, 1), (4, 1), (4, 2),
                                      (16, 5), (128, 64), (256, 128)])
def test_k3_offset_codes_equal_act_codes(cuda, levels, k):
    alpha = torch.tensor(4.0 / 3.0, device=cuda)
    c = 64
    x = _tie_dense(4.0 / 3.0, levels, k, cuda, 96 * c).reshape(96, c)
    eye = torch.eye(c, dtype=torch.int8, device=cuda)
    got = K3.fused_int8_matmul(x, eye, None, alpha, 1.0, levels, act_k=k)
    want = act_codes(x, alpha, levels, k).to(torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("levels,k", [(2, 1), (4, 1), (4, 2), (16, 5),
                                      (128, 64), (256, 128)])
def test_k1_offset_codes_equal_act_codes(cuda, levels, k):
    alpha = torch.tensor(4.0 / 3.0, device=cuda)
    c = 32
    x = _tie_dense(4.0 / 3.0, levels, k, cuda, 2 * 8 * 8 * 8 * c).reshape(
        2, 8, 8, 8, c)
    w = torch.zeros((3, 3, 3, c, c), dtype=torch.int8, device=cuda)
    w[1, 1, 1] = torch.eye(c, dtype=torch.int8, device=cuda)
    got = K1.qconv3x3_int8_ndhwc(x, w, None, alpha, 1.0, levels, act_k=k)
    want = act_codes(x, alpha, levels, k).to(torch.float32)
    assert torch.equal(got, want)
    # the quant epilogue's offset codes of y
    qa = torch.tensor(2.0, device=cuda)
    got = K1.qconv3x3_int8_ndhwc(x, w, None, alpha, alpha / (levels - 1),
                                 levels, act_k=k, quant_alpha=qa,
                                 quant_qlvl=levels, quant_k=k)
    want = K1.qconv3x3_int8_ndhwc_reference(
        x, w, None, alpha, alpha / (levels - 1), levels, act_k=k,
        quant_alpha=qa, quant_qlvl=levels, quant_k=k)
    assert torch.equal(got, want)


def _k3_chunk_case(m, k, n, bf16, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device)
    if bf16:
        x = x.to(torch.bfloat16)
    w = (torch.randint(0, 4, (k, n), generator=gen, device=device) * 2
         - 3).to(torch.int8)
    bias = torch.randn(n, generator=gen, device=device)
    scale = 2.0 ** -9 * (1 + torch.rand(n, generator=gen, device=device))
    return x, w, bias, scale


@pytest.mark.parametrize("m,k,n", [(4096, 1536, 384), (512, 3072, 768)])
def test_k3_walks_the_cells_widest_k_in_chunks(cuda, m, k, n):
    """The stage-4 MLPs' second linears and the stage-3 merge (K 1536)
    and the stage-4 merge (K 3072) at a chunk of 8: one launch, K in
    chunks inside the kernel, equal to the plain K3."""
    assert K3._k3_plan(m, k, n, False).kc
    x, w, bias, scale = _k3_chunk_case(m, k, n, False, cuda, 4)
    alpha = torch.tensor(4.0 / 3.0, device=cuda)
    before = K3.fused_int8_matmul.launches
    got = K3.fused_int8_matmul(x, w, bias, alpha, scale, 4,
                               K3.pack_weights_1x1(w), act_k=1)
    assert K3.fused_int8_matmul.launches == before + 1
    want = K3.fused_int8_matmul_reference(x, w, bias, alpha, scale, 4,
                                          act_k=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kc", [32, 64, 128])
@pytest.mark.parametrize("k", [200, 201])
@pytest.mark.parametrize("bf16", [False, True])
def test_k3_every_chunked_plan_matches_plain(cuda, kc, k, bf16):
    """Every tiling at chunks of kc, a ragged last chunk (K 200 and 201
    round up to 224) and, at K 201, the element-load staging."""
    m, n = 700, 40
    x, w, bias, scale = _k3_chunk_case(m, k, n, bf16, cuda, kc + k)
    alpha = torch.tensor(4.0 / 3.0, device=cuda)
    wp = K3.pack_weights_1x1(w)
    plans = [p for _, p in K3._k3_candidates(m, k, n, bf16, kc)]
    assert len(plans) >= 2
    for act_k in (0, 1):
        want = K3.fused_int8_matmul_reference(x, w, bias, alpha, scale, 4,
                                              act_k=act_k)
        for plan in plans:
            got = K3._launch_int8(x, w, bias, alpha, scale, 4, wp,
                                  plan=plan, act_k=act_k)
            assert torch.equal(got, want), (plan, act_k)


def _k1_case(n, extent, c, o, device, seed, k):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, extent, extent, extent, c), generator=gen,
                    device=device)
    w = (torch.randint(0, 4, (3, 3, 3, c, o), generator=gen, device=device)
         * 2 - 3).to(torch.int8)
    return x, w


@pytest.mark.parametrize("extent,c,o", [(4, 768, 768), (8, 768, 384),
                                        (128, 96, 48)])
def test_k1_at_the_cells_offset_convs(cuda, extent, c, o):
    n = 2 if extent == 128 else 8
    x, w = _k1_case(n, extent, c, o, cuda, 5, 1)
    alpha = torch.tensor(4.0 / 3.0, device=cuda)
    scale = torch.tensor(2.0 ** -9, device=cuda)
    got = K1.qconv3x3_int8_ndhwc(x, w, None, alpha, scale, 4, act_k=1)
    want = K1.qconv3x3_int8_ndhwc_reference(x, w, None, alpha, scale, 4,
                                            act_k=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 128, 128, 128, 48),
                                   (8, 64, 64, 64, 48),
                                   (8, 32, 32, 32, 96),
                                   (8, 16, 16, 16, 192),
                                   (8, 8, 8, 8, 384),
                                   (8, 4, 4, 4, 768),
                                   (2, 3, 5, 7, 20),
                                   (2, 5, 3, 9, 6)])
def test_k6_one_channel_a_group(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(2)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=cuda)
         * (0.5 + torch.rand(c, generator=gen, device=cuda))
         + torch.randn(c, generator=gen, device=cuda))
    ones = torch.ones(c, device=cuda)
    zeros = torch.zeros(c, device=cuda)
    for kw in ({}, {"quant_alpha": torch.tensor(4.0 / 3.0, device=cuda),
                    "quant_qlvl": 4}):
        got = K6.group_norm(x, ones, zeros, c, 1e-5, **kw)
        want = K6.group_norm_reference(x, ones, zeros, c, 1e-5, **kw)
        assert torch.equal(got, want)


def test_layer_norm_counts_its_elements(cuda):
    x = torch.randn(2, 4, 4, 4, 96, device=cuda)
    before = layer_norm.elements
    layer_norm(x, None, None)
    assert layer_norm.elements == before + x.numel()


def _offset(name):
    """The layers that read a LayerNorm's, an attention's or a concat's
    output: on the offset grid."""
    return (name.endswith(("attn.qkv", "attn.proj", "mlp.linear1",
                           "downsample.reduction"))
            or (name.endswith("conv1.conv")
                and not name.startswith("encoder1."))
            or (name.endswith("conv3.conv") and name.startswith("decoder")))


def _seeded_swin(device):
    """The published widths on seeded weights, on 4-level grids, the
    offset-grid layers at k = 1."""
    cfg = SwinUNETRConfig(quantize=True, qlvl_w=4, qlvl_act=4,
                          q_first=(256, -1), q_last=(256, -1))
    g = build_model(cfg)
    v = nnir.init(g, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for node in g.qconv_nodes():
        p = v["params"][node.name]
        q = node.attrs["qcfg"]
        if q.q_weight:
            nw = q.qlvl_w - 1
            a = float(p["kernel"].abs().max())
            p["alpha_w"] = torch.tensor(a)
            p["kernel"] = (torch.round((torch.clamp(p["kernel"] / a, -1, 1)
                                        + 1) * nw / 2) * 2 - nw) * (a / nw)
        p["alpha_act"] = torch.tensor(4.0 / 3.0)
        if _offset(node.name):
            p["act_k"] = torch.tensor(1, dtype=torch.int32)
        if "bias" in p:
            p["bias"] = 0.1 * torch.randn(p["bias"].shape, generator=gen)
    dg, dv = to_int8_inference(g, v)
    return serving_graph(dg), nnir.to_device(dv, device)


def test_served_chunk_launches_and_logits(cuda):
    sg, dv = _seeded_swin(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((1, 128, 128, 128, 4), generator=gen, device=cuda)
    counts = {}
    for name, fn in (("k1", K1.qconv3x3_int8_ndhwc),
                     ("k3", K3.fused_int8_matmul),
                     ("k6", K6.group_norm),
                     ("k7", K7.window_attention)):
        counts[name] = (fn, fn.launches)
    with torch.inference_mode():
        got = nnir.apply(sg, dv, x, mode="quantized")
    launched = {k: fn.launches - b for k, (fn, b) in counts.items()}
    assert launched == {"k1": 19, "k3": 46, "k6": 26, "k7": 8}, launched
    with torch.inference_mode():
        want = nnir.apply(sg, dv, x, mode="quantized", kernels=REFERENCES)
    err = float((got - want).abs().max())
    flips = float(((got >= 0) != (want >= 0)).float().mean())
    print(f"served logits against the plain kernels: max |diff| {err:.3g}"
          f" of {float(want.abs().max()):.3g}, decisions that differ "
          f"{flips:.3g}")
    assert torch.isfinite(got).all()
    # K7's and K6's float64 sums in other orders straddle a float32
    # rounding boundary rarely: no decision of the chunk moves
    assert flips <= 1e-6
    assert WRAPPERS.window_attention is K7.window_attention
