"""K3 and K4 (the fused 1x1 matmuls) and the ``include_1x1`` serving paths
against the JAX package: the plain versions against the Pallas kernels in
interpret mode and the XLA int8 path, ``to_pallas_inference(include_1x1=
True)`` and ``to_int8_inference(only_kernel_sizes=...)`` node for node, and
``nnir.apply`` / ``make_volume_inferencer`` on the flagged graphs (int8,
mixed, fq), at the tiny net of tests/test_pallas.py.

Tolerances.  K3's plain version equals an int64 NumPy oracle and JAX's XLA
int8 matmul (run op by op) exactly: integer sums, then ``* scale`` and
``+ bias`` rounded separately in float32.  Against the interpret-mode
Pallas K3 it is within 1 ulp of ``|y| + |bias|``: XLA's CPU backend fuses
``acc * scale + bias`` into one FMA (as tests/test_torch_port_qconv3d.py
records for K1).  K4 and ``qconv1x1_ndhwc``: rtol/atol 1e-5 (float32 sums
in another order; the fake-quant prologue is the same ops).  Float32
forwards: rtol/atol 1e-5, as tests/test_torch_port_graph.py.  bfloat16
forwards: atol 0.05 on the logits and > 0.999 agreement of their signs,
the level of tests/test_torch_port_s2d.py (bf16 sum order differs between
the two convs).  Graphs, flags and deployed parameters are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu.eval import sliding as jsliding
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.models import preset_config as jpreset
from efficientq_tpu.pallas import qmatmul as jqm
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq.deploy import to_int8_inference as jdeploy
from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.eval import sliding
from efficientq_tpu_torch.kernels import WRAPPERS
from efficientq_tpu_torch.kernels import qmatmul as K
from efficientq_tpu_torch.models import build_uresq, preset_config
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from test_torch_port_cuda import MATMUL_CASES, NA, matmul_case
from test_torch_port_graph import (_both, _graph_key, _np_vars, _port_vars,
                                   _post_ptq)

BF16 = torch.bfloat16
MIXED = {(3, 3, 3)}


def _tx(case):
    x = torch.from_numpy(case["x"])
    return x.to(BF16) if case["dtype"] == "bf16" else x


def _jx(case):
    x = jnp.asarray(case["x"])
    return x.astype(jnp.bfloat16) if case["dtype"] == "bf16" else x


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=["-".join(map(str, c)) for c in MATMUL_CASES])
def test_plain_k3_matches_oracle_and_jax(case):
    c = matmul_case(*case)
    got = K.fused_int8_matmul(_tx(c), _t(c["codes"]), _t(c["bias"]),
                              _t(c["alpha"]), _t(c["scale"]), NA).numpy()
    assert got.dtype == np.float32 and got.shape == (case[0], case[2])
    # int64 oracle, float32 epilogue rounded step by step
    qa = np.round(np.clip(c["x"] / c["alpha"], 0, 1) * (NA - 1))
    acc = qa.astype(np.int64) @ c["codes"].astype(np.int64)
    want = acc.astype(np.float32) * c["scale"]
    if c["bias"] is not None:
        want = want + c["bias"]
    np.testing.assert_array_equal(got, want)
    # JAX's XLA int8 path (nnir's int8 conv as a dot), op by op
    jqa = jnp.round(jnp.clip(_jx(c) / jnp.float32(c["alpha"]), 0.0, 1.0)
                    * (NA - 1)).astype(jnp.int8)
    xla = jax.lax.dot(jqa, jnp.asarray(c["codes"]),
                      preferred_element_type=jnp.int32)
    xla = xla.astype(jnp.float32) * jnp.asarray(c["scale"])
    if c["bias"] is not None:
        xla = xla + jnp.asarray(c["bias"])
    np.testing.assert_array_equal(got, np.asarray(xla))
    # the interpret-mode Pallas kernel: 1 ulp (its FMA)
    pallas = np.asarray(jqm.fused_int8_matmul(
        _jx(c), jnp.asarray(c["codes"]), _j(c["bias"]), c["alpha"],
        jnp.asarray(c["scale"]), NA, tile_m=64, interpret=True))
    bound = 0.0 if c["bias"] is None else np.abs(c["bias"])
    ulp = np.spacing((np.abs(got) + bound).astype(np.float32))
    assert np.all(np.abs(got - pallas) <= ulp), np.abs(got - pallas).max()


@pytest.mark.parametrize("case", MATMUL_CASES,
                         ids=["-".join(map(str, c)) for c in MATMUL_CASES])
def test_plain_k4_matches_jax(case):
    c = matmul_case(*case)
    got = K.fused_qact_matmul(_tx(c), _t(c["w"]), _t(c["bias"]),
                              _t(c["alpha"]), NA).numpy()
    want = np.asarray(jqm.fused_qact_matmul(
        _jx(c), jnp.asarray(c["w"]), _j(c["bias"]), c["alpha"], NA,
        tile_m=64, interpret=True))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,n", [(128, 256), (64, 32)])
def test_plain_k4_matches_jax_at_flagship_widths(k, n):
    """The widest (TransDown3) and narrowest (TransUp6) flagship 1x1
    widths, bf16 x with bias."""
    c = matmul_case(300, k, n, "bf16", False, True)
    got = K.fused_qact_matmul(_tx(c), _t(c["w"]), _t(c["bias"]),
                              _t(c["alpha"]), NA).numpy()
    want = np.asarray(jqm.fused_qact_matmul(
        _jx(c), jnp.asarray(c["w"]), _j(c["bias"]), c["alpha"], NA,
        tile_m=64, interpret=True))
    assert got.shape == want.shape == (300, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# the flagship's six transition 1x1 convs (voxels per 128^3 patch, K, N)
FLAGSHIP_1X1 = [(32768, 32, 64), (4096, 64, 128), (512, 128, 256),
                (512, 256, 128), (4096, 128, 64), (32768, 64, 32)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", FLAGSHIP_1X1,
                         ids=["x".join(map(str, s)) for s in FLAGSHIP_1X1])
def test_k4_plan_fills_the_card_and_covers_n(shape, batch, bf16):
    per_patch, k, n = shape
    m = per_patch * batch
    plan = K._k4_plan(m, k, n, bf16)
    tiles = -(-m // plan.bm)
    gx, chunks = plan.grid
    # persistent blocks: enough to fill 132 SMs, or one per row tile
    assert gx * chunks >= 132 or gx == tiles
    assert 1 <= gx <= tiles
    assert plan.smem <= 232448 and plan.threads == 256
    # the column chunks cover N exactly, each by whole thread quads
    assert chunks == -(-n // plan.nc) and (chunks - 1) * plan.nc < n
    tx = plan.nc // (4 * plan.rn)
    assert 256 % tx == 0 and plan.bm == (256 // tx) * 4
    # no thread owns only columns past N: at N = 32 a block is 32 wide
    assert plan.nc <= max(32, n)


def test_k4_plan_edges():
    """Remainder widths take the narrowest chunk that holds them; a K
    whose 32-column weights overflow a block raises."""
    assert K._k4_plan(1, 1, 1, False).nc == 32
    plan = K._k4_plan(4097, 264, 264, False)
    assert plan.nc * plan.grid[1] >= 264 and plan.smem <= 232448
    assert all(p.smem <= 232448 for _, p in K._k4_candidates(4097, 264,
                                                               264, True))
    with pytest.raises(ValueError, match="K = 4000"):
        K._k4_plan(64, 4000, 8, False)


def test_k4_vector_and_alpha_pass_through():
    """The wrapper's helpers copy nothing that is already in the kernel's
    form and make no tensor from a number."""
    from efficientq_tpu_torch import kernels

    b = torch.randn(5)
    assert kernels.vector_arg(b, 5, b, "bias") is b
    assert torch.equal(kernels.vector_arg(2.0, 3, b, "scale"),
                       torch.full((3,), 2.0))
    alpha = torch.tensor(0.9)
    assert kernels.alpha_arg(alpha, b)[0] is alpha
    assert kernels.alpha_arg(0.9, b) == (None, 0.9)
    with pytest.raises(ValueError, match="one value"):
        kernels.alpha_arg(torch.ones(2), b)
    call = K._k4_call(700, 32, 64, True, 4)
    plan = K._k4_plan(700, 32, 64, True)
    assert call is K._k4_call(700, 32, 64, True, 4)  # cached
    assert ((call.M, call.K, call.N, call.x_bf16, call.nc, call.rn,
             call.grid_x)
            == (700, 32, 64, 1, plan.nc, plan.rn, plan.grid[0]))
    assert call.delta == np.float32(1 / 3)
    with pytest.raises(ValueError, match="at least 2"):
        K._k4_call(700, 32, 64, True, 1)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("shape", FLAGSHIP_1X1,
                         ids=["x".join(map(str, s)) for s in FLAGSHIP_1X1])
def test_k3_plan_fills_the_card_and_covers_n(shape, batch, bf16):
    per_patch, k, n = shape
    m = per_patch * batch
    plan = K._k3_plan(m, k, n, bf16)
    tiles = -(-m // plan.bm)
    gx, chunks = plan.grid
    # persistent blocks: enough to fill 132 SMs, or one per row tile
    assert gx * chunks >= 132 or gx == tiles
    assert 1 <= gx <= tiles
    assert plan.smem <= 232448 and plan.threads == 256
    assert plan.smem == K._k3_smem(k, plan.bm, plan.nc, plan.stages,
                                   2 if bf16 else 4)
    # the column chunks cover N exactly
    assert chunks == -(-n // plan.nc) and (chunks - 1) * plan.nc < n
    # the 8 warps: wm x wn, each mt x nt mma tiles of 16 x 8
    wm = 8 // plan.wn
    assert wm * plan.wn == 8
    assert plan.bm == 16 * wm * plan.mt and plan.nc == 8 * plan.wn * plan.nt
    assert plan.mt * plan.nt <= 8 and 2 <= plan.stages <= 4


def test_k3_plan_edges():
    """Remainder shapes take a plan within a block's shared memory, all of
    K at once; a K whose rows do not fit a block at once is walked in the
    largest chunk that does (SwinUNETR's 1536 and 3072, and 20000); a K
    whose weights for 8 columns do not fit raises."""
    plan = K._k3_plan(1, 1, 1, False)
    assert plan.nc == 8 and plan.grid == (1, 1) and plan.kc == 0
    for m, k, n, bf16 in ((4097, 264, 264, False), (70, 12, 20, True),
                          (700, 512, 3, True)):
        plan = K._k3_plan(m, k, n, bf16)
        assert plan.nc * plan.grid[1] >= n and plan.smem <= 232448
        assert plan.kc == 0
        assert all(p.smem <= 232448 and p.nc <= 256
                   for _, p in K._k3_candidates(m, k, n, bf16))
    for m, k, n in ((4096, 1536, 384), (512, 3072, 768), (64, 20000, 8)):
        assert not list(K._k3_candidates(m, k, n, False))
        plan = K._k3_plan(m, k, n, False)
        assert plan.kc in K._K3_CHUNKS and plan.kc < k
        assert plan.smem == K._k3_smem(k, plan.bm, plan.nc, plan.stages, 4,
                                       plan.kc) <= 232448
        # the largest chunk that fits
        bigger = [c for c in K._K3_CHUNKS if plan.kc < c < k]
        assert not any(list(K._k3_candidates(m, k, n, False, c))
                       for c in bigger)
        assert K._k3_call(m, k, n, False, 4, act_k=1).kc == plan.kc
    with pytest.raises(ValueError, match="K = 30000"):
        K._k3_plan(64, 30000, 8, False)


@pytest.mark.parametrize("k,n", [(12, 20), (32, 64), (40, 3), (256, 128)])
def test_pack_weights_1x1_layout(k, n):
    """K3's packed layout is the codes transposed to [n][k] and zero-padded
    to a multiple of 32 along k, from (K, N) or (1, 1, 1, K, N) codes."""
    codes = np.random.RandomState(k + n).randint(-127, 128, size=(k, n))
    codes = codes.astype(np.int8)
    kp = -(-k // 32) * 32
    want = np.zeros((n, kp), np.int8)
    want[:, :k] = codes.T
    for shape in ((k, n), (1, 1, 1, k, n)):
        got = K.pack_weights_1x1(torch.from_numpy(codes.reshape(shape)))
        assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


def test_k3_call_and_scale_pass_through():
    """The wrapper's scale helper copies and expands nothing and makes no
    tensor from a number; the call struct is cached and carries the
    plan."""
    like = torch.zeros(2, 3)
    s0 = torch.tensor(0.05)
    assert K._scale(s0, 7, like)[0] is s0 and K._scale(s0, 7, like)[2] == 0
    assert K._scale(0.25, 7, like) == (None, 0.25, 0)
    s1 = torch.full((1,), 0.5)
    assert K._scale(s1, 7, like)[0] is s1
    sv = torch.rand(7)
    assert K._scale(sv, 7, like) == (sv, 0.0, 1)
    t, v, stride = K._scale(np.float32(0.125), 7, like)
    assert (t, v, stride) == (None, 0.125, 0)
    with pytest.raises(ValueError, match="scale"):
        K._scale(torch.ones(3), 7, like)
    call = K._k3_call(700, 32, 64, True, 4)
    plan = K._k3_plan(700, 32, 64, True)
    assert call is K._k3_call(700, 32, 64, True, 4)  # cached
    assert ((call.M, call.K, call.N, call.qlvl, call.x_bf16, call.bm,
             call.nc, call.mt, call.nt, call.wn, call.stages, call.grid_x)
            == (700, 32, 64, 4, 1, plan.bm, plan.nc, plan.mt, plan.nt,
                plan.wn, plan.stages, plan.grid[0]))
    assert K._k3_call(700, 32, 64, False, 4).x_bf16 == 0
    with pytest.raises(ValueError, match="2..128"):
        K._k3_call(700, 32, 64, True, 129)


def test_int8_deploy_packs_every_1x1(tiny):
    """to_int8_inference gives each int8 1x1x1 conv K3's packed weights
    (and each flagged 3^3 conv K1's); the mixed deployment has no int8
    1x1 conv to pack."""
    (_, _), (tg, tv) = tiny["int8"]
    ones = [n for n in tg.nodes if n.attrs.get("int8")
            and n.attrs["kernel_size"] == (1, 1, 1)]
    assert ones
    for node in ones:
        p = tv["params"][node.name]
        assert torch.equal(p["kernel_packed"],
                           K.pack_weights_1x1(p["kernel_int8"]))
    (_, _), (mg, mv) = tiny["mixed"]
    assert not any("kernel_packed" in mv["params"][n.name] for n in mg.nodes
                   if n.op == "conv" and n.attrs["kernel_size"] == (1, 1, 1))


def test_flagged_int8_forward_passes_packed_weights(tiny):
    """nnir hands each flagged int8 1x1 conv's packed weights to the K3
    hook as its seventh argument."""
    (_, _), (tg, tv) = tiny["int8"]
    got = []

    def hook(*a):
        got.append(a[6])
        return K.fused_int8_matmul_reference(*a)

    nnir.apply(tg, tv, torch.from_numpy(_x(1)), mode="quantized",
               kernels=WRAPPERS._replace(int8_matmul=hook))
    assert got and all(w is not None and w.dtype == torch.int8
                       and w.shape[1] % 32 == 0 for w in got)


def test_qconv1x1_matches_jax():
    rng = np.random.RandomState(1)
    x = np.abs(rng.randn(2, 4, 5, 6, 8)).astype(np.float32)
    k = (rng.randn(1, 1, 1, 8, 16) * 0.2).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    got = K.qconv1x1_ndhwc(torch.from_numpy(x), torch.from_numpy(k),
                           torch.from_numpy(b), torch.tensor(0.9), 16)
    want = jqm.qconv1x1_ndhwc(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                              0.9, 16, interpret=True)
    assert tuple(got.shape) == want.shape == (2, 4, 5, 6, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the matmul hook takes K4's place
    calls = []

    def hook(*a):
        calls.append(a[0].shape)
        return K.fused_qact_matmul_reference(*a)

    K.qconv1x1_ndhwc(torch.from_numpy(x), torch.from_numpy(k), None,
                     torch.tensor(0.9), 16, matmul=hook)
    assert calls == [(240, 8)]


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain versions and count no launch; a tensor
    on another device raises."""
    c = matmul_case(*MATMUL_CASES[0])
    k3, k4 = K.fused_int8_matmul.launches, K.fused_qact_matmul.launches
    args3 = (_t(c["codes"]), _t(c["bias"]), _t(c["alpha"]), _t(c["scale"]),
             NA)
    np.testing.assert_array_equal(
        K.fused_int8_matmul(_tx(c), *args3).numpy(),
        K.fused_int8_matmul_reference(_tx(c), *args3).numpy())
    args4 = (_t(c["w"]), _t(c["bias"]), _t(c["alpha"]), NA)
    np.testing.assert_array_equal(
        K.fused_qact_matmul(_tx(c), *args4).numpy(),
        K.fused_qact_matmul_reference(_tx(c), *args4).numpy())
    assert (K.fused_int8_matmul.launches, K.fused_qact_matmul.launches) == (
        k3, k4)
    meta = torch.zeros(4, 12, device="meta")
    with pytest.raises(ValueError, match="K3 runs on CUDA or"):
        K.fused_int8_matmul(meta, *args3)
    with pytest.raises(ValueError, match="K4 runs on CUDA or"):
        K.fused_qact_matmul(meta, *args4)


def _flags(g):
    return sorted(n.name for n in g.nodes if n.attrs.get("pallas"))


def _assert_params_equal(tv, jv):
    jp = _np_vars(jv)["params"]
    assert set(tv["params"]) == set(jp)
    for node, entries in jp.items():
        # kernel_packed: K1's own weight layout, made at deploy time
        assert set(tv["params"][node]) - {"kernel_packed"} == set(entries)
        for k, want in entries.items():
            np.testing.assert_array_equal(tv["params"][node][k].numpy(), want,
                                          err_msg=f"{node}.{k}")


def _flagged_graphs(jfg, jfv, tfg, tfv):
    """{name: ((JAX graph, vars), (port graph, vars))} for the undeployed,
    int8 and mixed graphs, each flagged with include_1x1."""
    out = {"undeployed": ((jqm.to_pallas_inference(jfg, include_1x1=True),
                           jfv),
                          (K.to_pallas_inference(tfg, include_1x1=True),
                           tfv))}
    for name, only in (("int8", None), ("mixed", MIXED)):
        jdg, jdv = jdeploy(jfg, jfv, pallas=True, only_kernel_sizes=only)
        tdg, tdv = to_int8_inference(tfg, tfv, only_kernel_sizes=only)
        assert _graph_key(tdg) == _graph_key(jdg), name
        out[name] = ((jqm.to_pallas_inference(jdg, include_1x1=True), jdv),
                     (K.to_pallas_inference(tdg, include_1x1=True), tdv))
    return out


@pytest.fixture(scope="module")
def tiny():
    jg, tg, jv = _both("tiny-mid")
    jfg, jfv = _post_ptq(*jfold(jg, jv))
    tfg, _ = fold_bn(tg, _port_vars(jv))
    return _flagged_graphs(jfg, jfv, tfg, _port_vars(jfv))


def test_include_1x1_flags_match_jax_tiny(tiny):
    for name, ((jg, jv), (tg, tv)) in tiny.items():
        assert _graph_key(tg) == _graph_key(jg), name
        _assert_params_equal(tv, jv)
        ones = [n for n in tg.nodes if n.attrs.get("pallas")
                and n.attrs["kernel_size"] == (1, 1, 1)]
        assert ones and not any(n.attrs.get("input_quantized") for n in ones)
        assert all(bool(n.attrs.get("int8")) == (name == "int8")
                   for n in ones), name


def test_include_1x1_flags_match_jax_flagship():
    """The BraTS W4A4 preset: the six transition 1x1 convs are flagged,
    int8 under the int8 deployment, float under the mixed one."""
    jg, tg = jbuild(jpreset("brats", quantize=True)), build_uresq(
        preset_config("brats", quantize=True))
    # the port's NumPy init is much faster than JAX's at this size; both
    # packages then start from the same weights
    jv = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                nnir.init(tg, 0, device="cpu"))
    jfg, jfv = _post_ptq(*jfold(jg, jv), alpha_act=1.0)
    tfg, _ = fold_bn(tg, _port_vars(jv))
    graphs = _flagged_graphs(jfg, jfv, tfg, _port_vars(jfv))
    for name, ((jdg, jdv), (tdg, tdv)) in graphs.items():
        assert _graph_key(tdg) == _graph_key(jdg), name
        _assert_params_equal(tdv, jdv)
        ones = [n for n in tdg.nodes if n.attrs.get("pallas")
                and n.attrs["kernel_size"] == (1, 1, 1)]
        assert len(ones) == 6, (name, [n.name for n in ones])
        assert all("trans_" in n.name for n in ones)
        assert all(bool(n.attrs.get("int8")) == (name == "int8")
                   for n in ones)
        n_k1 = sum(1 for n in tdg.nodes if n.attrs.get("pallas")
                   and n.attrs["kernel_size"] == (3, 3, 3))
        assert n_k1 == (0 if name == "undeployed" else 14), name


def _x(seed=0, shape=(1, 16, 16, 16, 2)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _apply_pair(jg, jv, tg, tv, mode, x, compute_dtype=None, kernels=None):
    want = np.asarray(jnnir.apply(
        jg, jv, jnp.asarray(x), mode=mode,
        precision=jax.lax.Precision.HIGHEST,
        compute_dtype=None if compute_dtype is None else jnp.bfloat16))
    got = nnir.apply(tg, tv, torch.from_numpy(x), mode=mode,
                     compute_dtype=compute_dtype, kernels=kernels).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    return got, want


@pytest.mark.parametrize("name", ["int8", "mixed"])
def test_flagged_forward_matches_jax(tiny, name):
    """Quantized mode at float32: the port (plain K1, K3, K4 on the CPU)
    against JAX (interpret-mode kernels); the hooks see every flagged 1x1."""
    (jg, jv), (tg, tv) = tiny[name]
    seen = []

    def spy(fn):
        def wrapped(*a):
            seen.append(fn.__name__)
            return fn(*a)
        return wrapped

    got, want = _apply_pair(
        jg, jv, tg, tv, "quantized", _x(1),
        kernels=WRAPPERS._replace(
            int8_matmul=spy(K.fused_int8_matmul_reference),
            qact_matmul=spy(K.fused_qact_matmul_reference)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    n_ones = sum(1 for n in tg.nodes if n.attrs.get("pallas")
                 and n.attrs["kernel_size"] == (1, 1, 1)
                 and n.name in nnir.live_nodes(tg, tg.outputs))
    kind = ("fused_int8_matmul_reference" if name == "int8"
            else "fused_qact_matmul_reference")
    assert seen == [kind] * n_ones and n_ones > 0


def test_mixed_forward_bf16_matches_jax(tiny):
    (jg, jv), (tg, tv) = tiny["mixed"]
    got, want = _apply_pair(jg, jv, tg, tv, "quantized", _x(2),
                            compute_dtype=BF16)
    np.testing.assert_allclose(got, want, atol=0.05)
    assert np.mean((got >= 0) == (want >= 0)) > 0.999


@pytest.mark.parametrize("flagged", [False, True],
                         ids=["unflagged", "include_1x1"])
def test_fq_forward_matches_jax(flagged):
    """fq mode on the undeployed graph with unprojected weights (alpha_w =
    max|w|), so the weights are fake-quantized on the fly."""
    jg, tg, jv = _both("tiny-mid")
    jfg, jfv = jfold(jg, jv)
    for node in jfg.qconv_nodes():
        p = jfv["params"][node.name]
        p["alpha_w"] = jnp.maximum(jnp.max(jnp.abs(p["kernel"])), 1e-8)
        p["alpha_act"] = jnp.float32(0.8)
    tfg, _ = fold_bn(tg, _port_vars(jv))
    tfv = _port_vars(jfv)
    if flagged:
        jfg = jqm.to_pallas_inference(jfg, include_1x1=True)
        tfg = K.to_pallas_inference(tfg, include_1x1=True)
        assert _graph_key(tfg) == _graph_key(jfg) and _flags(tfg)
    got, want = _apply_pair(jfg, jfv, tfg, tfv, "fq", _x(3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # fq quantizes the weights: the forward differs from 'quantized' mode
    quantized = nnir.apply(tfg, tfv, torch.from_numpy(_x(3)),
                           mode="quantized").numpy()
    assert np.abs(quantized - got).max() > 1e-3


def test_flagged_1x1_refuses_codes(tiny):
    (_, _), (tg, tv) = tiny["int8"]
    name = next(n.name for n in tg.nodes if n.attrs.get("pallas")
                and n.attrs["kernel_size"] == (1, 1, 1))
    node = tg.node(name)
    bad = type(node)(node.name, node.op, node.inputs,
                     dict(node.attrs, input_quantized=True))
    x = torch.zeros(1, 2, 2, 2, node.attrs["in_ch"])
    with pytest.raises(ValueError, match="int8 codes"):
        nnir.eval_node(bad, tv["params"], tv["state"], [x],
                       mode="quantized")


def test_mixed_k4_volume_inferencer_matches_jax(tiny):
    (jg, jv), (tg, tv) = tiny["mixed"]
    vol = _x(4, (1, 24, 24, 24, 2))
    kw = dict(patch_batch=4, mode="quantized", heads=slice(-1, None))
    want = np.asarray(jsliding.make_jitted_volume_inferencer(jg, **kw)(
        jv, jnp.asarray(vol), (16, 16, 16), (8, 8, 8)))
    before = K.fused_qact_matmul.launches
    got = sliding.make_volume_inferencer(tg, **kw)(
        tv, torch.from_numpy(vol), (16, 16, 16), (8, 8, 8)).numpy()
    assert K.fused_qact_matmul.launches == before  # CPU: the plain K4
    assert got.shape == want.shape == (1, 1, 24, 24, 24, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
