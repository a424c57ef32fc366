"""The s2d bf16 serving slice against the JAX package: the space-to-depth
helpers, K2's plain version (``stem_s2d_conv_reference``) against the
Pallas stem in interpret mode, K1's plain version at bfloat16 output and
residual, the serving rewrites, ``nnir.apply(compute_dtype=bf16)`` and the
s2d inferencer, at the fixture sizes of tests/test_stem_s2d.py (widths
8-16-8, volume 39x48x48, patch 32, overlap 8).

Tolerances.  Transforms, rewrites, parameters and int8 codes are equal, and
bfloat16 tensors are compared bit for bit (uint16 views).  K2's float32
output: atol 1e-5 (the interpret-mode kernel sums 32C bf16 products per
tap in float32, the plain version in float64).  K1 at bfloat16 equals the
JAX kernel bit for bit: the integer sum is exact and the float steps round
at the same places.  Whole-network bf16 forwards: atol 0.05 on the logits
and > 0.999 agreement of hard predictions, the JAX package's own level
(bf16 reduction order differs between the two convs; 2-bit codes absorb
it except for rare quantizer-tie flips).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu import ops as jops
from efficientq_tpu.eval import sliding as jsliding
from efficientq_tpu.models import UResQConfig as JCfg
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.pallas import stem as jstem
from efficientq_tpu.pallas.qconv3d import _xla_qconv3x3
from efficientq_tpu.pallas.qconv3d import qconv3x3_int8_ndhwc as jax_k1
from efficientq_tpu.ptq import deploy as jdeploy
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.quant import fake_quant_weight as jfqw
from efficientq_tpu_torch import nnir, ops
from efficientq_tpu_torch.eval import sliding
from efficientq_tpu_torch.kernels import WRAPPERS
from efficientq_tpu_torch.kernels import qconv3d as K
from efficientq_tpu_torch.kernels import stem
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.ptq import deploy, fold_bn
from efficientq_tpu_torch.quant import act_codes
from test_torch_port_cuda import CASES, NA, make_case

CFG = dict(num_mod=4, num_classes=3, depth_config=[1, 1, 1],
           width_config=[8, 16, 8], dilation_config=[1, 1, 1],
           init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid", ds="simple",
           quantize=True, qlvl_w=4, qlvl_act=4, q_first=(256, -1),
           q_last=(256, -1))
VOL = (39, 48, 48)  # z starts {0, 7}: both parities
PATCH, OVERLAP = (32, 32, 32), (8, 8, 8)
BF16 = torch.bfloat16
ATTRS = dict(kernel_size=(3, 3, 3), stride=(2, 2, 2), padding=(1, 1, 1),
             dilation=(1, 1, 1), groups=1)


def _bits(a):
    """uint16 bits of a bfloat16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _np_vars(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _norm(v):
    if dataclasses.is_dataclass(v):
        return ("QCfg",) + dataclasses.astuple(v)
    return v


def _graph_key(g):
    return ([(n.name, n.op, tuple(n.inputs),
              {k: _norm(v) for k, v in n.attrs.items()}) for n in g.nodes],
            list(g.outputs), g.input_name)


def _volume(seed, shape=VOL):
    return np.random.RandomState(seed).randn(1, *shape, 4).astype(np.float32)


@pytest.fixture(scope="module")
def deployed():
    """The int8 deployment of the fixture net in both packages, from the
    same post-PTQ weights."""
    jg = jbuild(JCfg(**CFG))
    jfg, jfv = jfold(jg, jnnir.init(jg, jax.random.PRNGKey(0)))
    for node in jfg.qconv_nodes():
        q = node.attrs["qcfg"]
        p = jfv["params"][node.name]
        if q.q_weight:
            a = jnp.maximum(jnp.max(jnp.abs(p["kernel"])), 1e-8)
            p["kernel"] = jfqw(p["kernel"], a, q.qlvl_w)
            p["alpha_w"] = a
        if q.q_act:
            p["alpha_act"] = jnp.float32(1.0)
    jig, jiv = jdeploy.to_int8_inference(jfg, jfv, pallas=True)
    tg = build_uresq(UResQConfig(**CFG))
    tfg, _ = fold_bn(tg, nnir.init(tg, 0, device="cpu"))
    tfv = torch_io.from_jax_variables(_np_vars(jfv), device="cpu")
    tig, tiv = deploy.to_int8_inference(tfg, tfv)
    return (jig, jiv), (tig, tiv), (tfg, tfv)


@pytest.fixture(scope="module")
def s2d_graphs(deployed):
    (jig, jiv), (tig, tiv), _ = deployed
    jcg = jdeploy.channels_first_tail(jig)
    jsg, jsv, jst = jdeploy.s2d_stem_serving(jcg, jiv)
    tcg = deploy.channels_first_tail(tig)
    tsg, tsv, tst = deploy.s2d_stem_serving(tcg, tiv)
    return (jcg, jsg, jsv, jst), (tcg, tsg, tsv, tst)


def test_s2d_stem_weights_match_jax():
    w3 = np.random.RandomState(0).randn(3, 3, 3, 4, 8).astype(np.float32)
    for got, want in zip(stem.s2d_stem_weights(w3),
                         jstem.s2d_stem_weights(w3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [22, 23])  # even-only and odd z starts
def test_s2d_transforms_bit_equal_jax(depth):
    vol_shape, patch = (depth, 32, 32), (16, 16, 16)
    vol = (np.random.RandomState(depth).randn(1, *vol_shape, 4) * 10
           ).astype(np.float32)
    vol[0, 1, 2, 3, 1] = np.nan
    vol[0, 7, 1, 1, 3] = -np.nan
    vol[0, 0, 0, 0, 0] = np.inf
    vol[0, 5, 5, 5, 2] = -np.inf
    starts = jsliding.patch_grid(vol_shape, patch, (4, 4, 4))
    assert stem.s2d_supported(starts, patch, vol_shape, ATTRS)
    need = stem.s2d_need_planes(starts, patch)
    assert need == jstem.s2d_need_planes(starts, patch)
    tv, jv = torch.from_numpy(vol), jnp.asarray(vol)
    for minp in (0, need):
        np.testing.assert_array_equal(
            _bits(stem.s2d_volume(tv, minp)),
            _bits(jstem.s2d_volume(jv, minp, dtype=jnp.bfloat16)))
    np.testing.assert_array_equal(
        stem.s2d_volume(tv, dtype=torch.float32).numpy(),
        np.asarray(jstem.s2d_volume(jv, dtype=jnp.float32)))
    got, got_par = stem.extract_s2d_patches(tv, starts, patch)
    want, want_par = jstem.extract_s2d_patches(jv, starts, patch)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got_par.numpy(), np.asarray(want_par))
    assert (int(got_par.sum()) > 0) == (depth % 2 == 1)
    pre, pre_par = stem.extract_pre_s2d_patches(
        stem.s2d_volume(tv, need), starts, patch)
    np.testing.assert_array_equal(_bits(pre), _bits(want))
    np.testing.assert_array_equal(pre_par.numpy(), np.asarray(want_par))
    with pytest.raises(ValueError, match="planes"):
        stem.extract_pre_s2d_patches(stem.s2d_volume(tv, 1)[:, :need - 1],
                                     starts, patch)


def _stem_case(depth):
    """tests/test_stem_s2d.py's kernel case: C = 4, O = 8."""
    rng = np.random.RandomState(depth)
    c, o = 4, 8
    vol_shape, patch = (depth, 32, 32), (16, 16, 16)
    w3 = rng.randn(3, 3, 3, c, o).astype(np.float32) * 0.1
    bias = rng.randn(o).astype(np.float32) * 0.1
    vol = rng.randn(1, *vol_shape, c).astype(np.float32)
    starts = jsliding.patch_grid(vol_shape, patch, (4, 4, 4))
    sp, par = jstem.extract_s2d_patches(jnp.asarray(vol), starts, patch)
    we, wo = jstem.s2d_stem_weights(w3)
    return sp, par, we, wo, bias


@pytest.mark.parametrize("depth", [22, 23])
def test_plain_k2_matches_jax(depth):
    sp, par, we, wo, bias = _stem_case(depth)
    alpha, qlvl = 0.7, 4
    jw = [jnp.asarray(w, jnp.bfloat16) for w in (we, wo)]
    tx = torch_io.from_jax_variables({"params": {"s": {
        "x": np.asarray(sp), "p": np.asarray(par),
        "we": np.asarray(jw[0]), "wo": np.asarray(jw[1])}}},
        device="cpu")["params"]["s"]
    before = stem.stem_s2d_conv.launches
    outs = {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        y, q = stem.stem_s2d_conv(tx["x"], tx["p"], tx["we"], tx["wo"],
                                  torch.from_numpy(bias), alpha, qlvl,
                                  out_dtype=tdt)
        jy, jq = jstem.stem_s2d_conv(sp, par, *jw, jnp.asarray(bias), alpha,
                                     qlvl, interpret=True, out_dtype=jdt)
        assert y.dtype == tdt and tuple(y.shape) == jy.shape
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        # bf16: within 1e-5 and one bf16 ulp, at most 2^-7 of the value
        # (a float32 value near a rounding boundary can round either way)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)),
                                   atol=1e-5, rtol=0 if jy.dtype ==
                                   jnp.float32 else 2.0 ** -7)
        outs[tdt] = y
    # the bf16 output is the float32 epilogue's value, rounded once
    np.testing.assert_array_equal(_bits(outs[BF16]),
                                  _bits(outs[torch.float32].to(BF16)))
    assert stem.stem_s2d_conv.launches == before  # CPU: the plain version
    with pytest.raises(ValueError, match="CUDA or"):
        stem.stem_s2d_conv(tx["x"].to("meta"), tx["p"], tx["we"], tx["wo"],
                           torch.from_numpy(bias), alpha, qlvl)


def _jax_k1_bf16(case, res_bits):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    res = None if res_bits is None else jnp.asarray(res_bits)
    out = jax_k1(j(case["x"]), j(case["codes"]), j(case["bias"]),
                 jnp.float32(case["alpha"]), j(case["scale"]), NA,
                 interpret=True, out_dtype=jnp.bfloat16, residual=res,
                 **case["kw"])
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k1_bf16_matches_jax(name):
    case = make_case(sorted(CASES).index(name), **CASES[name])
    res_bits = (None if case["residual"] is None
                else case["residual"].astype(ml_dtypes.bfloat16))
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    kw = dict(case["kw"])
    if "quant_alpha" in kw:
        kw["quant_alpha"] = t(kw["quant_alpha"])
    res = (None if res_bits is None else torch.from_numpy(
        res_bits.view(np.int16)).view(BF16))
    got = K.qconv3x3_int8_ndhwc(t(case["x"]), t(case["codes"]),
                                t(case["bias"]), t(case["alpha"]),
                                t(case["scale"]), NA, residual=res,
                                out_dtype=BF16, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = _jax_k1_bf16(case, res_bits)
    x = jnp.asarray(case["x"])
    qa = x if kw["x_quantized"] else jnp.round(
        jnp.clip(x / case["alpha"], 0.0, 1.0) * (NA - 1)).astype(jnp.int8)
    xla = _xla_qconv3x3(
        qa, jnp.asarray(case["codes"]), jnp.asarray(case["bias"]),
        jnp.asarray(case["scale"]), kw["dilation"], jnp.bfloat16,
        None if res_bits is None else jnp.asarray(res_bits),
        kw["residual_relu"], jnp.float32(case["kw"].get("quant_alpha", 1.0)),
        kw.get("quant_qlvl", 0), kw["pool"])
    xla = xla if isinstance(xla, tuple) else (xla,)
    assert len(got) == len(want) == len(xla)
    for g, w, r in zip(got, want, xla):
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        else:
            assert g.dtype == BF16 and w.dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bits(g), _bits(w))
            np.testing.assert_array_equal(_bits(g), _bits(r))


def test_act_quant_of_bf16_promotes_like_jax():
    """The codes of a bfloat16 activation are taken in float32, as JAX
    promotes bf16 / f32; a bfloat16 division would change some codes."""
    x = (np.random.RandomState(0).rand(4096) * 1.2).astype(ml_dtypes.bfloat16)
    alpha, n = np.float32(0.7), 4
    want = np.asarray(jnp.round(jnp.clip(jnp.asarray(x) / jnp.asarray(alpha),
                                         0.0, 1.0) * (n - 1)).astype(jnp.int8))
    tx = torch.from_numpy(x.view(np.int16)).view(BF16)
    np.testing.assert_array_equal(
        act_codes(tx, torch.tensor(alpha), n).numpy(), want)
    naive = torch.round(torch.clamp(tx / torch.tensor(alpha), 0, 1) * (n - 1))
    assert (naive.to(torch.int8).numpy() != want).any()


def test_serving_rewrites_match_jax(s2d_graphs):
    (jcg, jsg, jsv, jst), (tcg, tsg, tsv, tst) = s2d_graphs
    assert _graph_key(tcg) == _graph_key(jcg)
    assert jst is not None and tst is not None and tst.op == "stem_s2d"
    assert _graph_key(tsg) == _graph_key(jsg)
    jp = _np_vars(jsv)["params"]
    assert set(tsv["params"]) == set(jp)
    for node, entries in jp.items():
        # kernel_packed: K1's own weight layout, made at deploy time
        assert set(tsv["params"][node]) - {"kernel_packed"} == set(entries)
        for k, want in entries.items():
            got = tsv["params"][node][k]
            if want.dtype.name == "bfloat16":
                assert got.dtype == BF16
                np.testing.assert_array_equal(_bits(got), _bits(want))
            else:
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{node}.{k}")


def test_s2d_stem_node_carries_packed_weights(s2d_graphs):
    """The rewrite packs K2's weights once, at deploy time, and the stem
    node hands them to the kernel's wrapper."""
    _, (_, tsg, tsv, tst) = s2d_graphs
    p = tsv["params"][tst.name]
    want = stem.pack_stem_weights(p["w_even"], p["w_odd"])
    assert torch.equal(p["kernel_packed"].view(torch.int16),
                       want.view(torch.int16))
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return stem.stem_s2d_conv_reference(*args, **kw)

    img = torch.from_numpy(_volume(3, (32, 32, 32)))
    xs, par = stem.extract_s2d_patches(img, [(0, 0, 0)], PATCH)
    nnir.apply(tsg, tsv, (xs, par), mode="quantized", compute_dtype=BF16,
               kernels=WRAPPERS._replace(stem_conv=spy))
    assert seen["w_packed"] is p["kernel_packed"]


def test_from_jax_variables_carries_bf16():
    w = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    jw = np.asarray(jnp.asarray(w, jnp.bfloat16))
    got = torch_io.from_jax_variables({"params": {"n": {"w": jw}}},
                                      device="cpu")["params"]["n"]["w"]
    assert got.dtype == BF16
    np.testing.assert_array_equal(_bits(got), jw.view(np.uint16))


def test_s2d_apply_bf16_matches_jax(s2d_graphs):
    """nnir.apply(compute_dtype=bf16) on the s2d graph, patch by patch,
    against JAX's, from the same s2d patches."""
    (_, jsg, jsv, _), (_, tsg, tsv, _) = s2d_graphs
    vol = _volume(0)
    starts = jsliding.patch_grid(VOL, PATCH, OVERLAP)
    jx, jpar = jstem.extract_s2d_patches(jnp.asarray(vol), starts, PATCH)
    tx, tpar = stem.extract_s2d_patches(torch.from_numpy(vol), starts, PATCH)
    want = np.asarray(jnnir.apply(jsg, jsv, (jx, jpar), mode="quantized",
                                  compute_dtype=jnp.bfloat16))
    got = nnir.apply(tsg, tsv, (tx, tpar), mode="quantized",
                     compute_dtype=BF16).numpy()
    assert got.shape == want.shape == (1, len(starts), 3, *PATCH)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=0.05)
    assert np.mean((got >= 0) == (want >= 0)) > 0.999


def test_direct_bf16_inferencer_matches_jax(deployed):
    (jig, jiv), (tig, tiv), _ = deployed
    kw = dict(patch_batch=8, mode="quantized", hard_pred=True,
              multilabel=True, heads=slice(-1, None))
    vol = _volume(2)
    want = np.asarray(jsliding.make_jitted_volume_inferencer(
        jig, compute_dtype=jnp.bfloat16, **kw)(jiv, jnp.asarray(vol), PATCH,
                                               OVERLAP))
    got = sliding.make_volume_inferencer(tig, compute_dtype=BF16, **kw)(
        tiv, torch.from_numpy(vol), PATCH, OVERLAP).numpy()
    assert got.shape == want.shape == (1, 1, *VOL, 3)
    assert np.mean(got == want) > 0.999


def test_s2d_inferencer_matches_jax(deployed):
    """The port's make_s2d_volume_inferencer against JAX's, final head,
    multilabel hard prediction; a volume the s2d grid cannot serve (odd H)
    falls back to the port's direct bf16 inferencer exactly."""
    (jig, jiv), (tig, tiv), (tfg, tfv) = deployed
    kw = dict(multilabel=True, heads=slice(-1, None))
    jinfer = jdeploy.make_s2d_volume_inferencer(jig, jiv, **kw)
    tinfer = deploy.make_s2d_volume_inferencer(tig, tiv, device="cpu", **kw)
    vol = _volume(0)
    want = np.asarray(jinfer(None, vol, PATCH, OVERLAP))
    got = tinfer(None, vol, PATCH, OVERLAP).numpy()
    assert got.shape == want.shape == (1, 1, *VOL, 3)
    assert got.dtype == np.uint8
    assert np.mean(got == want) > 0.999

    odd = _volume(1, (39, 47, 48))
    direct = sliding.make_volume_inferencer(
        tig, patch_batch=8, mode="quantized", hard_pred=True,
        compute_dtype=BF16, **kw)(tiv, torch.from_numpy(odd), PATCH, OVERLAP)
    np.testing.assert_array_equal(tinfer(None, odd, PATCH, OVERLAP).numpy(),
                                  direct.numpy())
    # no eligible stem (the graph before the int8 deployment): None
    assert deploy.make_s2d_volume_inferencer(tfg, tfv, device="cpu") is None


def test_channels_first_pieces_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 4, 5, 6).astype(np.float32)
    np.testing.assert_allclose(
        ops.upsample3d_cf(torch.from_numpy(x), 2).numpy(),
        np.asarray(jops.upsample3d_cf(jnp.asarray(x), 2)), atol=1e-6)
    vol = (12, 10, 14)
    starts = sliding.patch_grid(vol, (8, 6, 8), (3, 2, 2))
    preds = rng.randn(len(starts), 2, 1, 3, 8, 6, 8).astype(np.float32)
    for normalize in (True, False):
        np.testing.assert_array_equal(
            sliding.stitch_patches(torch.from_numpy(preds), starts, vol,
                                   channels_first=True,
                                   normalize=normalize).numpy(),
            np.asarray(jsliding.stitch_patches(
                jnp.asarray(preds), starts, vol, channels_first=True,
                normalize=normalize)))
