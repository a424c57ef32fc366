"""The port's graph, its transforms and its forwards against the JAX
package, node for node and on the same weights (carried over with
``torch_io.from_jax_variables``).

Tolerances: graphs, folded and deployed parameters, and checkpoint loads
are identical.  Forwards: rtol/atol 1e-5, which covers the float32 sum
order of the float convs and ``jax.image.resize`` against
``F.interpolate(align_corners=False)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu.models import UResQConfig as JCfg
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.models import preset_config as jpreset
from efficientq_tpu.models import torch_io as jtio
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq.deploy import to_int8_inference as jdeploy
from efficientq_tpu.quant import fake_quant_weight as jfqw
from efficientq_tpu.quant import pack_int_weight as jpack
from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.models import min_input_divisor, num_mo
from efficientq_tpu_torch.models import preset_config, validate_spatial_shape
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from efficientq_tpu_torch.kernels.qconv3d import pack_weights
from efficientq_tpu_torch.ptq.deploy import eligible

TINY = dict(num_mod=2, num_classes=3, depth_config=[1, 1, 1],
            width_config=[4, 8, 4], dilation_config=[1, 1, 1],
            init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid", ds="simple",
            ds_depth_limit=3, fuse_bn=True, quantize=True, qlvl_w=4,
            qlvl_act=4, q_first=(256, -1), q_last=(256, -1))

CONFIGS = {
    "tiny-mid": TINY,
    "tiny-pre-complex": dict(TINY, blk_type="pre", ds="complex"),
    "tiny-post-dilated": dict(TINY, blk_type="post", dilation_config=[1, 2, 1],
                              ds=None),
    "tiny-fp": dict(TINY, quantize=False, depth_config=[2, 1, 2]),
}


def _norm(v):
    """Attribute values comparable across the two packages' QCfg classes."""
    if dataclasses.is_dataclass(v):
        return ("QCfg",) + dataclasses.astuple(v)
    return v


def _graph_key(g):
    return ([(n.name, n.op, tuple(n.inputs),
              {k: _norm(v) for k, v in n.attrs.items()}) for n in g.nodes],
            list(g.outputs), g.input_name)


def _np_vars(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _port_vars(v):
    return torch_io.from_jax_variables(_np_vars(v), device="cpu")


def _assert_vars_equal(tv, jv):
    jv = _np_vars(jv)
    for group in ("params", "state"):
        assert set(tv[group]) == set(jv.get(group, {})), group
        for node, entries in jv.get(group, {}).items():
            for k, want in entries.items():
                got = tv[group][node][k]
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{node}.{k}")


def _both(name, seed=0):
    jg = jbuild(JCfg(**CONFIGS[name]))
    tg = build_uresq(UResQConfig(**CONFIGS[name]))
    jv = jnnir.init(jg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    for n, s in jv["state"].items():  # non-trivial BN statistics
        s["mean"] = jnp.asarray(rng.randn(*s["mean"].shape).astype(np.float32)
                                * 0.1)
        s["var"] = jnp.asarray((np.abs(rng.randn(*s["var"].shape)) * 0.3
                                + 0.7).astype(np.float32))
    return jg, tg, jv


def _post_ptq(fg, fv, alpha_act=0.8):
    """bench.py's post-PTQ emulation on the JAX side."""
    for node in fg.qconv_nodes():
        q = node.attrs["qcfg"]
        p = fv["params"][node.name]
        if q.q_weight:
            a = jnp.maximum(jnp.max(jnp.abs(p["kernel"])), 1e-8)
            p["kernel"] = jfqw(p["kernel"], a, q.qlvl_w)
            p["alpha_w"] = a
        if q.q_act:
            p["alpha_act"] = jnp.float32(alpha_act)
    return fg, fv


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_build_uresq_matches_jax(name):
    jg, tg, _ = _both(name)
    assert _graph_key(tg) == _graph_key(jg)


@pytest.mark.parametrize("task", ["brats", "lits"])
def test_presets_match_jax(task):
    tc, jc = preset_config(task, quantize=True), jpreset(task, quantize=True)
    assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
    assert _graph_key(build_uresq(tc)) == _graph_key(jbuild(jc))
    assert num_mo(tc) == 3 and min_input_divisor(tc) == (
        (16, 16, 16) if task == "brats" else (32, 32, 16))
    with pytest.raises(ValueError, match="incompatible"):
        validate_spatial_shape((24, 24, 24), tc, "patch")


def test_init_is_seeded_kaiming():
    g = build_uresq(UResQConfig(**TINY))
    a, b = nnir.init(g, 3, device="cpu"), nnir.init(g, 3, device="cpu")
    k = a["params"]["u_blocks.UResBlock2.Layer1.block1.conv"]["kernel"]
    assert torch.equal(k, b["params"]["u_blocks.UResBlock2.Layer1.block1.conv"]
                       ["kernel"])
    assert k.shape == (3, 3, 3, 8, 8) and k.dtype == torch.float32
    assert abs(float(k.std()) - np.sqrt(2.0 / (27 * 8))) < 0.03
    assert not torch.equal(k, nnir.init(g, 4, device="cpu")["params"][
        "u_blocks.UResBlock2.Layer1.block1.conv"]["kernel"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fold_bn_matches_jax(name):
    jg, tg, jv = _both(name)
    jfg, jfv = jfold(jg, jv)
    tfg, tfv = fold_bn(tg, _port_vars(jv))
    assert _graph_key(tfg) == _graph_key(jfg)
    _assert_vars_equal(tfv, jfv)


@pytest.mark.parametrize("name", ["tiny-mid", "tiny-post-dilated",
                                  "tiny-pre-complex"])
def test_int8_deploy_graph_matches_jax(name):
    jg, tg, jv = _both(name)
    jfg, jfv = _post_ptq(*jfold(jg, jv))
    tfg, _ = fold_bn(tg, _port_vars(jv))
    tfv = _port_vars(jfv)
    jdg, jdv = jdeploy(jfg, jfv, pallas=True)
    tdg, tdv = to_int8_inference(tfg, tfv)
    assert _graph_key(tdg) == _graph_key(jdg)
    assert sum(1 for n in tdg.nodes if n.attrs.get("pallas")) == 6
    jdv = _np_vars(jdv)
    for node, entries in jdv["params"].items():
        for k, want in entries.items():
            np.testing.assert_array_equal(tdv["params"][node][k].numpy(), want,
                                          err_msg=f"{node}.{k}")
        if "kernel_int8" in entries and tdg.node(node).attrs.get("pallas"):
            assert torch.equal(tdv["params"][node]["kernel_packed"],
                               pack_weights(tdv["params"][node]["kernel_int8"]))
            assert tdv["params"][node]["kernel_packed"].dtype == torch.int8


def test_eligible_matches_jax():
    from efficientq_tpu.ptq.deploy import eligible as jeligible
    from efficientq_tpu.nnir import QCfg as JQ
    for q in [(True, 4, True, 4), (True, 256, False, -1), (True, 128, True, 128),
              (True, 4, True, 256), (False, 4, True, 4)]:
        assert eligible(nnir.QCfg(*q)) == jeligible(JQ(*q))
    assert not eligible(None)


def test_from_jax_variables_and_state_dict_round_trip():
    jg, tg, jv = _both("tiny-mid")
    tv = _port_vars(jv)
    _assert_vars_equal(tv, jv)
    sd_t = torch_io.to_torch_state_dict(tg, tv)
    sd_j = jtio.to_torch_state_dict(jg, jv)
    assert sorted(sd_t) == sorted(sd_j)
    for k in sd_j:
        np.testing.assert_array_equal(sd_t[k], sd_j[k], err_msg=k)
    back = torch_io.load_torch_state_dict(tg, nnir.init(tg, 1, device="cpu"),
                                          sd_j,
                                          strict=True)
    _assert_vars_equal(back, jv)


def test_int8_checkpoint_round_trip(tmp_path):
    """JAX to_torch_state_dict + pack_int_weight -> npz -> the port's
    load_int8_checkpoint gives the JAX loader's params."""
    jg, tg, jv = _both("tiny-mid")
    jfg, jfv = _post_ptq(*jfold(jg, jv))
    sd = jtio.to_torch_state_dict(jfg, jfv)
    sd["__qlvl_overrides__"] = {
        n.name: (n.attrs["qcfg"].qlvl_w, n.attrs["qcfg"].qlvl_act)
        for n in jfg.qconv_nodes()}
    for node in jfg.qconv_nodes():
        q = node.attrs["qcfg"]
        if q.q_weight:
            sd[f"{node.name}.weight"] = jpack(sd[f"{node.name}.weight"],
                                              sd[f"{node.name}.alpha_w"],
                                              q.qlvl_w)
    path = str(tmp_path / "state_in_int8_compress.npz")
    np.savez_compressed(path, state_dict=sd)
    jfg2, jfv2 = jfold(jg, jnnir.init(jg, jax.random.PRNGKey(5)))
    want = jtio.load_int8_checkpoint(jfg2, jfv2, path)
    tfg, tfv = fold_bn(tg, nnir.init(tg, 5, device="cpu"))
    got = torch_io.load_int8_checkpoint(tfg, tfv, path)
    for node, entries in _np_vars(want)["params"].items():
        for k, v in entries.items():
            if k in ("kernel", "bias", "alpha_w", "alpha_act"):
                np.testing.assert_array_equal(got["params"][node][k].numpy(),
                                              v, err_msg=f"{node}.{k}")
    assert torch_io.read_export_qlvl_overrides(path) == \
        jtio.read_export_qlvl_overrides(path)
    # a graph on another grid refuses the export
    bad = build_uresq(UResQConfig(**dict(TINY, qlvl_w=2, qlvl_act=2)))
    bfg, bfv = fold_bn(bad, nnir.init(bad, 0, device="cpu"))
    with pytest.raises(ValueError, match="qlvl_w"):
        torch_io.load_int8_checkpoint(bfg, bfv, path)


def _forward_pair(tg, tv, jg, jv, mode, shape=(2, 16, 16, 16, 2), seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    want = np.asarray(jnnir.apply(jg, jv, jnp.asarray(x), mode=mode,
                                  precision=jax.lax.Precision.HIGHEST))
    got = nnir.apply(tg, tv, torch.from_numpy(x), mode=mode).numpy()
    return got, want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fp_forward_matches_jax(name):
    jg, tg, jv = _both(name)
    got, want = _forward_pair(tg, _port_vars(jv),
                              jg, jv, "fp")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny-mid", "tiny-post-dilated"])
def test_quantized_forward_matches_jax(name):
    """The folded post-PTQ graph (fake-quant activations), and its int8
    deployment (port: fused graph with K1's plain version on the CPU; JAX:
    the unfused XLA int8 graph)."""
    jg, tg, jv = _both(name)
    jfg, jfv = _post_ptq(*jfold(jg, jv))
    tfg, _ = fold_bn(tg, _port_vars(jv))
    tfv = _port_vars(jfv)
    got, want = _forward_pair(tfg, tfv, jfg, jfv, "quantized")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jdg, jdv = jdeploy(jfg, jfv, pallas=False)
    tdg, tdv = to_int8_inference(tfg, tfv)
    got, want = _forward_pair(tdg, tdv, jdg, jdv, "quantized", seed=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_graph_module_holds_variables():
    jg, tg, jv = _both("tiny-mid")
    tv = _port_vars(jv)
    net = nnir.GraphModule(tg, tv, mode="fp")
    assert len(list(net.buffers())) == sum(
        len(e) for grp in tv.values() for e in grp.values())
    _assert_vars_equal(net.variables, jv)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 16, 16, 2)
                         .astype(np.float32))
    np.testing.assert_array_equal(net(x).numpy(),
                                  nnir.apply(tg, tv, x).numpy())
    assert net(x, heads=slice(-1, None)).shape[0] == 1
