"""The port's PTQ extensions against the JAX package, on the same NumPy
inputs, on the CPU: offset activation grids (``quant.fake_quant_act_k``,
``nnir``'s ``act_k`` in every quantized mode, ``ptq/deploy.py``'s baking,
``models/torch_io.py``, ``calibrate_layer(act_search=)``,
``run_ptq(act_offset=)``), block granularity, the tail and block-target
maps, ``run_ptq_mixed``, ``ptq/select.py``, ``ptq/tune.py`` and
``utils/toolchain.py``.  The fixtures are those of the JAX package's own
tests (tests/test_act_offset.py, test_block_ptq.py, test_mixed_ptq.py,
test_tail_alpha.py, test_tune.py); weights travel by
``torch_io.from_jax_variables``.

Tolerances, each stated beside its check:

- ``fake_quant_act_k`` and the int8 ``act_k`` codes: bit-equal, every k
  and grid, with k as a static int and as a calibrated int32 tensor;
- nnir forwards with ``act_k``: within 1e-5 (PyTorch's and XLA's float32
  conv sums run in other orders);
- the block-target and tail maps: equal, on both presets at full width;
- whole calibrations (ADMM is chaotic at rounding level, ROADMAP queue 3):
  tests/test_torch_port_ptq.py's levels for ``run_ptq``, weight codes
  equal on >= 0.99 and layer losses within rtol 1e-2; the lift sets of
  ``run_ptq_mixed`` equal when both packages get the same ranking;
- ``sweep_tail_alpha`` at one deterministic scorer: the same kept factor,
  alphas bit-equal;
- ``tune_activation_range`` (Adam in both, rounded in other orders) over 5
  iterations: loss history within rtol 1e-4 (measured: 2.5e-7 over the
  first four, 6.9e-5 at the fifth), alphas within rtol 5e-4 (measured
  1.4e-4 at most): the straight-through gradients of two float32
  forwards differ where an activation code flips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu import quant as jquant
from efficientq_tpu.models import UResQConfig as JCfg
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.models import preset_config as jpreset
from efficientq_tpu.models import torch_io as jtorch_io
from efficientq_tpu.ptq import PTQHyperParams as JHP
from efficientq_tpu.ptq import admm as jadmm
from efficientq_tpu.ptq import engine as jengine
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq import run_ptq as jrun_ptq
from efficientq_tpu.ptq import run_ptq_mixed as jrun_ptq_mixed
from efficientq_tpu.ptq.deploy import to_int8_inference as jto_int8
from efficientq_tpu.ptq.select import select_calibration as jselect
from efficientq_tpu.ptq.tune import sweep_tail_alpha as jsweep
from efficientq_tpu.ptq.tune import tune_activation_range as jtune
from efficientq_tpu_torch import nnir, quant
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.models import preset_config
from efficientq_tpu_torch.ptq import (PTQHyperParams, admm, engine, fold_bn,
                                      run_ptq, run_ptq_mixed,
                                      to_int8_inference)
from efficientq_tpu_torch.ptq.select import select_calibration
from efficientq_tpu_torch.ptq.tune import (sweep_tail_alpha,
                                           tune_activation_range)
from efficientq_tpu_torch.utils.toolchain import toolchain_fingerprint

HI = jax.lax.Precision.HIGHEST


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_vars(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _port_vars(jv):
    return torch_io.from_jax_variables(_np_vars(jv), device="cpu")


def _codes(kernel, alpha, qlvl):
    """Integer weight codes 0..qlvl-1 of a kernel on the alpha grid."""
    return np.round((np.asarray(kernel, np.float64) / np.asarray(
        alpha, np.float64) + 1.0) * (qlvl - 1) / 2)


def _tiny(num_mod=2, num_classes=3, ds="simple", stride=(2, 2, 2),
          blk_type="mid", bn_seed=None):
    """The tiny quantized UResQ of the JAX package's PTQ tests, in both
    packages, the same weights; with ``bn_seed`` its BN state randomised
    as tests/test_ptq_e2e.py draws it."""
    kw = dict(num_mod=num_mod, num_classes=num_classes,
              depth_config=[1, 1, 1], width_config=[4, 8, 4],
              dilation_config=[1, 1, 1], init_stride=stride, drop_rate=0.0,
              blk_type=blk_type, ds=ds, quantize=True, qlvl_w=4, qlvl_act=4,
              q_first=(256, -1), q_last=(256, -1))
    if ds is not None:
        kw["ds_depth_limit"] = 3
    jg = jbuild(JCfg(**kw))
    jv = jnnir.init(jg, jax.random.PRNGKey(0))
    if bn_seed is not None:
        rng = np.random.RandomState(bn_seed)
        for s in jv["state"].values():
            s["mean"] = jnp.asarray(rng.randn(*s["mean"].shape)
                                    .astype(np.float32) * 0.1)
            s["var"] = jnp.asarray((np.abs(rng.randn(*s["var"].shape)) * 0.2
                                    + 0.9).astype(np.float32))
    return jg, jv, build_uresq(UResQConfig(**kw)), _port_vars(jv)


def _codes_agree(tg, tv, jv, min_share=0.99):
    """Weight codes of every weight-quantized conv equal on >= min_share
    (tests/test_torch_port_ptq.py's level for run_ptq); returns the
    share."""
    same = total = 0
    for node in tg.qconv_nodes():
        q = node.attrs["qcfg"]
        if not q.q_weight:
            continue
        tp, jp = tv["params"][node.name], jv["params"][node.name]
        ct = _codes(tp["kernel"].numpy(), float(tp["alpha_w"]), q.qlvl_w)
        cj = _codes(jp["kernel"], float(jp["alpha_w"]), q.qlvl_w)
        same += int((ct == cj).sum())
        total += ct.size
    assert same / total >= min_share, same / total
    return same / total


def _losses_agree(trep, jrep, rtol=1e-2):
    assert [n for n, _ in trep.layer_losses] == \
        [n for n, _ in jrep.layer_losses]
    for (name, lt), (_, lj) in zip(trep.layer_losses, jrep.layer_losses):
        assert np.isfinite(lt), name
        np.testing.assert_allclose(lt, lj, rtol=rtol, err_msg=name)


# --- quant.fake_quant_act_k and the signed int8 codes ------------------------

@pytest.mark.parametrize("levels", [4, 16])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["static", "tensor"])
def test_fake_quant_act_k_matches_jax(kind, k, levels):
    """Bit-equal to JAX for k as a static int (a deployed node's attribute)
    and as an int32 tensor (a calibrated parameter); at k = 0 also equal to
    fake_quant_act."""
    rng = np.random.RandomState(10 * k + levels)
    x = (rng.randn(4, 5, 6, 7) * 0.6).astype(np.float32)
    x[0, 0, 0, :3] = [0.0, -0.0, 1e-8]
    alpha = np.float32(0.73)
    jk = k if kind == "static" else jnp.int32(k)
    tk = k if kind == "static" else torch.tensor(k, dtype=torch.int32)
    want = np.asarray(jquant.fake_quant_act_k(jnp.asarray(x),
                                              jnp.asarray(alpha), levels, jk))
    got = quant.fake_quant_act_k(_t(x), _t(alpha), levels, tk).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if k == 0:
        np.testing.assert_array_equal(
            got, quant.fake_quant_act(_t(x), _t(alpha), levels).numpy())


@pytest.mark.parametrize("levels", [4, 16])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_act_codes_k_match_jax(k, levels):
    """The signed codes of an ``act_k`` int8 conv, clip(round(x/a (n-1)),
    -k, n-1-k), as JAX's nnir computes them: bit-equal, and on the offset
    grid's levels."""
    rng = np.random.RandomState(k + levels)
    x = (rng.randn(3, 6, 6, 6, 5) * 0.8).astype(np.float32)
    alpha = np.float32(0.91)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / alpha
                                         * (levels - 1)),
                               -k, levels - 1 - k).astype(jnp.int8))
    got = quant.act_codes(_t(x), _t(alpha), levels, k).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == -k and got.max() == levels - 1 - k
    fq = quant.fake_quant_act_k(_t(x), _t(alpha), levels, k).numpy()
    np.testing.assert_allclose(got * alpha / (levels - 1), fq, rtol=0,
                               atol=1e-6)


# --- nnir with act_k, deployment, the exports --------------------------------

@pytest.fixture(scope="module")
def act_k_net():
    """The tiny net with calibrated-looking offset grids on three convs
    (k = 1, 2, 3 as int32 parameters) and the rest unsigned, both
    packages."""
    jg, jv, tg, _ = _tiny(num_mod=1, num_classes=2, ds=None)
    jfg, jfv = jfold(jg, jv)
    params = jfv["params"]
    names = [n.name for n in jfg.qconv_nodes() if n.attrs["qcfg"].q_act
             and n.attrs["qcfg"].q_weight]
    chosen = {names[1]: 1, names[len(names) // 2]: 2, names[-2]: 3}
    rng = np.random.RandomState(5)
    for node in jfg.qconv_nodes():
        q = node.attrs["qcfg"]
        p = params[node.name]
        if q.q_weight:
            a = jnp.float32(np.abs(np.asarray(p["kernel"])).max() * 0.7)
            p["kernel"] = jquant.fake_quant_weight(p["kernel"], a, q.qlvl_w)
            p["alpha_w"] = a
        if q.q_act:
            p["alpha_act"] = jnp.float32(0.5 + rng.rand())
        if node.name in chosen:
            p["act_k"] = jnp.int32(chosen[node.name])
    tfg, _ = fold_bn(tg, nnir.init(tg, 0, device="cpu"))
    x = rng.randn(1, 16, 16, 16, 1).astype(np.float32)
    return dict(jg=jfg, jv=jfv, tg=tfg, tv=_port_vars(jfv), x=x,
                chosen=chosen)


@pytest.mark.parametrize("mode", ["fq", "quantized", "int8"])
def test_nnir_act_k_matches_jax(act_k_net, mode):
    """The forward with offset grids in fq and quantized modes (act_k read
    from the parameters) and in the int8 deployment (act_k baked as a
    static attribute, signed codes): within 1e-5 of JAX's."""
    n = act_k_net
    jg, jv, tg, tv = n["jg"], n["jv"], n["tg"], n["tv"]
    run = "quantized" if mode == "int8" else mode
    if mode == "int8":
        jg, jv = jto_int8(jg, jv, pallas=False)
        tg, tv = to_int8_inference(tg, tv)
        baked = {m.name: m.attrs.get("act_k", 0) for m in tg.nodes}
        assert {k: v for k, v in baked.items() if v} == n["chosen"]
        assert baked == {m.name: m.attrs.get("act_k", 0) for m in jg.nodes}
        for name in n["chosen"]:
            node = tg.node(name)
            assert node.attrs.get("int8") and not node.attrs.get("pallas")
            assert not node.attrs.get("input_quantized")
    want = np.asarray(jnnir.apply(jg, jv, jnp.asarray(n["x"]), mode=run,
                                  precision=HI))
    got = nnir.apply(tg, tv, _t(n["x"]), mode=run).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_act_k_deployment_equals_quantized_forward(act_k_net):
    """The int8 deployment of a net with offset grids computes the port's
    own quantized forward (the JAX test's level, 2e-4)."""
    n = act_k_net
    ref = nnir.apply(n["tg"], n["tv"], _t(n["x"]), mode="quantized")
    ig, iv = to_int8_inference(n["tg"], n["tv"])
    out = nnir.apply(ig, iv, _t(n["x"]), mode="quantized")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_act_k_export_round_trips_both_ways(act_k_net):
    """``<conv>.act_k`` travels through each package's export into the
    other's loader: the same keys and int32 values, and the same forward."""
    n = act_k_net
    sd_t = torch_io.to_torch_state_dict(n["tg"], n["tv"])
    sd_j = jtorch_io.to_torch_state_dict(n["jg"], n["jv"])
    assert set(sd_t) == set(sd_j)
    keys = sorted(k for k in sd_t if k.endswith(".act_k"))
    assert [k.rsplit(".", 1)[0] for k in keys] == sorted(n["chosen"])
    for k in keys:
        assert sd_t[k].dtype == np.int32 and sd_t[k] == sd_j[k]
    x = _t(n["x"])
    want = nnir.apply(n["tg"], n["tv"], x, mode="quantized").numpy()
    # JAX's export into the port
    tv2 = torch_io.load_torch_state_dict(
        n["tg"], fold_bn(n["tg"], nnir.init(n["tg"], 1, device="cpu"))[1],
        sd_j)
    for name, k in n["chosen"].items():
        assert tv2["params"][name]["act_k"].dtype == torch.int32
        assert int(tv2["params"][name]["act_k"]) == k
    np.testing.assert_allclose(
        nnir.apply(n["tg"], tv2, x, mode="quantized").numpy(), want,
        rtol=1e-5, atol=1e-5)
    # the port's export into JAX
    jv2 = jtorch_io.load_torch_state_dict(
        n["jg"], jfold(n["jg"], jnnir.init(n["jg"],
                                           jax.random.PRNGKey(1)))[1], sd_t)
    np.testing.assert_allclose(
        np.asarray(jnnir.apply(n["jg"], jv2, jnp.asarray(n["x"]),
                               mode="quantized", precision=HI)), want,
        rtol=1e-5, atol=1e-5)


# --- calibrate_layer(act_search=) --------------------------------------------

@pytest.mark.parametrize("signed", [True, False])
def test_calibrate_layer_act_search_matches_jax(signed):
    """The test_act_offset.py case: signed data picks an offset grid,
    post-relu data the unsigned one.  The same act_k as JAX (or, where
    JAX's float32 error sum misranks a near-tie, the float64 oracle's
    pick), alpha_act within rtol 1e-5, the fake-quantized input on the
    chosen grid."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 6, 6, 6, 4).astype(np.float32)
    if not signed:
        x = np.abs(x)
    k = (rng.randn(3, 3, 3, 4, 5) * 0.1).astype(np.float32)
    y = rng.randn(1, 6, 6, 6, 5).astype(np.float32)
    kw = dict(ksize=(3, 3, 3), stride=(1, 1, 1), padding=(1, 1, 1),
              dilation=(1, 1, 1), qlvl_w=4, has_bias=False, qlvl_act=4,
              act_search=3)
    j = jadmm.calibrate_layer(jnp.asarray(x), jnp.asarray(y), jnp.asarray(k),
                              None, None, hp=JHP(admm_iter=5), **kw)
    t = admm.calibrate_layer(_t(x), _t(y), _t(k), None, None,
                             hp=PTQHyperParams(admm_iter=5), **kw)
    assert t["act_k"].dtype == torch.int32
    # the float64 oracle of the search
    errs = []
    for kk in range(4):
        lo = -kk / 3.0
        a, b = quant.project_by_iter_np(x, 4, lo, lo + 1.0)
        errs.append(float(((x.astype(np.float64) - a * b) ** 2).sum()))
    oracle = int(np.argmin(errs))
    assert int(t["act_k"]) == oracle
    assert (int(t["act_k"]) > 0) == signed
    if int(j["act_k"]) != oracle:  # a float32 near-tie, queue 3's pattern
        gap = abs(errs[int(j["act_k"])] - errs[oracle])
        assert gap <= 1e-5 * errs[oracle], (errs, int(j["act_k"]))
    else:
        np.testing.assert_allclose(float(t["alpha_act"]),
                                   float(j["alpha_act"]), rtol=1e-5)
    xq = quant.fake_quant_act_k(_t(x), t["alpha_act"], 4, t["act_k"])
    grid = (np.arange(4) - int(t["act_k"])) / 3 * float(t["alpha_act"])
    assert np.abs(xq.numpy().ravel()[:, None] - grid).min(1).max() < 1e-5
    ak0 = admm.calibrate_layer(_t(x), _t(y), _t(k), None, None,
                               hp=PTQHyperParams(admm_iter=5),
                               **dict(kw, act_search=0))["act_k"]
    assert int(ak0) == 0


# --- graph maps --------------------------------------------------------------

@pytest.mark.parametrize("task", ["brats", "lits"])
def test_block_targets_and_tail_match_jax(task):
    """block_calibration_targets and tail_sensitive_convs: equal maps on
    the preset at full width, folded (the graphs run_ptq calibrates) and
    not; 'post' blocks have none."""
    for blk in ("mid", "post"):
        jcfg = jpreset(task, quantize=True, blk_type=blk)
        tcfg = preset_config(task, quantize=True, blk_type=blk)
        jg, tg = jbuild(jcfg), build_uresq(tcfg)
        # fold_bn rewrites the node list only; zero-size variables suffice
        jfg = jfold(jg, jax.tree_util.tree_map(
            jnp.asarray, _np_vars(jnnir.init(jg, jax.random.PRNGKey(0)))))[0]
        tfg = fold_bn(tg, nnir.init(tg, 0, device="cpu"))[0]
        for a, b in ((tg, jg), (tfg, jfg)):
            assert engine.block_calibration_targets(a) == \
                jengine.block_calibration_targets(b)
            assert engine.tail_sensitive_convs(a) == \
                jengine.tail_sensitive_convs(b)
            assert engine.tail_sensitive_convs(a, k=4) == \
                jengine.tail_sensitive_convs(b, k=4)
        targets = engine.block_calibration_targets(tfg)
        assert bool(targets) == (blk == "mid")
        assert len(engine.tail_sensitive_convs(tfg)) == 2


# --- run_ptq: block granularity, offset grids --------------------------------

@pytest.mark.parametrize("block_target", ["quantized", "fp"])
def test_run_ptq_block_matches_jax(block_target):
    """granularity='block' on the e2e fixture: the same layer names, losses
    within rtol 1e-2 and codes equal on >= 0.99 (test_torch_port_ptq.py's
    levels), the
    quantized forward equal to the sweep's output; an exit conv differs
    from the layer-wise calibration's ('quantized') or from the
    'quantized' target's ('fp')."""
    jg, jv, tg, tv = _tiny(bn_seed=0)
    x = np.random.RandomState(7).randn(1, 16, 16, 16, 2).astype(np.float32)
    kw = dict(task="lits", init_stride=(2, 2, 2), granularity="block",
              block_target=block_target)
    jfg, jqv, jrep = jrun_ptq(jg, jv, jnp.asarray(x), hp=JHP(admm_iter=40),
                              **kw)
    tfg, tqv, trep = run_ptq(tg, tv, x, hp=PTQHyperParams(admm_iter=40),
                             device="cpu", **kw)
    _losses_agree(trep, jrep)
    _codes_agree(tfg, tqv, _np_vars(jqv))
    out = nnir.apply(tfg, tqv, _t(x), mode="quantized")
    np.testing.assert_allclose(out.numpy(), trep.output_q.numpy(),
                               atol=1e-3, rtol=1e-3)
    # against the layer-wise calibration, or for 'fp' (whose target
    # add_fp - residual_fp is the layer-wise one up to rounding) against
    # the 'quantized' block target, as JAX's test_block_target_fp_variant
    other = dict(task="lits", init_stride=(2, 2, 2))
    if block_target == "fp":
        other["granularity"] = "block"
    _, oqv, _ = run_ptq(tg, tv, x, hp=PTQHyperParams(admm_iter=40),
                        device="cpu", **other)
    exits = engine.block_calibration_targets(tfg)
    assert exits and any(
        not torch.equal(tqv["params"][n]["kernel"], oqv["params"][n]["kernel"])
        for n in exits)
    with pytest.raises(ValueError):
        run_ptq(tg, tv, x, device="cpu", **dict(kw, block_target="nope"))


def test_run_ptq_act_offset_matches_jax():
    """act_offset=3 on the tail convs (the test_act_offset.py case): act_k
    on exactly the tail convs, the same k as JAX's, losses and codes at PR
    9's levels; the int8 deployment equal to the quantized forward."""
    jg, jv, tg, tv = _tiny(num_mod=1, num_classes=2, ds=None, bn_seed=2)
    x = np.random.RandomState(2).randn(1, 16, 16, 16, 1).astype(np.float32)
    tail = set(engine.tail_sensitive_convs(tg))
    assert tail == set(jengine.tail_sensitive_convs(jg))
    kw = dict(task="lits", init_stride=(2, 2, 2), act_offset=3,
              act_offset_convs=tail)
    jfg, jqv, jrep = jrun_ptq(jg, jv, jnp.asarray(x), hp=JHP(admm_iter=20),
                              **kw)
    tfg, tqv, trep = run_ptq(tg, tv, x, hp=PTQHyperParams(admm_iter=20),
                             device="cpu", **kw)
    jqv = _np_vars(jqv)
    for node in tfg.qconv_nodes():
        has = "act_k" in tqv["params"][node.name]
        assert has == (node.name in tail) == \
            ("act_k" in jqv["params"][node.name]), node.name
        if has:
            assert int(tqv["params"][node.name]["act_k"]) == \
                int(jqv["params"][node.name]["act_k"]), node.name
    _losses_agree(trep, jrep)
    _codes_agree(tfg, tqv, jqv)
    ref = nnir.apply(tfg, tqv, _t(x), mode="quantized")
    ig, iv = to_int8_inference(tfg, tqv)
    np.testing.assert_allclose(nnir.apply(ig, iv, _t(x),
                                          mode="quantized").numpy(),
                               ref.numpy(), atol=2e-4, rtol=2e-4)


# --- run_ptq_mixed -----------------------------------------------------------

@pytest.fixture(scope="module")
def mixed_case():
    jg, jv, tg, tv = _tiny()
    x = np.random.RandomState(7).randn(1, 16, 16, 16, 2).astype(np.float32)
    kw = dict(task="lits", init_stride=(2, 2, 2))
    _, _, jrep1 = jrun_ptq(jg, jv, jnp.asarray(x), hp=JHP(admm_iter=10), **kw)
    _, _, trep1 = run_ptq(tg, tv, x, hp=PTQHyperParams(admm_iter=10),
                          device="cpu", **kw)
    return dict(jg=jg, jv=jv, tg=tg, tv=tv, x=x, kw=kw,
                jranking=jrep1.layer_rel_losses,
                tranking=trep1.layer_rel_losses)


@pytest.mark.parametrize("mixed_tail", [True, False])
def test_run_ptq_mixed_matches_jax(mixed_case, mixed_tail):
    """The same lift set and overrides as JAX's at the same ranking; the
    port's own ranking within rtol 1e-2 of JAX's and lifting the same set;
    the lifted layers on the 16-level grid; losses and codes at
    test_torch_port_ptq.py's levels."""
    c = mixed_case
    for (n1, r1), (n2, r2) in zip(c["tranking"], c["jranking"]):
        assert n1 == n2
        np.testing.assert_allclose(r1, r2, rtol=1e-2, err_msg=n1)
    kw = dict(c["kw"], mixed_frac=0.34, mixed_qlvl=16, mixed_tail=mixed_tail)
    jfg, jqv, jrep = jrun_ptq_mixed(c["jg"], c["jv"], jnp.asarray(c["x"]),
                                    hp=JHP(admm_iter=10),
                                    ranking=c["jranking"], **kw)
    tfg, tqv, trep = run_ptq_mixed(c["tg"], c["tv"], c["x"],
                                   hp=PTQHyperParams(admm_iter=10),
                                   ranking=c["jranking"], device="cpu", **kw)
    assert trep.mixed_upgraded == jrep.mixed_upgraded
    n_q = len(c["jranking"])
    assert len(trep.mixed_upgraded) == (max(round(0.34 * n_q), 2)
                                        if mixed_tail else round(0.34 * n_q))
    tail = engine.tail_sensitive_convs(c["tg"])
    assert (set(tail) <= set(trep.mixed_upgraded)) == mixed_tail or \
        not mixed_tail
    for node in tfg.qconv_nodes():
        q, qj = node.attrs["qcfg"], jfg.node(node.name).attrs["qcfg"]
        assert (q.qlvl_w, q.qlvl_act) == (qj.qlvl_w, qj.qlvl_act)
        if node.name in trep.mixed_upgraded:
            assert q.qlvl_w >= 16 and q.qlvl_act >= 16
    _losses_agree(trep, jrep)
    _codes_agree(tfg, tqv, _np_vars(jqv))
    own = run_ptq_mixed(c["tg"], c["tv"], c["x"],
                        hp=PTQHyperParams(admm_iter=2),
                        ranking=c["tranking"], device="cpu", **kw)[2]
    assert own.mixed_upgraded == jrep.mixed_upgraded


def test_mixed_deploys_bit_exact_int8(mixed_case):
    """JAX's test_mixed_deploys_bit_exact_int8 on the port: the int8
    deployment of the mixed net (4- and 16-level K1 convs, 256-level
    float ones) computes its quantized forward."""
    c = mixed_case
    mg, mv, _ = run_ptq_mixed(c["tg"], c["tv"], c["x"],
                              hp=PTQHyperParams(admm_iter=10), device="cpu",
                              mixed_frac=0.34, mixed_qlvl=16, **c["kw"])
    ref = nnir.apply(mg, mv, _t(c["x"]), mode="quantized")
    ig, iv = to_int8_inference(mg, mv)
    lifted = [n for n in ig.nodes if n.attrs.get("pallas")
              and n.attrs["qcfg"].qlvl_act == 16]
    assert lifted
    out = nnir.apply(ig, iv, _t(c["x"]), mode="quantized")
    scale = float(torch.std(ref))
    np.testing.assert_allclose(out.numpy(), ref.numpy(),
                               atol=2e-3 * scale + 1e-4, rtol=1e-3)


# --- select_calibration ------------------------------------------------------

def test_select_calibration_matches_jax():
    """Three candidate volumes (full-rank 32^3 crops of the CLI fixture's
    kind): the same picked index as JAX, every score within 2e-2 of
    JAX's (dice of two calibrations that agree on >= 0.99 of codes)."""
    jg, jv, tg, tv = _tiny(num_mod=1, num_classes=2, ds=None, bn_seed=4,
                           stride=(2, 2, 1))
    rng = np.random.RandomState(4)
    imgs, labels = [], []
    for i in range(3):
        img = (rng.randn(1, 1, 32, 32, 32) * (0.5 + i)).astype(np.float32)
        imgs.append(img)
        labels.append((img[:, 0] > 0.3 * (i + 1)).astype(np.int64))
    kw = dict(num_mo=1, n_class=2, patch_size=(16, 16, 16),
              overlap=(8, 8, 8), task="lits", init_stride=(2, 2, 1))
    _, _, _, jsel = jselect(jg, jv, imgs, labels, hp=JHP(admm_iter=10), **kw)
    _, tqv, trep, tsel = select_calibration(
        tg, tv, imgs, labels, hp=PTQHyperParams(admm_iter=10), device="cpu",
        **kw)
    assert tsel["picked"] == jsel["picked"]
    np.testing.assert_allclose(tsel["scores"], jsel["scores"], atol=2e-2)
    assert len(tsel["seconds"]["candidates"]) == 3
    with pytest.raises(ValueError):
        select_calibration(tg, tv, imgs[:1], labels[:1], device="cpu", **kw)


# --- tune.py -----------------------------------------------------------------

@pytest.fixture(scope="module")
def tuned_net():
    """test_tail_alpha.py's and test_tune.py's net: folded, weights
    projected at max|w|, alpha_act set; both packages."""
    jg, jv, tg, _ = _tiny(num_mod=1, num_classes=2, ds=None)
    jfg, jfv = jfold(jg, jv)
    for node in jfg.qconv_nodes():
        q = node.attrs["qcfg"]
        p = jfv["params"][node.name]
        if q.q_weight:
            a = jnp.maximum(jnp.max(jnp.abs(p["kernel"])), 1e-8)
            p["kernel"] = jquant.fake_quant_weight(p["kernel"], a, q.qlvl_w)
            p["alpha_w"] = a
        if q.q_act:
            p["alpha_act"] = jnp.float32(5.0)
    tfg = fold_bn(tg, nnir.init(tg, 0, device="cpu"))[0]
    return jfg, jfv, tfg, _port_vars(jfv)


def test_sweep_tail_alpha_matches_jax(tuned_net):
    """One deterministic scorer (peaked at x1.7): the same kept factor and
    scores, the tail alphas bit-equal, the others untouched; a scorer that
    prefers x1.0 returns the variables as they came."""
    jfg, jfv, tfg, tfv = tuned_net
    tail = engine.tail_sensitive_convs(tfg)
    assert tail == jengine.tail_sensitive_convs(jfg)

    def score(v):
        f = float(np.asarray(v["params"][tail[0]]["alpha_act"])) / 5.0
        return -abs(f - 1.7)

    jv2, jinfo = jsweep(jfg, jfv, score)
    tv2, tinfo = sweep_tail_alpha(tfg, tfv, score)
    assert tinfo["best_factor"] == jinfo["best_factor"] == 1.7
    assert tinfo["scores"] == jinfo["scores"]
    assert tinfo["convs"] == jinfo["convs"] == tail
    for node in tfg.qconv_nodes():
        if "alpha_act" not in tfv["params"][node.name]:
            continue
        got = tv2["params"][node.name]["alpha_act"].numpy()
        want = np.asarray(jv2["params"][node.name]["alpha_act"])
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        if node.name not in tail:
            assert tv2["params"][node.name]["alpha_act"] is \
                tfv["params"][node.name]["alpha_act"]
    v3, info3 = sweep_tail_alpha(tfg, tfv, lambda v: -float(
        v["params"][tail[0]]["alpha_act"]))
    assert info3["best_factor"] == 1.0 and v3 is tfv


def test_tune_activation_range_matches_jax(tuned_net):
    """Five Adam iterations at lr 5e-2 from alpha_act = 5 on |x|: the loss
    history within rtol 1e-4 and every alpha within rtol 5e-4 of optax's
    (the module docstring's measurements); with a scorer,
    the same scored iterations and the iteration-0 alphas kept when the
    score only falls."""
    jfg, jfv, tfg, tfv = tuned_net
    x = np.abs(np.random.RandomState(0).randn(1, 8, 8, 8, 1)) \
        .astype(np.float32)
    out_fp = np.array(jnnir.apply(jfg, jfv, jnp.asarray(x), mode="fp",
                                  precision=HI))
    jt, jl, jinfo = jtune(jfg, jfv, jnp.asarray(x), jnp.asarray(out_fp),
                          max_iter=5, lr=5e-2)
    tt, tl, tinfo = tune_activation_range(tfg, tfv, x, out_fp, max_iter=5,
                                          lr=5e-2)
    assert jinfo == tinfo == {}
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    moved = 0
    for node in tfg.qconv_nodes():
        if node.attrs["qcfg"].q_act:
            got = tt["params"][node.name]["alpha_act"]
            assert not got.requires_grad
            np.testing.assert_allclose(
                float(got), float(jt["params"][node.name]["alpha_act"]),
                rtol=5e-4, err_msg=node.name)
            moved += abs(float(got) - 5.0) > 1e-3
    assert moved
    calls = []

    def hostile(v):
        calls.append(1)
        return float(-len(calls))

    t0, _, info0 = tune_activation_range(tfg, tfv, x, out_fp,
                                         max_iter=5, lr=5e-2,
                                         score_fn=hostile, score_every=2)
    assert info0["best_iter"] == 0
    assert [it for it, _ in info0["scores"]] == [0, 2, 4, 5]
    for node in tfg.qconv_nodes():
        if node.attrs["qcfg"].q_act:
            assert float(t0["params"][node.name]["alpha_act"]) == 5.0


def test_toolchain_fingerprint_keys():
    fp = toolchain_fingerprint()
    assert set(fp) == {"torch", "cuda_runtime", "nvcc", "driver", "device",
                       "python"}
    assert fp["torch"] == torch.__version__
    assert all(isinstance(v, str) and v for v in fp.values())
