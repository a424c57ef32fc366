"""The serving extras of the port against the JAX package, on the CPU:
full-depth column serving (``eval/sliding.py::column_grid_plan`` and
``serve_grid="column"``), the serving checks of ``eval/validate.py``, the
patch-batch autotuner (``eval/autotune.py``) and the bookkeeping of the
captured forward (``eval/sliding.py::CapturedForward``; its CUDA graphs
themselves run on the card only, tests/test_torch_port_cuda.py).

Tolerances: the column plan, the JAX package's two column properties
(column == the D-padded sliding window; column == patch grid when the
depth fits) and the autotuner's rule are exact.  The column inferencer on
the tiny int8 net against JAX's jitted one: tests/test_torch_port_serving.py's
level, hard predictions on >= 99.99 % of voxel-classes and exactly wherever
the overlap-summed logit is farther than 1e-4 from the boundary (JAX's
interpret-mode kernel fuses the scale into an FMA, one ulp apart); the
logits within 1e-4 (absolute) on >= 99.9 % of voxel-classes.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu.eval import autotune as jautotune
from efficientq_tpu.eval import sliding as jsliding
from efficientq_tpu.eval import validate as jvalidate
from efficientq_tpu.models import UResQConfig as JCfg
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq.deploy import to_int8_inference as jdeploy
from efficientq_tpu.quant import fake_quant_weight as jfqw
from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.eval import autotune, sliding, validate
from efficientq_tpu_torch.kernels.qmatmul import to_pallas_inference
from efficientq_tpu_torch.models import (UResQConfig, build_uresq,
                                         min_input_divisor, torch_io)
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference

CFG = dict(num_mod=4, num_classes=3, depth_config=[1, 1, 1],
           width_config=[4, 8, 4], dilation_config=[1, 1, 1],
           init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid", ds="simple",
           ds_depth_limit=3, fuse_bn=True, quantize=True, qlvl_w=4,
           qlvl_act=4, q_first=(256, -1), q_last=(256, -1))
PATCH, OVERLAP = (16, 16, 16), (4, 4, 4)
DIV = min_input_divisor(UResQConfig(**CFG))[0]


@pytest.fixture(scope="module")
def deployed():
    """JAX and port int8 deployments of the same post-PTQ tiny net."""
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
            p["alpha_act"] = jnp.float32(0.8)
    jdg, jdv = jdeploy(jfg, jfv, pallas=True)
    tg = build_uresq(UResQConfig(**CFG))
    tfg, _ = fold_bn(tg, nnir.init(tg, 0, device="cpu"))
    tdg, tdv = to_int8_inference(
        tfg, torch_io.from_jax_variables(
            jax.tree_util.tree_map(np.asarray, jfv), device="cpu"))
    return (jdg, jdv), (tdg, tdv)


def _vol(seed, shape):
    return np.random.RandomState(seed).rand(1, *shape, 4).astype(np.float32)


@pytest.mark.parametrize("vol,patch,overlap,div", [
    ((155, 240, 240), 128, 16, 16), ((20, 24, 24), 16, 4, 8),
    ((32, 32, 32), 16, 8, 16), ((33, 17, 40), (16, 8, 24), (2, 0, 5), 4),
    ((7, 30, 30), (8, 16, 16), (0, 4, 4), 1)])
def test_column_grid_plan_matches_jax(vol, patch, overlap, div):
    got = sliding.column_grid_plan(vol, patch, overlap, div)
    assert got == jsliding.column_grid_plan(vol, patch, overlap, div)
    assert got[0] % div == 0 and got[0] >= vol[0] and got[2][0] == 0


def test_column_plan_flagship_has_four_columns():
    pd, patch, ov = sliding.column_grid_plan((155, 240, 240), 128, 16, 16)
    assert (pd, patch, ov) == (160, (160, 128, 128), (0, 16, 16))
    assert len(sliding.patch_grid((160, 240, 240), patch, ov)) == 4


@pytest.mark.parametrize("depth", [20, 16, 9])
def test_column_inferencer_matches_jax(deployed, depth):
    (jdg, jdv), (tdg, tdv) = deployed
    vol = _vol(depth, (depth, 24, 24))
    for hard in (False, True):
        kw = dict(patch_batch=4, mode="quantized", heads=slice(-1, None),
                  hard_pred=hard, multilabel=True, serve_grid="column",
                  stride_div=DIV)
        want = np.asarray(jsliding.make_jitted_volume_inferencer(jdg, **kw)(
            jdv, jnp.asarray(vol), PATCH, OVERLAP))
        got = sliding.make_volume_inferencer(tdg, **kw)(
            tdv, torch.from_numpy(vol), PATCH, OVERLAP).numpy()
        assert got.shape == want.shape == (1, 1, depth, 24, 24, 3)
        if hard:
            assert got.dtype == np.uint8
            assert np.mean(got == want) >= 0.9999
            np.testing.assert_array_equal(got[np.abs(sums) > 1e-4],
                                          want[np.abs(sums) > 1e-4])
        else:
            sums = got  # the decision variable, up to the visit count
            assert np.mean(np.abs(got - want) <= 1e-4) >= 0.999


def test_column_is_the_padded_sliding_window(deployed):
    """The JAX property (tests/test_column_serving.py): column serving is
    the sliding window over the D-padded volume, cropped, exactly."""
    _, (tdg, tdv) = deployed
    vol = torch.from_numpy(_vol(1, (18, 24, 24)))
    got = sliding.make_volume_inferencer(
        tdg, patch_batch=4, mode="quantized", serve_grid="column",
        stride_div=DIV)(tdv, vol, PATCH, OVERLAP)
    pd, patch, ov = sliding.column_grid_plan((18, 24, 24), PATCH, OVERLAP,
                                             DIV)
    vp = torch.nn.functional.pad(vol, (0, 0, 0, 0, 0, 0, 0, pd - 18))
    with torch.inference_mode():
        want = sliding.sliding_window_inference(
            lambda xb: nnir.apply(tdg, tdv, xb, mode="quantized"), vp, patch,
            ov, 4)
    np.testing.assert_array_equal(got.numpy(), want[:, :, :18].numpy())


def test_column_equals_patch_when_depth_fits(deployed):
    _, (tdg, tdv) = deployed
    vol = torch.from_numpy(_vol(2, (16, 24, 24)))
    kw = dict(patch_batch=4, mode="quantized", hard_pred=True,
              multilabel=True)
    got = sliding.make_volume_inferencer(tdg, serve_grid="column",
                                         stride_div=DIV, **kw)(
        tdv, vol, PATCH, OVERLAP)
    want = sliding.make_volume_inferencer(tdg, **kw)(tdv, vol, PATCH,
                                                     OVERLAP)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("kw,match", [
    (dict(serve_grid="column"), "stride_div"),
    (dict(serve_grid="volume"), "serve_grid")])
def test_inferencer_grid_errors_match_jax(deployed, capture, kw, match):
    (jdg, _), (tdg, _) = deployed
    with pytest.raises(ValueError, match=match) as ours:
        sliding.make_volume_inferencer(tdg, capture=capture, **kw)
    with pytest.raises(ValueError) as theirs:
        jsliding.make_jitted_volume_inferencer(jdg, **kw)
    assert str(ours.value) == str(theirs.value)


def test_captured_inferencer_refuses_cpu_tensors(deployed):
    _, (tdg, tdv) = deployed
    vol = torch.from_numpy(_vol(0, (16, 16, 16)))
    infer = sliding.make_volume_inferencer(tdg, mode="quantized",
                                           capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        infer(tdv, vol, PATCH, OVERLAP)
    # by default a CPU tensor is served eagerly: no capture is attempted
    default = sliding.make_volume_inferencer(tdg, mode="quantized")
    default(tdv, vol, PATCH, OVERLAP)
    assert default.captured.captures == 0 and default.captured._held is None


class _Artifact:
    def __init__(self, grid):
        self.manifest = {"serve_grid": grid}


# (keyword arguments, the JAX function that raises, its match)
CHECKS = [
    (dict(artifact=_Artifact("patch"), num_mo=2), "num_mo=1"),
    (dict(serve_grid="column"), "stride_div"),
    (dict(serve_grid="column", artifact=_Artifact("patch")),
     "exported for the patch grid"),
    (dict(serve_stem="s2d", artifact=_Artifact("patch")), "serve_stem"),
    (dict(serve_stem="s2d", serve_grid="column", stride_div=16),
     "serve_stem"),
]


@pytest.mark.parametrize("kw,match", CHECKS,
                         ids=[m.split()[0] + str(i)
                              for i, (_, m) in enumerate(CHECKS)])
def test_validate_seg_checks_match_jax(kw, match):
    kw = dict(kw)
    num_mo = kw.pop("num_mo", 1)
    common = dict(patch_size=PATCH, overlap=OVERLAP)
    with pytest.raises(ValueError, match=match) as ours:
        validate.validate_seg(None, None, [], [], num_mo, 3, device="cpu",
                              **common, **kw)
    with pytest.raises(ValueError) as theirs:
        jvalidate.validate_seg(None, None, [], [], num_mo, 3, **common, **kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw,match", [
    (dict(serve_grid="column", artifact=_Artifact("column")),
     "does not compose"),
    (dict(serve_grid="column"), "stride_div"),
    (dict(serve_stem="s2d", artifact=_Artifact("patch")), "serve_stem")])
def test_inference_checks_match_jax(kw, match, tmp_path):
    common = dict(patch_size=PATCH, overlap=OVERLAP,
                  save_dir=str(tmp_path / "out"))
    with pytest.raises(ValueError, match=match) as ours:
        validate.inference(None, None, [], [], device="cpu", **common, **kw)
    with pytest.raises(ValueError) as theirs:
        jvalidate.inference(None, None, [], [], **common, **kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("vol,n", [((155, 240, 240), 1), ((20, 24, 24), 1),
                                   ((64, 64, 64), 2), ((400, 512, 512), 1)])
def test_column_count_matches_jax(vol, n):
    x = np.zeros((n, *vol, 1), np.float32)
    assert validate._column_count(x, 128 if vol[0] > 100 else 16, 16 if
                                  vol[0] > 100 else 4, 16) == \
        jvalidate._column_count(x, 128 if vol[0] > 100 else 16, 16 if
                                vol[0] > 100 else 4, 16)


@pytest.mark.parametrize("vol,patch,overlap,n", [
    ((155, 240, 240), 128, 16, 1), ((20, 24, 24), 16, 4, 1),
    ((20, 24, 24), 16, 4, 3), ((512, 512, 400), (128, 128, 64), 16, 1)])
def test_autotune_off_matches_jax(deployed, vol, patch, overlap, n):
    """'off' is JAX's unmeasured rule, min(full grid, 8), on any device
    (only the example's shape is read); the candidates are JAX's."""
    (jdg, jdv), (tdg, tdv) = deployed
    example = types.SimpleNamespace(shape=(n, *vol, 4))
    got = autotune.choose_patch_batch(tdg, tdv, example, patch, overlap,
                                      tune="off")
    assert got == jautotune.choose_patch_batch(jdg, jdv, example, patch,
                                               overlap, tune="off")
    total = len(sliding.patch_grid(vol, patch, overlap)) * n
    assert got == min(total, 8)
    assert autotune._candidates(total) == jautotune._candidates(total)


@pytest.mark.parametrize("tune", ["auto", "force"])
def test_autotune_off_the_card_returns_default(deployed, tune, monkeypatch,
                                               tmp_path):
    """On the CPU 'auto' and 'force' return the default without measuring
    and without touching the cache."""
    _, (tdg, tdv) = deployed
    monkeypatch.setenv("EFFQ_TUNE_CACHE", str(tmp_path / "tune.json"))

    def boom(*a, **k):
        raise AssertionError("measured off the card")

    monkeypatch.setattr(sliding, "make_volume_inferencer", boom)
    x = torch.from_numpy(_vol(0, (20, 24, 24)))
    assert autotune.choose_patch_batch(tdg, tdv, x, PATCH, OVERLAP,
                                       tune=tune, default=3) == 3
    assert not (tmp_path / "tune.json").exists()
    with pytest.raises(ValueError, match="tune_serving"):
        autotune.choose_patch_batch(tdg, tdv, x, PATCH, OVERLAP, tune="on")


def test_autotune_disk_cache_merges_before_write(monkeypatch, tmp_path):
    """Two writers, one entry each: the file keeps both; the write is an
    atomic replace (no temporary file left)."""
    path = tmp_path / "sub" / "tune.json"
    monkeypatch.setenv("EFFQ_TUNE_CACHE", str(path))
    autotune._save_disk({"a": 2})
    autotune._save_disk({"b": 8})
    assert autotune._load_disk() == {"a": 2, "b": 8}
    autotune._save_disk({"a": 4})
    assert autotune._load_disk() == {"a": 4, "b": 8}
    assert sorted(p.name for p in path.parent.iterdir()) == ["tune.json"]
    path.write_text("{truncated")
    assert autotune._load_disk() == {}


def test_autotune_key_follows_the_deployment(deployed):
    """The key changes with the graph's deployment (int8, K1, K3 flags),
    the geometry and the dtype, and not otherwise."""
    _, (tdg, _) = deployed
    tg = build_uresq(UResQConfig(**CFG))
    fg, _ = fold_bn(tg, nnir.init(tg, 0, device="cpu"))
    args = ((20, 24, 24), 8, PATCH, OVERLAP, "quantized", None, None, "H100")
    keys = {name: autotune.tune_key(g, *args) for name, g in (
        ("int8", tdg), ("fq", fg),
        ("include_1x1", to_pallas_inference(tdg, include_1x1=True)))}
    assert len(set(keys.values())) == 3
    assert autotune.tune_key(tdg, *args) == keys["int8"]
    for i, other in ((0, (20, 24, 32)), (6, torch.bfloat16), (7, "A100")):
        changed = list(args)
        changed[i] = other
        assert autotune.tune_key(tdg, *changed) != keys["int8"]
    sig = autotune.graph_signature(to_pallas_inference(tdg, include_1x1=True))
    assert sig[3] == sum(n.attrs.get("pallas", False)
                         and n.attrs["kernel_size"] == (3, 3, 3)
                         for n in tdg.nodes) and sig[5] > 0


def test_captured_forward_tracks_the_variables():
    """A graph is kept while the variables are the same tensors at the
    same versions; a new tensor, an in-place write or a new value drops
    it.  Inference-mode tensors cannot be tracked and raise."""
    cf = sliding.CapturedForward(lambda v, x: x)
    w = torch.ones(3)
    v = {"params": {"c": {"kernel": w, "alpha": 0.5}}}
    cf.use(v)
    cf.graph = g = object()
    cf.use({"params": {"c": {"kernel": w, "alpha": 0.5}}})  # a new dict
    assert cf.graph is g
    w.mul_(2)  # in place: same address, new version
    cf.use(v)
    assert cf.graph is None
    for change in ({"kernel": w.clone(), "alpha": 0.5},
                   {"kernel": w, "alpha": 0.25}):
        cf.graph = object()
        cf.use({"params": {"c": change}})
        assert cf.graph is None
    with torch.inference_mode():
        t = torch.ones(2)
    with pytest.raises(ValueError, match="inference_mode"):
        cf.use({"params": {"c": {"kernel": t}}})
    with pytest.raises(ValueError, match="use"):
        sliding.CapturedForward(lambda v, x: x)(w)


class _FakeGraph:
    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.fn()
        self.replays += 1


def test_captured_forward_captures_what_recurs(monkeypatch):
    """The capture rule, with the CUDA graph faked (this machine has no
    card): a signature is captured when two calls in a row have it and
    replayed after; a call of another signature (a ragged last chunk) runs
    eagerly and keeps the graph; a variable set that serves one call is
    never captured.  Every call returns the forward's value."""
    eager = []

    def forward(v, x):
        eager.append(x.shape[0])
        return x * v

    cf = sliding.CapturedForward(forward)

    def capture(sig, inputs):
        static_in = [t.clone() for t in inputs]
        static_out = torch.empty_like(inputs[0])
        cf.captures += 1
        graph = _FakeGraph(lambda: static_out.copy_(
            static_in[0] * cf._held[0]))
        return sig, graph, static_in, static_out, [0, 0, 0, 0]

    monkeypatch.setattr(cf, "_capture", capture)
    v = torch.tensor(2.0)
    cf.use(v)
    rows = [3, 3, 1, 3, 3, 1]  # two volumes: two full chunks, one ragged
    for i, n in enumerate(rows):
        x = torch.full((n, 2), float(i))
        assert torch.equal(cf(x), x * 2)
    assert eager == [3, 1, 1] and cf.captures == 1
    assert cf.graph[1].replays == 3
    cf.use(torch.tensor(3.0))  # a new set serving one call
    x = torch.ones(3, 2)
    assert torch.equal(cf(x), x * 3)
    assert cf.graph is None and cf.captures == 1 and eager[-1] == 3
