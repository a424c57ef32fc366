"""K5's route on the CPU: the serving rewrite
``ptq/deploy.py::upsample_serving`` and the plain version of
``kernels/upsample.py`` (the kernel itself runs on the card only,
tests/test_torch_port_upsample_cuda.py).

The rewrite turns the LiTS decoder's four ``upsample -> add`` pairs into
``upsample_k5`` nodes that add the skip in the kernel's epilogue and every
other upsample into an ``upsample_k5`` node of one input (channels-first
after ``channels_first_tail``), leaves an upsample that a batch norm
separates from its add unfused, and reaches neither the
training forward nor the calibration.  On the CPU the K5 nodes evaluate
the plain version, the unfused pair itself, so the rewritten deployment
equals the unrewritten one bit for bit, as does an exported artifact that
carries ``effq::upsample_trilinear3d``.
"""
import numpy as np
import pytest
import torch

from efficientq_tpu_torch import export, nnir, ops
from efficientq_tpu_torch.eval import validate
from efficientq_tpu_torch.kernels import library
from efficientq_tpu_torch.kernels import upsample as K5
from efficientq_tpu_torch.models import (UResQConfig, build_uresq,
                                         preset_config)
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from efficientq_tpu_torch.ptq.deploy import (channels_first_tail,
                                             upsample_serving)
from efficientq_tpu_torch.ptq.engine import PTQHyperParams, run_ptq
from efficientq_tpu_torch.quant import fake_quant_weight

# a LiTS-shaped net: 1 modality, 3 classes, init stride (2, 2, 1), the
# 'simple' deep supervision, narrow
TINY = dict(num_mod=1, num_classes=3, depth_config=[1, 1, 1, 1, 1],
            width_config=[4, 8, 16, 8, 4], dilation_config=[1] * 5,
            init_stride=(2, 2, 1), drop_rate=0.0, blk_type="mid",
            ds="simple", ds_depth_limit=3, quantize=True, qlvl_w=4,
            qlvl_act=4, q_first=(256, -1), q_last=(256, -1))
PATCH = (16, 16, 8)


def _post_ptq(cfg, seed=0):
    """The folded graph of ``cfg`` and post-PTQ variables: each kernel on
    its alpha_w = max|w| grid, alpha_act 0.8."""
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
            p["alpha_act"] = torch.tensor(0.8)
    return fg, fv


@pytest.fixture(scope="module")
def tiny():
    return to_int8_inference(*_post_ptq(UResQConfig(**TINY)))


def _ops(graph, kind):
    return {n.name: n for n in graph.nodes if n.op == kind}


def _fused(graph):
    """The K5 nodes with the skip add in their epilogue."""
    return {name: n for name, n in _ops(graph, "upsample_k5").items()
            if len(n.inputs) == 2}


def test_lits_decoder_pairs_fuse_and_the_head_goes_channels_first():
    cfg = preset_config("lits", quantize=True, qlvl_w=4, qlvl_act=4,
                        q_first=(256, -1), q_last=(256, -1))
    graph = build_uresq(cfg)
    dg, _ = to_int8_inference(*fold_bn(graph, nnir.init(graph, 0,
                                                        device="cpu")))
    served = upsample_serving(channels_first_tail(dg))
    fused = _fused(served)
    assert sorted(fused) == [f"trans_ups.TransUp{i}.add" for i in (5, 6, 7,
                                                                  8)]
    for i in (5, 6, 7, 8):
        node = fused[f"trans_ups.TransUp{i}.add"]
        assert node.inputs == (f"trans_ups.TransUp{i}.upsampler.block.bn",
                               dg.node(f"trans_ups.TransUp{i}.add").inputs[1])
        assert node.attrs == {"scale_factor": (2, 2, 2),
                              "channels_first": False}
    k5 = _ops(served, "upsample_k5")
    assert k5["final_cls.extra_up"].attrs == {"scale_factor": (2, 2, 1),
                                              "channels_first": True}
    assert not _ops(served, "upsample") and not _ops(served, "upsample_cf")
    assert served.outputs == ["final_cls.extra_up"]
    # the direct path's tail stays channels-minor; the aux heads go to K5
    direct = upsample_serving(dg)
    assert not _ops(direct, "upsample")
    assert {n: a.attrs["channels_first"]
            for n, a in _ops(direct, "upsample_k5").items()
            if n not in fused} == {
        "classifiers.AuxClassifier7.extra_up": False,
        "classifiers.AuxClassifier8.extra_up": False,
        "final_cls.extra_up": False}
    assert upsample_serving(direct) is direct  # applies once
    # the channels-first tail of a graph already on K5: the same graph
    later = channels_first_tail(direct)
    assert [(n.name, n.op, n.inputs, n.attrs) for n in later.nodes] == [
        (n.name, n.op, n.inputs, n.attrs) for n in served.nodes]
    assert later.outputs == served.outputs


def test_a_batch_norm_between_upsample_and_add_keeps_them_apart():
    """The fuse_bn graphs' TransUp.bn_x sits between the upsample and the
    add: the upsample runs on K5 without the epilogue."""
    cfg = UResQConfig(**dict(TINY, blk_type="pre", fuse_bn=True))
    dg, _ = to_int8_inference(*_post_ptq(cfg))
    served = upsample_serving(dg)
    assert not _fused(served)
    for i in (3, 4):
        up = served.node(f"trans_ups.TransUp{i}.upsampler.trilinear")
        assert up.op == "upsample_k5"
        assert served.node(f"trans_ups.TransUp{i}.bn_x").inputs == (up.name,)
    # an upsample with a second consumer stays unfused too
    g = nnir.GraphBuilder()
    x = g.input()
    up = g.upsample("up", x, 2)
    s = g.add_op("add", up, g.identity("skip", up))
    graph = upsample_serving(g.build([s]))
    assert graph.node("up").op == "upsample_k5"
    assert graph.node("add").op == "add"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [3, 32])
@pytest.mark.parametrize("cf", [False, True], ids=["ndhwc", "ncdhw"])
@pytest.mark.parametrize("f", [(2, 2, 2), (2, 2, 1), (8, 8, 4)])
def test_plain_k5_is_the_upsample_plus_skip(f, cf, c, dtype):
    rng = np.random.RandomState(sum(f) + c)
    ext = (3, 5, 4)
    shape = (2, c, *ext) if cf else (2, *ext, c)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    up = (ops.upsample3d_cf if cf else ops.upsample3d)(x, f)
    skip = torch.from_numpy(rng.randn(*up.shape).astype(np.float32)) \
        .to(dtype)
    for s, want in ((None, up), (skip, up + skip)):
        got = K5.upsample_trilinear3d(x, f, s, channels_first=cf)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(
            K5.upsample_trilinear3d_reference(x, f, s, channels_first=cf),
            want)
    # a float32 skip promotes a bfloat16 upsample, as the unfused add does
    got = K5.upsample_trilinear3d(x, f, skip.float(), channels_first=cf)
    assert got.dtype == torch.float32 and torch.equal(got, up + skip.float())


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rewritten_deployment_equals_the_unrewritten(tiny, compute_dtype):
    dg, dv = tiny
    x = torch.from_numpy(np.random.RandomState(3).rand(
        3, *PATCH, 1).astype(np.float32))
    served = upsample_serving(dg)
    assert len(_fused(served)) == 2
    want = nnir.apply(dg, dv, x, mode="quantized",
                      compute_dtype=compute_dtype)
    got = nnir.apply(served, dv, x, mode="quantized",
                     compute_dtype=compute_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    # and with the channels-first tail, as the s2d path and its artifact
    # serve it
    tail = channels_first_tail(dg)
    want = nnir.apply(tail, dv, x, mode="quantized",
                      compute_dtype=compute_dtype)
    got = nnir.apply(upsample_serving(tail), dv, x, mode="quantized",
                     compute_dtype=compute_dtype, kernels=library.OPS)
    assert torch.equal(got, want)


def test_serving_runs_k5_and_training_and_calibration_do_not(tiny,
                                                             monkeypatch):
    calls = []

    def counted(*a, **kw):
        calls.append(a[1])
        return K5.upsample_trilinear3d(*a, **kw)

    monkeypatch.setattr(nnir, "WRAPPERS",
                        nnir.WRAPPERS._replace(upsample=counted))
    dg, dv = tiny
    vol = torch.from_numpy(np.random.RandomState(4).rand(
        1, 20, 18, 12, 1).astype(np.float32))
    infer = validate._build_infer(
        dg, dv, vol, PATCH, (4, 4, 4), mode="quantized", patch_batch=2,
        multilabel=False, compute_dtype=None, serve_stem="direct",
        heads=slice(-1, None), device=torch.device("cpu"))
    pred = infer(dv, vol, PATCH, (4, 4, 4))
    assert pred.shape == (1, 1, 20, 18, 12)
    # 2 fused decoder upsamples and the head, per forward of 2 patches
    assert calls and len(calls) % 3 == 0
    calls.clear()
    fg, fv = _post_ptq(UResQConfig(**TINY))
    x = torch.from_numpy(np.random.RandomState(5).rand(
        2, *PATCH, 1).astype(np.float32))
    nnir.apply(fg, fv, x, mode="fq", train=True, seed=1)
    calib = torch.from_numpy(np.random.RandomState(6).rand(
        1, 32, 32, 16, 1).astype(np.float32))
    run_ptq(fg, fv, calib, task="lits", init_stride=(2, 2, 1),
            hp=PTQHyperParams(admm_iter=5), device="cpu")
    assert calls == []


def test_artifact_carries_k5_and_round_trips(tiny, tmp_path):
    dg, dv = tiny
    ep, batch = export.export_patch_model(dg, dv, PATCH, 1, patch_batch=2,
                                          device="cpu")
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert sum("effq.upsample_trilinear3d" in t for t in targets) == 3
    assert not any("upsample_trilinear3d.default" in t
                   and "aten" in t for t in targets)
    path = str(tmp_path / "a.zip")
    export.save_serving_artifact(path, ep, {"batch": batch,
                                            "patch_size": list(PATCH)})
    art = export.load_serving_artifact(path)
    x = torch.from_numpy(np.random.RandomState(7).rand(
        3, *PATCH, 1).astype(np.float32))
    want = nnir.apply(dg, dv, x, mode="quantized", heads=slice(-1, None))
    assert torch.equal(art.patch_model_fn()(x), want)


@pytest.mark.parametrize("cf", [False, True], ids=["ndhwc", "ncdhw"])
def test_k5_operator_fake_and_cpu_match(cf):
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 3, 4, 5, 6).astype(np.float32))
    want = K5.upsample_trilinear3d(x, (2, 2, 1), channels_first=cf)
    skip = torch.from_numpy(rng.randn(*want.shape).astype(np.float32)) \
        .to(torch.bfloat16)
    for s in (None, skip):
        args = (x, [2, 2, 1], s, cf)
        torch.library.opcheck(torch.ops.effq.upsample_trilinear3d, args,
                              test_utils=("test_schema", "test_faketensor"))
        got = torch.ops.effq.upsample_trilinear3d(*args)
        ref = K5.upsample_trilinear3d(x, (2, 2, 1), s, channels_first=cf)
        assert got.dtype == ref.dtype and torch.equal(got, ref)
        assert torch.equal(library.upsample_trilinear3d(x, (2, 2, 1), s, cf),
                           ref)


def test_k5_refuses_what_it_cannot_take():
    x = torch.zeros(1, 2, 2, 2, 4)
    with pytest.raises(ValueError, match="K5 runs on CUDA"):
        K5.upsample_trilinear3d(x.to("meta"), 2)
