"""The port's serving artifacts (``export.py``) and K1-K4 as registered
operators (``kernels/library.py``) against the JAX package, on the CPU,
on the tiny int8-deployed net of tests/test_torch_port_serving.py.

Tolerances: a CPU artifact's patch forward equals the port's
``nnir.apply`` exactly (the same plain kernels behind the operators); it
agrees with JAX's exported program (interpret-mode Pallas on the CPU) as
the serving tests state: hard predictions on >= 99.99 % of
voxel-classes, exactly where the logit is farther than 1e-4 from the
boundary.  A bfloat16 artifact of the JAX package's own bf16 test case
against its float32 forward: JAX's bound, 0 < max|d| < 0.1 std + 0.05.
The s2d artifact equals the port's s2d inferencer (float32 head)
exactly; the
column artifact equals the column inferencer exactly.  The operators'
fake implementations are held to their CPU kernels by
``torch.library.opcheck`` (shapes, dtypes, devices).
"""
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from efficientq_tpu import export as jexport
from efficientq_tpu import nnir as jnnir
from efficientq_tpu.models import UResQConfig as JCfg
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq.deploy import to_int8_inference as jdeploy
from efficientq_tpu.quant import fake_quant_weight as jfqw
from efficientq_tpu_torch import export, nnir
from efficientq_tpu_torch.eval import sliding, validate
from efficientq_tpu_torch.kernels import library
from efficientq_tpu_torch.kernels import qconv3d, qmatmul, stem
from efficientq_tpu_torch.kernels.qmatmul import to_pallas_inference
from efficientq_tpu_torch.models import (UResQConfig, build_uresq,
                                         min_input_divisor, torch_io)
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from efficientq_tpu_torch.ptq.deploy import (make_s2d_volume_inferencer,
                                             serving_rewrites)
from efficientq_tpu_torch.utils import tracing

CFG = dict(num_mod=4, num_classes=3, depth_config=[1, 1, 1],
           width_config=[4, 8, 4], dilation_config=[1, 1, 1],
           init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid", ds="simple",
           ds_depth_limit=3, fuse_bn=True, quantize=True, qlvl_w=4,
           qlvl_act=4, q_first=(256, -1), q_last=(256, -1))
PATCH, OVERLAP = (16, 16, 16), (4, 4, 4)


@pytest.fixture(scope="module")
def nets():
    """JAX and port deployments of the same post-PTQ tiny net, and the
    port's folded (undeployed) net."""
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
    tfv = torch_io.from_jax_variables(
        jax.tree_util.tree_map(np.asarray, jfv), device="cpu")
    tdg, tdv = to_int8_inference(tfg, tfv)
    return dict(jax=(jdg, jdv), port=(tdg, tdv), folded=(tfg, tfv))


@pytest.fixture(scope="module")
def artifact(nets, tmp_path_factory):
    dg, dv = nets["port"]
    ep, batch = export.export_patch_model(dg, dv, PATCH, 4, device="cpu")
    path = str(tmp_path_factory.mktemp("art") / "serving_artifact.zip")
    export.save_serving_artifact(path, ep, {"task": "brats",
                                            "patch_size": list(PATCH),
                                            "overlap": list(OVERLAP),
                                            "serve_grid": "patch",
                                            "n_mod": 4, "n_class": 3,
                                            "batch": batch})
    return path, export.load_serving_artifact(path)


def _x(seed, b, shape=PATCH, c=4):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        b, *shape, c).astype(np.float32))


def test_cpu_artifact_equals_apply_and_jax(nets, artifact):
    dg, dv = nets["port"]
    path, art = artifact
    assert art.batch == "symbolic" and art.platforms == ["cpu"]
    fn = art.patch_model_fn()
    for b in (1, 3):  # a symbolic batch takes any size
        x = _x(b, b)
        got = fn(x)
        want = nnir.apply(dg, dv, x, mode="quantized", heads=slice(-1, None))
        assert got.shape == (1, b, *PATCH, 3)
        assert torch.equal(got, want)
    jdg, jdv = nets["jax"]
    jex, jbatch = jexport.export_patch_model(jdg, jdv, PATCH, 4,
                                             platforms=("cpu",))
    x = _x(7, 2)
    want = np.asarray(jex.call(jnp.asarray(x.numpy())))
    got = fn(x).numpy()
    assert np.mean((got >= 0) == (want >= 0)) >= 0.9999
    decided = np.abs(got) > 1e-4
    np.testing.assert_array_equal((got >= 0)[decided], (want >= 0)[decided])


def test_pinned_batch_pads_ragged_chunks(nets, monkeypatch, capsys):
    """Where the symbolic batch does not export, the batch is pinned (and
    the reason printed); a ragged chunk is zero-padded and its padded rows
    dropped."""
    dg, dv = nets["port"]

    def no_dim(*a, **k):
        raise RuntimeError("no symbolic batch here")

    monkeypatch.setattr(torch.export, "Dim", no_dim)
    ep, batch = export.export_patch_model(dg, dv, PATCH, 4, patch_batch=3,
                                          device="cpu")
    assert batch == 3 and "pinning batch=3" in capsys.readouterr().out
    art = export.ServingArtifact(ep, {"batch": 3, "platforms": ["cpu"]})
    fn = art.patch_model_fn()
    x = _x(2, 2)
    np.testing.assert_array_equal(
        fn(x).numpy(), nnir.apply(dg, dv, x, mode="quantized",
                                  heads=slice(-1, None)).numpy())
    with pytest.raises(ValueError, match="> artifact batch 3"):
        fn(_x(3, 4))


def test_bf16_artifact_close_to_f32():
    """--serve_dtype bf16 baked into the export, on the JAX package's own
    case (tests/test_export.py: its fake-quant net from PRNGKey(7), patch
    8^3, two modalities, randn input): float32 logits, bf16-rounded but
    within JAX's bound, 0 < max|d| < 0.1 std(logits) + 0.05; and equal to
    the port's own bfloat16 forward."""
    cfg = dict(CFG, num_mod=2)
    jg = jbuild(JCfg(**cfg))
    jfg, jfv = jfold(jg, jnnir.init(jg, jax.random.PRNGKey(7)))
    for node in jfg.qconv_nodes():
        q = node.attrs["qcfg"]
        p = jfv["params"][node.name]
        if q.q_weight:
            a = jnp.maximum(jnp.max(jnp.abs(p["kernel"])), 1e-8)
            p["kernel"] = jfqw(p["kernel"], a, q.qlvl_w)
            p["alpha_w"] = a
        if q.q_act:
            p["alpha_act"] = jnp.float32(0.8)
    tg = build_uresq(UResQConfig(**cfg))
    fg, _ = fold_bn(tg, nnir.init(tg, 0, device="cpu"))
    fv = torch_io.from_jax_variables(jax.tree_util.tree_map(np.asarray, jfv),
                                     device="cpu")
    ep, _ = export.export_patch_model(fg, fv, (8, 8, 8), 2, device="cpu",
                                      compute_dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 8, 8, 8, 2)
                         .astype(np.float32))
    got = ep.module()(x)
    ref = nnir.apply(fg, fv, x, mode="quantized")[-1:]
    assert got.dtype == torch.float32 and got.shape == ref.shape
    d = float((got - ref).abs().max())
    assert 0 < d < 0.1 * float(ref.std()) + 0.05, (d, float(ref.std()))
    assert torch.equal(got, nnir.apply(fg, fv, x, mode="quantized",
                                       compute_dtype=torch.bfloat16)[-1:])


@pytest.mark.parametrize("deploy", ["int8", "mixed"])
def test_include_1x1_graph_exports(nets, deploy):
    """The 1x1 convs flagged for K3 (int8) or K4 (mixed): the exported
    program carries effq::fused_int8_matmul or effq::fused_qact_matmul and
    equals nnir.apply on the wrappers (the plain kernels on the CPU)."""
    fg, fv = nets["folded"]
    dg, dv = to_int8_inference(
        fg, fv, only_kernel_sizes={(3, 3, 3)} if deploy == "mixed" else None)
    dg = to_pallas_inference(dg, include_1x1=True)
    ep, _ = export.export_patch_model(dg, dv, PATCH, 4, device="cpu")
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    want_op = ("effq.fused_int8_matmul" if deploy == "int8"
               else "effq.fused_qact_matmul")
    assert any(want_op in o for o in ops), sorted(ops)
    assert any("effq.qconv3x3_int8" in o for o in ops)
    x = _x(5, 2)
    assert torch.equal(ep.module()(x), nnir.apply(
        dg, dv, x, mode="quantized", heads=slice(-1, None)))


def _save(path, ep, manifest):
    export.save_serving_artifact(str(path), ep, manifest)
    return export.load_serving_artifact(str(path))


def test_s2d_artifact_through_validate_seg(nets, tmp_path):
    """The s2d artifact (the s2d stem on K2's operator, transform on the
    serving side) through ``validate_seg`` equals the port's s2d
    inferencer on the same graph."""
    dg, dv = nets["port"]
    ep, b, stem_attrs = export.export_s2d_model(dg, dv, PATCH, 4,
                                                patch_batch=4, device="cpu")
    assert b == 4 and stem_attrs["stride"] == [2, 2, 2]
    art = _save(tmp_path / "s2d.zip", ep, {
        "patch_size": list(PATCH), "overlap": list(OVERLAP),
        "serve_stem": "s2d", "channels_first": True,
        "stem_geometry": stem_attrs, "batch": b, "serve_dtype": "bf16"})
    vols = [(np.random.RandomState(i).rand(1, 4, 20, 24, 24)
             .astype(np.float32), np.zeros((1, 3, 20, 24, 24), np.uint8))
            for i in range(2)]
    got, want = [], []

    def recording(infer, store):
        def f(*a):
            store.append(infer(*a))
            return store[-1]
        return f

    common = dict(patch_size=PATCH, overlap=OVERLAP, mode="quantized",
                  device="cpu", patch_batch=4)
    validate.validate_seg(None, None, vols, ["a", "b"], 1, 3,
                          infer=recording(art.volume_inferencer(
                              patch_batch=4, multilabel=True), got),
                          **common)
    # the artifact emits a float32 head, as JAX's does: the s2d inferencer
    # with float32 logits (hard_pred=False), its sign taken after
    logits = make_s2d_volume_inferencer(dg, dv, patch_batch=4,
                                        hard_pred=False,
                                        heads=slice(-1, None), device="cpu")
    for x, _ in vols:
        want.append((logits(None, np.moveaxis(x, 1, -1), PATCH, OVERLAP)
                     >= 0).to(torch.uint8))
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a.shape == (1, 1, 20, 24, 24, 3)
        assert torch.equal(a, b)
    sm = validate.validate_seg(None, None, vols, ["a", "b"], 1, 3,
                               artifact=art, **common)
    assert np.isfinite(sm[-1].get_metric()["dsc"])
    with pytest.raises(ValueError, match="direct serving artifact"):
        art.volume_inferencer()(None, _x(0, 1, (20, 24, 23)), PATCH,
                                OVERLAP)


def test_column_artifact_end_to_end(nets, tmp_path):
    """A column artifact (D pinned at export) serves a shallower volume
    as the column inferencer does; a deeper one raises."""
    dg, dv = nets["port"]
    div = min_input_divisor(UResQConfig(**CFG))[0]
    depth, patch, ov = sliding.column_grid_plan((20, 24, 24), PATCH,
                                                OVERLAP, div)
    ep, batch = export.export_patch_model(dg, dv, patch, 4, device="cpu")
    art = _save(tmp_path / "col.zip", ep, {
        "patch_size": list(patch), "overlap": list(ov), "batch": batch,
        "serve_grid": "column", "column_depth": depth})
    vol = _x(9, 1, (18, 24, 24))
    got = art.volume_inferencer(multilabel=True)(None, vol, PATCH, OVERLAP)
    want = sliding.make_volume_inferencer(
        dg, patch_batch=4, mode="quantized", heads=slice(-1, None),
        hard_pred=True, multilabel=True, serve_grid="column",
        stride_div=div)(dv, vol, PATCH, OVERLAP)
    assert got.shape == (1, 1, 18, 24, 24, 3)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="column depth"):
        art.volume_inferencer()(None, _x(9, 1, (depth + 1, 24, 24)), PATCH,
                                OVERLAP)


@pytest.mark.parametrize("path", ["direct", "s2d", "artifact",
                                  "artifact_s2d"])
def test_each_serving_path_records_the_volume_spans(nets, artifact, path,
                                                    tmp_path):
    """Every serving path runs the one serving loop, so each records the
    same spans of a volume (``utils/tracing.py``): its extraction, its
    chunks, its stitch and its decision."""
    dg, dv = nets["port"]
    vol = _x(11, 1, (20, 24, 24))
    if path == "direct":
        infer = sliding.make_volume_inferencer(
            serving_rewrites(dg, dv)[0], patch_batch=4, mode="quantized",
            heads=slice(-1, None), hard_pred=True, multilabel=True)
    elif path == "s2d":
        infer = make_s2d_volume_inferencer(dg, dv, patch_batch=4,
                                           multilabel=True, device="cpu",
                                           heads=slice(-1, None))
    elif path == "artifact":
        infer = artifact[1].volume_inferencer(patch_batch=4,
                                              multilabel=True)
    else:
        ep, b, stem_attrs = export.export_s2d_model(
            dg, dv, PATCH, 4, patch_batch=4, device="cpu")
        infer = _save(tmp_path / "s2d.zip", ep, {
            "patch_size": list(PATCH), "overlap": list(OVERLAP),
            "serve_stem": "s2d", "channels_first": True,
            "stem_geometry": stem_attrs, "batch": b}).volume_inferencer(
            patch_batch=4, multilabel=True)
    with profile(activities=[ProfilerActivity.CPU]):
        pred = infer(dv, vol, PATCH, OVERLAP)
    assert pred.shape == (1, 1, 20, 24, 24, 3) and pred.dtype == torch.uint8
    names = [s["name"] for s in tracing.record()["spans"]]
    n_chunks = -(-len(sliding.patch_grid((20, 24, 24), PATCH, OVERLAP)) // 4)
    assert sorted(names) == sorted(
        ["volume.extract", "volume.stitch", "volume.decide"]
        + ["volume.chunk"] * n_chunks)


def test_formats_refuse_each_other(nets, artifact, tmp_path):
    """The JAX package's artifact zip is refused by the port's loader,
    and the port's by JAX's, each naming the formats."""
    path, _ = artifact
    with pytest.raises(ValueError, match="efficientq-serving/1"):
        jexport.load_serving_artifact(path)
    jdg, jdv = nets["jax"]
    jex, jbatch = jexport.export_patch_model(jdg, jdv, PATCH, 4,
                                             platforms=("cpu",))
    jpath = str(tmp_path / "jax.zip")
    jexport.save_serving_artifact(jpath, jex, {"batch": jbatch})
    with pytest.raises(ValueError) as e:
        export.load_serving_artifact(jpath)
    assert export.FORMAT in str(e.value) and export.JAX_FORMAT in str(e.value)


def test_cuda_artifact_refused_on_the_cpu(artifact, tmp_path):
    path, art = artifact
    art.check_platform("cpu")
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read(export.MANIFEST_NAME))
        module = z.read(export.MODULE_NAME)
    manifest["platforms"] = ["cuda"]
    cuda = str(tmp_path / "cuda.zip")
    with zipfile.ZipFile(cuda, "w") as z:
        z.writestr(export.MANIFEST_NAME, json.dumps(manifest))
        z.writestr(export.MODULE_NAME, module)
    with pytest.raises(RuntimeError, match=r"\['cuda'\].*'cpu'"):
        export.load_serving_artifact(cuda).check_platform("cpu")


def _k1_cases():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(2, 4, 6, 8, 8).astype(np.float32))
    codes = torch.from_numpy(rng.randint(-3, 4, (3, 3, 3, 8, 16))
                             .astype(np.int8))
    bias = torch.from_numpy(rng.randn(16).astype(np.float32))
    res = torch.from_numpy(rng.randn(2, 4, 6, 8, 16).astype(np.float32))
    a, s = torch.tensor(0.9), torch.tensor(0.01)
    base = (x, codes, bias, a, s, 4, 1, None, torch.tensor(0.0), 0, False,
            False, False, None, False)

    def case(**kw):
        args = list(base)
        names = ["x", "w_codes", "bias", "alpha_act", "scale", "qlvl_act",
                 "dilation", "residual", "quant_alpha", "quant_qlvl",
                 "x_quantized", "residual_relu", "pool", "w_packed",
                 "out_bf16"]
        for k, v in kw.items():
            args[names.index(k)] = v
        return tuple(args)

    return {"plain": case(), "pool": case(pool=True),
            "quant": case(quant_alpha=torch.tensor(1.5), quant_qlvl=4),
            "residual_bf16": case(residual=res, residual_relu=True,
                                  out_bf16=True),
            "dilation2_codes": case(dilation=2, x_quantized=True,
                                    x=torch.randint(0, 4, (2, 4, 6, 8, 8),
                                                    dtype=torch.int8))}


K1_CASES = _k1_cases()


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_operator_fake_and_cpu_match(case):
    args = K1_CASES[case]
    torch.library.opcheck(torch.ops.effq.qconv3x3_int8, args,
                          test_utils=("test_schema", "test_faketensor"))
    y, pooled = torch.ops.effq.qconv3x3_int8(*args)
    want = qconv3d.qconv3x3_int8_ndhwc(
        *args[:6], dilation=args[6], residual=args[7],
        quant_alpha=args[8] if args[9] else None, quant_qlvl=args[9],
        x_quantized=args[10], residual_relu=args[11], pool=args[12],
        out_dtype=torch.bfloat16 if args[14] else torch.float32)
    if args[12]:
        assert torch.equal(y, want[0]) and torch.equal(pooled, want[1])
    else:
        assert torch.equal(y, want) and pooled.numel() == 0
    adapted = library.qconv3x3_int8(
        *args[:6], dilation=args[6], residual=args[7],
        quant_alpha=args[8] if args[9] else None, quant_qlvl=args[9],
        x_quantized=args[10], residual_relu=args[11], pool=args[12],
        out_dtype=torch.bfloat16 if args[14] else torch.float32)
    assert torch.equal(adapted[0] if args[12] else adapted, y)


def test_k2_k3_k4_operators_fake_and_cpu_match():
    rng = np.random.RandomState(1)
    c, o = 4, 8
    w_even, w_odd = (torch.from_numpy(w).to(torch.bfloat16)
                     for w in stem.s2d_stem_weights(
                         rng.randn(3, 3, 3, c, o).astype(np.float32)))
    xs = torch.from_numpy(rng.rand(2, 5, 4, 4, 8 * c).astype(np.float32)) \
        .to(torch.bfloat16)
    par = torch.tensor([0, 1], dtype=torch.int32)
    bias = torch.from_numpy(rng.randn(o).astype(np.float32))
    x2 = torch.from_numpy(rng.rand(40, 16).astype(np.float32))
    codes = torch.from_numpy(rng.randint(-7, 8, (16, 12)).astype(np.int8))
    w = torch.from_numpy(rng.randn(16, 12).astype(np.float32))
    b12 = torch.from_numpy(rng.randn(12).astype(np.float32))
    a = torch.tensor(0.7)
    cases = [
        (torch.ops.effq.stem_s2d_conv,
         (xs, par, w_even, w_odd, bias, a, 4, True, None),
         stem.stem_s2d_conv(xs, par, w_even, w_odd, bias, a, 4,
                            torch.bfloat16)),
        (torch.ops.effq.fused_int8_matmul,
         (x2, codes, b12, a, torch.tensor(0.003), 16, None),
         qmatmul.fused_int8_matmul(x2, codes, b12, a, torch.tensor(0.003),
                                   16)),
        (torch.ops.effq.fused_qact_matmul, (x2, w, b12, a, 16),
         qmatmul.fused_qact_matmul(x2, w, b12, a, 16))]
    for op, args, want in cases:
        torch.library.opcheck(op, args,
                              test_utils=("test_schema", "test_faketensor"))
        got = op(*args)
        for g, wv in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            assert g.dtype == wv.dtype and torch.equal(g, wv)
    assert torch.equal(library.stem_s2d_conv(xs, par, w_even, w_odd, bias,
                                             0.7, 4, torch.bfloat16)[1],
                       cases[0][2][1])
