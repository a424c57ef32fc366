"""The port's validation loop (``eval/validate.py``: ``validate_seg``,
``inference``, with its 1-deep pipeline and the device feed) against the
JAX package's, on a tiny int8-deployed UResQ over a synthetic LiTS set
(argmax) and a synthetic BraTS set (multilabel), on the CPU.

The JAX side runs its fused deployment in interpret mode, as its own tests
do; the port takes K1's plain version.  Tolerance, as
tests/test_torch_port_serving.py: hard predictions agree on >= 99.99 % of
voxel-classes, and exactly wherever the overlap-summed logit is farther
than 1e-4 from the decision boundary (0 for the sign test, the runner-up
for the argmax).  ``SegMetricMC.get_metric()`` is equal wherever the
predictions are.  Plus ``restore_crop``, the ``s2d`` serving stem
through ``validate_seg`` and the mesh's refusal (the serving options'
checks are in tests/test_torch_port_serving_extras.py).
"""
import glob
import os.path as P

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu.data import datahub as jdatahub
from efficientq_tpu.data import synthetic as jsynth
from efficientq_tpu.eval import sliding as jsliding
from efficientq_tpu.eval import validate as jvalidate
from efficientq_tpu.models import UResQConfig as JCfg
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.models import num_mo
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq.deploy import to_int8_inference as jdeploy
from efficientq_tpu.quant import fake_quant_weight as jfqw
from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.data import datahub, labels
from efficientq_tpu_torch.eval import sliding, validate
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference
from efficientq_tpu_torch.utils.nifti import load_nifti

VOL = (20, 24, 24)
PATCH, OVERLAP = (16, 16, 16), (4, 4, 4)
TASKS = {
    "lits": dict(mods=("seg", "ct"), num_mod=1, split=None,
                 merge=None, fuse=None),
    "brats": dict(mods=("seg", "flair", "t1", "t1ce", "t2"), num_mod=4,
                  split=labels.split_label_brats,
                  merge=labels.merge_label_brats, fuse="con"),
}


def _cfg(task):
    return dict(num_mod=TASKS[task]["num_mod"], num_classes=3,
                depth_config=[1, 1, 1], width_config=[4, 8, 4],
                dilation_config=[1, 1, 1], init_stride=(2, 2, 2),
                drop_rate=0.0, blk_type="mid", ds="simple",
                ds_depth_limit=3, fuse_bn=True, quantize=True, qlvl_w=4,
                qlvl_act=4, q_first=(256, -1), q_last=(256, -1))


def _deployed(task, seed=0):
    """JAX and port int8 deployments of the same post-PTQ tiny net."""
    cfg = _cfg(task)
    jg = jbuild(JCfg(**cfg))
    jfg, jfv = jfold(jg, jnnir.init(jg, jax.random.PRNGKey(seed)))
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
    tg = build_uresq(UResQConfig(**cfg))
    tfg, _ = fold_bn(tg, nnir.init(tg, seed, device="cpu"))
    tdg, tdv = to_int8_inference(
        tfg, torch_io.from_jax_variables(
            jax.tree_util.tree_map(np.asarray, jfv), device="cpu"))
    return (jdg, jdv), (tdg, tdv), num_mo(JCfg(**cfg))


def _hub(module, task, data_dir, split_dir):
    t = TASKS[task]
    r = P.join(split_dir, "round1")
    hub = module.DataHub(
        data_dir, t["mods"], val_split=P.join(r, "val.txt"),
        test_split=P.join(r, "test.txt"),
        true_test_split=P.join(r, "true_test.txt"), access_type="npy",
        sn_fn_file="sn_fn.txt", slide_patch_size=PATCH,
        slide_overlap=OVERLAP,
        tfm_lambda=(None if t["split"] is None else
                    lambda img, label: (img, t["split"](label))))
    hub.merge_label_func = t["merge"]
    hub.multilabel_fusetype = t["fuse"]
    return hub


def _recording(make, store):
    def infer(*a):
        out = make(*a)
        store.append(out)
        return out
    return infer


@pytest.fixture(scope="module", params=sorted(TASKS))
def validated(request, tmp_path_factory):
    task = request.param
    root = tmp_path_factory.mktemp(f"validate_{task}")
    data_dir, split_dir = jsynth.make_synthetic_dataset(
        str(root), task=task, n_subjects=4, vol_shape=VOL,
        splits=(0.25, 0.5, 0.25))
    (jdg, jdv), (tdg, tdv), n_mo = _deployed(task)
    multilabel = task == "brats"
    kw = dict(mode="quantized", hard_pred=True, multilabel=multilabel)
    jhub, hub = _hub(jdatahub, task, data_dir, split_dir), \
        _hub(datahub, task, data_dir, split_dir)
    jpreds, tpreds = [], []
    common = dict(patch_size=PATCH, overlap=OVERLAP, mode="quantized",
                  multilabel_fusetype=TASKS[task]["fuse"])
    jsm = jvalidate.validate_seg(
        jdg, jdv, jhub.valloader, jhub.val_sn, n_mo, 3,
        infer=_recording(jsliding.make_jitted_volume_inferencer(
            jdg, patch_batch=4, **kw), jpreds), **common)
    tsm = validate.validate_seg(
        tdg, tdv, hub.valloader, hub.val_sn, n_mo, 3,
        infer=_recording(sliding.make_volume_inferencer(
            tdg, patch_batch=4, **kw), tpreds), device="cpu", **common)
    # the same loop with its own inferencer ("auto": min(grid, 8)) and the
    # NIfTI export of the final head
    auto = validate.validate_seg(
        tdg, tdv, hub.valloader, hub.val_sn, n_mo, 3, device="cpu",
        save_dir=str(root / "port_val"), sn_fn_dict=hub.sn_to_fn_map,
        merge_label_func=hub.merge_label_func, **common)
    jvalidate.validate_seg(
        jdg, jdv, jhub.valloader, jhub.val_sn, n_mo, 3,
        save_dir=str(root / "jax_val"), sn_fn_dict=jhub.sn_to_fn_map,
        merge_label_func=jhub.merge_label_func, **common)
    for module, h, g, v, out, extra in (
            (jvalidate, jhub, jdg, jdv, "jax_tt", {}),
            (validate, hub, tdg, tdv, "port_tt", {"device": "cpu"})):
        module.true_test_inference(g, v, h, str(root / out),
                                   mode="quantized",
                                   multilabel_fusetype=h.multilabel_fusetype,
                                   **extra)
    # the overlap-summed logits of every head: the decision variable
    sums = [sliding.sliding_window_inference(
        lambda xb: nnir.apply(tdg, tdv, xb, mode="quantized"),
        torch.from_numpy(np.moveaxis(x, 1, -1)), PATCH, OVERLAP, 4,
        normalize=False).numpy() for x, _ in hub.valloader]
    return dict(task=task, root=root, jsm=jsm, tsm=tsm, auto=auto,
                jpreds=[np.asarray(p) for p in jpreds],
                tpreds=[p.numpy() for p in tpreds], sums=sums,
                multilabel=multilabel, n_mo=n_mo, hub=hub, graph=tdg,
                variables=tdv)


def _decided(sums, multilabel):
    if multilabel:
        return np.abs(sums) > 1e-4
    top = np.sort(sums, axis=-1)
    return (top[..., -1] - top[..., -2]) > 1e-4


def test_validate_seg_predictions_match_jax(validated):
    v = validated
    assert len(v["tpreds"]) == len(v["jpreds"]) == 2
    for got, want, sums in zip(v["tpreds"], v["jpreds"], v["sums"]):
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape
        assert got.shape[:5] == (v["n_mo"], 1, *VOL)
        assert np.mean(got == want) >= 0.9999
        decided = _decided(sums, v["multilabel"])
        np.testing.assert_array_equal(got[decided], want[decided])


def test_validate_seg_metrics_match_jax(validated):
    v = validated
    assert len(v["tsm"]) == len(v["jsm"]) == v["n_mo"]
    for i in range(v["n_mo"]):
        if all(np.array_equal(a[i], b[i])
               for a, b in zip(v["tpreds"], v["jpreds"])):
            assert v["tsm"][i].get_metric() == v["jsm"][i].get_metric()
        assert v["auto"][i].get_metric() == v["tsm"][i].get_metric()
        assert all(np.isfinite(list(v["tsm"][i].get_metric().values())))
    for a, b in zip(v["tpreds"], v["jpreds"]):
        assert np.mean(a == b) >= 0.9999


@pytest.mark.parametrize("kind", ["port_val", "port_tt"])
def test_nifti_exports_match_jax(validated, kind):
    root = validated["root"]
    mine = sorted(glob.glob(str(root / kind / "*.nii.gz")))
    theirs = sorted(glob.glob(str(root / kind.replace("port", "jax") /
                                  "*.nii.gz")))
    assert [P.basename(p) for p in mine] == [P.basename(p) for p in theirs]
    assert mine
    for a, b in zip(mine, theirs):
        pa = np.asarray(load_nifti(a).dataobj)
        pb = np.asarray(load_nifti(b).dataobj)
        assert pa.shape == pb.shape == VOL and pa.dtype == np.uint16
        assert np.mean(pa == pb) >= 0.9999


def test_pipeline_equals_one_volume_at_a_time(validated):
    """validate_seg's pipelined loop gives what serving each volume alone
    gives, in order."""
    v = validated
    infer = sliding.make_volume_inferencer(
        v["graph"], patch_batch=4, mode="quantized", hard_pred=True,
        multilabel=v["multilabel"])
    for (x, _), got in zip(v["hub"].valloader, v["tpreds"]):
        one = infer(v["variables"], torch.from_numpy(np.moveaxis(x, 1, -1)),
                    PATCH, OVERLAP)
        np.testing.assert_array_equal(one.numpy(), got)


def test_s2d_stem_through_validate_seg(validated):
    """``serve_stem="s2d"`` serves through the space-to-depth stem (K2's
    plain version on the CPU) at bfloat16: >= 0.999 agreement with the
    direct bf16 path, the JAX package's level for bf16 reduction order."""
    v = validated
    got, want = [], []
    common = dict(patch_size=PATCH, overlap=OVERLAP, mode="quantized",
                  compute_dtype=torch.bfloat16, device="cpu")
    from efficientq_tpu_torch.ptq.deploy import make_s2d_volume_inferencer

    s2d = make_s2d_volume_inferencer(v["graph"], v["variables"],
                                     multilabel=v["multilabel"],
                                     device="cpu")
    assert s2d is not None
    validate.validate_seg(v["graph"], v["variables"], v["hub"].valloader,
                          v["hub"].val_sn, v["n_mo"], 3, serve_stem="s2d",
                          infer=_recording(s2d, got), **common)
    validate.validate_seg(v["graph"], v["variables"], v["hub"].valloader,
                          v["hub"].val_sn, v["n_mo"], 3,
                          infer=_recording(sliding.make_volume_inferencer(
                              v["graph"], patch_batch=8, mode="quantized",
                              hard_pred=True, multilabel=v["multilabel"],
                              compute_dtype=torch.bfloat16), want),
                          **common)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a == b).float().mean()) >= 0.999
    sm = validate.validate_seg(v["graph"], v["variables"],
                               v["hub"].valloader, v["hub"].val_sn,
                               v["n_mo"], 3, serve_stem="s2d", **common)
    assert all(np.isfinite(list(sm[-1].get_metric().values())))


@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(mesh=object()), "item 9", id="kw2-item 9")])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        validate.validate_seg(None, None, [], [], 1, 3, patch_size=PATCH,
                              overlap=OVERLAP, device="cpu", **kw)


def test_restore_crop_matches_jax():
    crop = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    args = ((1, 2, 3), (3, 5, 7), (5, 6, 9))
    np.testing.assert_array_equal(validate.restore_crop(crop, *args),
                                  jvalidate.restore_crop(crop, *args))
