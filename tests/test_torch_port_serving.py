"""The serving slice end to end against the JAX package: a tiny int8-deployed
UResQ served over a whole volume (patch grid, fused int8 graph, final head,
multilabel hard prediction), then Dice.  Plus the pieces: grid, stitch,
labels, metrics, the synthetic generator, and the interpreter's dead-node
rule.

The JAX side runs its fused deployment graph on the CPU as its own tests do
(``to_int8_inference(pallas=True)``: the Pallas kernels in interpret mode);
the port runs the same fused graph with K1's plain version.  Tolerance:
hard predictions agree on >= 99.99 % of voxel-classes, and exactly wherever
the overlap-summed logit is farther than 1e-4 from the decision boundary
(the interpret-mode kernel fuses the scale multiply-add into an FMA, a
1-ulp difference that can only flip a voxel sitting on the boundary).
Dice is computed by both packages' metrics and must be equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu.data import labels as jlabels
from efficientq_tpu.data import synthetic as jsynth
from efficientq_tpu.eval import metrics as jmetrics
from efficientq_tpu.eval import sliding as jsliding
from efficientq_tpu.models import UResQConfig as JCfg
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.ptq import fold_bn as jfold
from efficientq_tpu.ptq.deploy import to_int8_inference as jdeploy
from efficientq_tpu.quant import fake_quant_weight as jfqw
from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.data import labels, synthetic
from efficientq_tpu_torch.eval import metrics, sliding
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.ptq import fold_bn, to_int8_inference

CFG = dict(num_mod=4, num_classes=3, depth_config=[1, 1, 1],
           width_config=[4, 8, 4], dilation_config=[1, 1, 1],
           init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid", ds="simple",
           ds_depth_limit=3, fuse_bn=True, quantize=True, qlvl_w=4,
           qlvl_act=4, q_first=(256, -1), q_last=(256, -1))
VOL = (20, 24, 24)
PATCH, OVERLAP = (16, 16, 16), (4, 4, 4)


def _deployed(seed=0):
    """JAX and port deployments of the same post-PTQ tiny net."""
    jg = jbuild(JCfg(**CFG))
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
    tg = build_uresq(UResQConfig(**CFG))
    tfg, _ = fold_bn(tg, nnir.init(tg, seed, device="cpu"))
    tdg, tdv = to_int8_inference(
        tfg, torch_io.from_jax_variables(
            jax.tree_util.tree_map(np.asarray, jfv), device="cpu"))
    return (jdg, jdv), (tdg, tdv)


def _subject(seed=0):
    images, label = synthetic.make_subject(np.random.default_rng(seed),
                                           "brats", VOL)
    vol = np.stack([images[m] for m in ("flair", "t1", "t1ce", "t2")], -1)
    return vol[None], label


@pytest.fixture(scope="module")
def served():
    (jdg, jdv), (tdg, tdv) = _deployed()
    vol, label = _subject()
    kw = dict(patch_batch=4, mode="quantized", heads=slice(-1, None),
              hard_pred=True, multilabel=True)
    want = np.asarray(jsliding.make_jitted_volume_inferencer(jdg, **kw)(
        jdv, jnp.asarray(vol), PATCH, OVERLAP))
    got = sliding.make_volume_inferencer(tdg, **kw)(
        tdv, torch.from_numpy(vol), PATCH, OVERLAP).numpy()
    # the overlap-summed logits (the hard prediction's decision variable)
    sums = sliding.sliding_window_inference(
        lambda xb: nnir.apply(tdg, tdv, xb, mode="quantized",
                              heads=slice(-1, None)),
        torch.from_numpy(vol), PATCH, OVERLAP, 4, normalize=False).numpy()
    return dict(got=got, want=want, sums=sums, label=label)


def test_serving_hard_prediction_matches_jax(served):
    got, want, sums = served["got"], served["want"], served["sums"]
    assert got.shape == want.shape == (1, 1, *VOL, 3)
    assert got.dtype == want.dtype == np.uint8
    assert np.mean(got == want) >= 0.9999
    decided = np.abs(sums) > 1e-4
    np.testing.assert_array_equal(got[decided], want[decided])
    assert 0 < got.mean() < 1  # both classes of decision occur


def test_serving_dice_matches_jax_metrics(served):
    pred = served["got"][0, 0].transpose(3, 0, 1, 2)
    target = labels.split_label_brats(served["label"])
    np.testing.assert_array_equal(
        target, jlabels.split_label_brats(served["label"]))
    for c in range(3):
        d = metrics.dice(pred[c], target[c])
        assert np.isfinite(d) and d == jmetrics.dice(pred[c], target[c])
    ours, theirs = metrics.SegMetricMC(3), jmetrics.SegMetricMC(3)
    ours.evaluate_append_pred(pred, target, True)
    theirs.evaluate_append_pred(pred, target, True)
    assert ours.get_metric() == theirs.get_metric()


def test_final_head_serving_skips_dead_nodes(monkeypatch):
    """heads=slice(-1, None) evaluates no aux-head node, and no relu that
    epilogue fusion bypassed; all heads evaluate the aux classifiers."""
    _, (tdg, tdv) = _deployed()
    seen = []
    real = nnir.eval_node

    def spy(node, *a, **kw):
        seen.append(node.name)
        return real(node, *a, **kw)

    monkeypatch.setattr(nnir, "eval_node", spy)
    x = torch.from_numpy(_subject()[0][:, :16, :16, :16].copy())
    out = nnir.apply(tdg, tdv, x, mode="quantized", heads=slice(-1, None))
    assert out.shape == (1, 1, 16, 16, 16, 3)
    assert not [n for n in seen if n.startswith("classifiers.")]
    cons = tdg.consumers()
    dead_relus = [n.name for n in tdg.nodes
                  if n.op == "relu" and not cons.get(n.name)]
    assert dead_relus and not set(dead_relus) & set(seen)
    assert len(seen) == len(set(seen))  # each node at most once
    seen.clear()
    full = nnir.apply(tdg, tdv, x, mode="quantized")
    assert full.shape[0] == 2 and any(n.startswith("classifiers.")
                                      for n in seen)
    np.testing.assert_array_equal(full[-1:].numpy(), out.numpy())


@pytest.mark.parametrize("vol,patch,overlap", [
    ((155, 240, 240), 128, 16), ((20, 24, 24), 16, 4), ((16, 16, 16), 16, 0),
    ((33, 17, 40), (16, 8, 24), (2, 0, 5))])
def test_patch_grid_matches_jax(vol, patch, overlap):
    starts = sliding.patch_grid(vol, patch, overlap)
    assert starts == jsliding.patch_grid(vol, patch, overlap)
    p = sliding.ops.triple(patch)
    np.testing.assert_array_equal(sliding.visit_counter(starts, p, vol),
                                  jsliding.visit_counter(starts, p, vol))


def test_stitch_matches_jax():
    vol = (12, 10, 14)
    starts = sliding.patch_grid(vol, (8, 6, 8), (3, 2, 2))
    preds = np.random.RandomState(0).randn(len(starts), 2, 1, 8, 6, 8, 3) \
        .astype(np.float32)
    for normalize in (True, False):
        np.testing.assert_array_equal(
            sliding.stitch_patches(torch.from_numpy(preds), starts, vol,
                                   normalize=normalize).numpy(),
            np.asarray(jsliding.stitch_patches(jnp.asarray(preds), starts,
                                               vol, normalize=normalize)))
    with pytest.raises(ValueError, match="patch"):
        sliding.grid_starts(8, 9, 0)


def test_label_helpers_match_jax():
    lab = np.random.RandomState(0).randint(0, 4, size=(5, 6, 7))
    np.testing.assert_array_equal(labels.split_label_brats(lab),
                                  jlabels.split_label_brats(lab))
    np.testing.assert_array_equal(labels.split_label_lits(lab % 3),
                                  jlabels.split_label_lits(lab % 3))
    chans = labels.split_label_brats(lab)
    for fuse in (None, "agg", "con"):
        np.testing.assert_array_equal(labels.merge_label_brats(chans, fuse),
                                      jlabels.merge_label_brats(chans, fuse))
    lits = labels.split_label_lits(lab % 3)
    for fuse in (None, "agg", "con"):
        np.testing.assert_array_equal(labels.merge_label_lits(lits, fuse),
                                      jlabels.merge_label_lits(lits, fuse))
    np.testing.assert_array_equal(labels.one_hot(lab, 4),
                                  jlabels.one_hot(lab, 4))


def test_metrics_match_jax():
    rng = np.random.RandomState(1)
    p, t = rng.randint(0, 2, (6, 7, 8)), rng.randint(0, 2, (6, 7, 8))
    for f in ("dice", "accuracy", "sensitivity", "specificity", "precision",
              "num_false_positive", "num_false_negative", "num_positive"):
        assert getattr(metrics, f)(p, t) == getattr(jmetrics, f)(p, t), f
    logits = rng.randn(2, 3, 4, 5, 6)
    target = (rng.rand(2, 3, 4, 5, 6) > 0.5).astype(np.int32)
    assert metrics.validate_vs_label(logits, target, "brats") == \
        jmetrics.validate_vs_label(logits, target, "brats")
    assert metrics.validate_vs_label(logits, target[:, 0], "lits") == \
        jmetrics.validate_vs_label(logits, target[:, 0], "lits")
    ours, theirs = metrics.SegMetricMC(3, is_cc=True), \
        jmetrics.SegMetricMC(3, is_cc=True)
    lab = rng.randint(0, 3, (4, 5, 6))
    ours.evaluate_append(logits[0], lab)
    theirs.evaluate_append(logits[0], lab)
    assert ours.get_metric() == theirs.get_metric()


@pytest.mark.parametrize("task", ["brats", "lits"])
def test_synthetic_dataset_matches_jax(task, tmp_path):
    a = synthetic.make_synthetic_dataset(str(tmp_path / "port"), task,
                                         n_subjects=3, vol_shape=(9, 10, 11),
                                         seed=4)
    b = jsynth.make_synthetic_dataset(str(tmp_path / "jax"), task,
                                      n_subjects=3, vol_shape=(9, 10, 11),
                                      seed=4)
    for root_a, root_b in zip(a, b):
        files_a = sorted(os.path.relpath(os.path.join(d, f), root_a)
                         for d, _, fs in os.walk(root_a) for f in fs)
        files_b = sorted(os.path.relpath(os.path.join(d, f), root_b)
                         for d, _, fs in os.walk(root_b) for f in fs)
        assert files_a == files_b
        for rel in files_a:
            if rel.endswith(".npy"):
                np.testing.assert_array_equal(
                    np.load(os.path.join(root_a, rel)),
                    np.load(os.path.join(root_b, rel)), err_msg=rel)
    assert synthetic.task_modalities(task) == jsynth.task_modalities(task)
