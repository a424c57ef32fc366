"""The port's quantization-aware fine-tune (``nnir.apply(train=True,
mode="fq")``, ``ptq/qat.py``) against the JAX package, on a tiny net that
JAX's ``run_ptq`` calibrated (the weights carried over with
``torch_io.from_jax_variables``), on the CPU, dropout 0.

- One fq step: the loss within rtol 1e-5 and every gradient leaf within
  atol 1e-5 + 1e-4 of its largest entry (measured: loss 2.3e-7 relative,
  gradients 9.0e-6 of the leaf's largest entry).  The fixture puts inputs
  on every tie the quantizer has: after ``run_ptq`` the extreme weight
  codes sit exactly on +-alpha_w, and a zeroed input corner with a zero
  stem bias gives relu and the activation clip inputs of exactly 0.  At
  a tie JAX passes half the gradient; ``torch.clamp`` passed all of it,
  which moved a gradient by 1.0 of its leaf's largest entry.
- ``run_qat`` for 2 epochs on the same hub data: the same kept epoch and
  val dice (within 1e-3; measured equal), the snapped kernels on their
  grids with codes equal on at least 0.99 of the weights (measured: all),
  epoch 1's loss within rtol 1e-5 (measured equal) and epoch 2's within
  rtol 1e-3 (measured 5.0e-5).  The runs part at rounding level from the
  second Adam step on, and the test does not hold them tighter: Adam's
  first step moves every weight and alpha_w by about lr, so a weight that
  sat on +-alpha_w still sits within rounding of it, where each package's
  own rounding decides whether the clip passes its gradient.  (On a
  briefly pretrained fixture this moved 3 % of the epoch-2 loss.)
- ``run_qat`` keeps the best val dice epoch, epoch 0 included, and
  marks it in ``qat_loss.txt`` (scripted dice).
- ``snap_to_grid`` leaves ``run_ptq``'s on-grid kernels as they are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu.data.datahub import DataHub as JHub
from efficientq_tpu.data.synthetic import make_synthetic_dataset
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.ptq import PTQHyperParams as JHP
from efficientq_tpu.ptq import run_ptq as jrun_ptq
from efficientq_tpu.ptq.qat import run_qat as jrun_qat
from efficientq_tpu.quant import fake_quant_weight as jfqw
from efficientq_tpu.train import losses as jlosses
from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.data.datahub import DataHub
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.ptq import fold_bn
from efficientq_tpu_torch.ptq.qat import run_qat, snap_to_grid
from efficientq_tpu_torch.quant import fake_quant_weight
from efficientq_tpu_torch.train import losses

TINY_Q = dict(num_mod=1, num_classes=3, depth_config=[1, 1, 1],
              width_config=[4, 8, 4], dilation_config=[1, 1, 1],
              init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid",
              ds="simple", ds_depth_limit=3, quantize=True, qlvl_w=4,
              qlvl_act=4, q_first=(256, -1), q_last=(256, -1))
STEM = "conv0.conv"


def _np(v):
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def calibrated():
    """JAX's run_ptq on the tiny net; the port's folded graph on the same
    calibrated variables.  One stem channel's bias is set to exactly 0."""
    cfg = UResQConfig(**TINY_Q)
    jg = jbuild(cfg)
    jv = jnnir.init(jg, jax.random.PRNGKey(0))
    x = np.random.RandomState(7).randn(1, 16, 16, 16, 1).astype(np.float32)
    jfg, jq, _ = jrun_ptq(jg, jv, jnp.asarray(x), task="lits",
                          init_stride=(2, 2, 2), hp=JHP(admm_iter=10))
    jq = _np(jq)
    jq["params"][STEM]["bias"] = jq["params"][STEM]["bias"].copy()
    jq["params"][STEM]["bias"][0] = 0.0
    g = build_uresq(cfg)
    fg, _ = fold_bn(g, nnir.init(g, 0, device="cpu"))
    assert [n.name for n in fg.nodes] == [n.name for n in jfg.nodes]
    return jfg, jq, fg


def _tie_batch():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 8, 1).astype(np.float32)
    x[:, :4, :4, :4, :] = 0.0  # the stem's output is exactly its bias
    y = rs.randint(0, 3, (2, 8, 8, 8))
    return x, y


def test_fq_step_matches_jax_at_ties(calibrated):
    jfg, jq, fg = calibrated
    x, y = _tie_batch()
    hw = jlosses.head_loss_weights(len(jfg.outputs))

    def jloss(params):
        out, _ = jnnir.apply(jfg, {"params": params, "state": {}}, x,
                             train=True, rng=jax.random.PRNGKey(0),
                             mode="fq")
        return jlosses.multi_output_loss(jlosses.get_loss("hybrid"), hw,
                                         jnp.moveaxis(out, -1, 2), y)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jq["params"])
    v = torch_io.from_jax_variables(jq, device="cpu")
    leaves = {f"{n}.{k}": t.requires_grad_()
              for n, e in v["params"].items() for k, t in e.items()}
    # the ties: weights on +-alpha_w, and exact zeros reaching the relus
    ties = 0
    for node in fg.qconv_nodes():
        p = v["params"][node.name]
        if node.attrs["qcfg"].q_weight:
            ties += int((p["kernel"].detach().abs()
                         == p["alpha_w"].detach()).sum())
    assert ties > 0
    stem = nnir.apply(fg, v, torch.from_numpy(x), heads=None,
                      capture=[STEM], mode="fq")[1][STEM]
    assert int((stem[..., 0] == 0).sum()) > 0
    out, _ = nnir.apply(fg, v, torch.from_numpy(x), train=True, mode="fq")
    total, _ = losses.multi_output_loss(
        losses.get_loss("hybrid"), losses.head_loss_weights(len(fg.outputs)),
        out.movedim(-1, 2), torch.from_numpy(y))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_loss),
                               rtol=1e-5)
    for n, e in want.items():
        for k, a in e.items():
            a = np.asarray(a)
            grad = leaves[f"{n}.{k}"].grad  # None: a leaf the loss skips
            np.testing.assert_allclose(
                np.zeros_like(a) if grad is None else grad.numpy(), a,
                rtol=0, atol=1e-5 + 1e-4 * float(np.abs(a).max()),
                err_msg=f"{n}.{k}")


def _hubs(root):
    data_dir, split_dir = make_synthetic_dataset(
        str(root), task="lits", n_subjects=6, vol_shape=(16, 16, 16))
    kw = dict(train_split=f"{split_dir}/round1/train.txt",
              val_split=f"{split_dir}/round1/val.txt",
              train_batchsize=2, test_batchsize=1, access_type="npy",
              crop_type="random", crop_size_img=(8, 8, 8),
              slide_patch_size=(8, 8, 8), slide_overlap=(2, 2, 2))
    return (DataHub(data_dir, ("seg", "ct"), **kw),
            JHub(data_dir, ("seg", "ct"), **kw))


def test_run_qat_matches_jax(calibrated, tmp_path):
    jfg, jq, fg = calibrated
    hub, jhub = _hubs(tmp_path)
    kw = dict(num_mo=len(fg.outputs), n_class=3, loss_name="hybrid",
              epochs=2, lr=3e-3)
    ours, log = run_qat(fg, torch_io.from_jax_variables(jq, device="cpu"),
                        hub, snapshot_root=str(tmp_path / "p"),
                        device="cpu", **kw)
    theirs, jlog = jrun_qat(jfg, jax.tree_util.tree_map(jnp.asarray, jq),
                            jhub, snapshot_root=str(tmp_path / "j"), **kw)
    assert log["kept_epoch"] == jlog["kept_epoch"]
    np.testing.assert_allclose(log["kept_dice"], jlog["kept_dice"],
                               atol=1e-3)
    for h, jh, rtol in zip(log["history"], jlog["history"], (1e-5, 1e-3)):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=rtol)
        np.testing.assert_allclose(h["dice"], jh["dice"], atol=1e-3)
    lines = open(tmp_path / "p" / "qat_loss.txt").read().splitlines()
    assert len(lines) == 3 and sum("<- kept" in ln for ln in lines) == 1
    theirs = _np(theirs)
    agree = total = 0
    for node in fg.qconv_nodes():
        qcfg = node.attrs["qcfg"]
        p = ours["params"][node.name]
        if not qcfg.q_weight:
            continue
        k, a = p["kernel"], p["alpha_w"]
        assert torch.equal(fake_quant_weight(k, a, qcfg.qlvl_w), k)
        codes = torch.round((k / a + 1) * (qcfg.qlvl_w - 1) / 2).numpy()
        jp = theirs["params"][node.name]
        jcodes = np.round((jp["kernel"] / jp["alpha_w"] + 1)
                          * (qcfg.qlvl_w - 1) / 2)
        agree += int((codes == jcodes).sum())
        total += codes.size
    assert agree / total >= 0.99, agree / total


@pytest.mark.parametrize("dice,kept", [((0.5, 0.7, 0.6), 1),
                                       ((0.5, 0.4, 0.45), 0)])
def test_run_qat_keeps_the_best_epoch(calibrated, tmp_path, monkeypatch,
                                      dice, kept):
    """Scripted val dice per scoring (epoch 0, 1, 2): the best epoch's
    parameters come back snapped, epoch 0 (the calibrated input) included,
    and qat_loss.txt marks it."""
    from efficientq_tpu_torch.eval import validate

    _, jq, fg = calibrated
    hub, _ = _hubs(tmp_path)
    scores = iter(dice)

    class _Metric:
        def get_metric(self):
            return {"dsc": next(scores)}

    monkeypatch.setattr(validate, "validate_seg", lambda *a, **k: [_Metric()])
    v = torch_io.from_jax_variables(jq, device="cpu")
    out, log = run_qat(fg, v, hub, num_mo=len(fg.outputs), n_class=3,
                       loss_name="ce", epochs=2, lr=3e-3,
                       snapshot_root=str(tmp_path), device="cpu")
    assert log["kept_epoch"] == kept and log["kept_dice"] == max(dice)
    lines = open(tmp_path / "qat_loss.txt").read().splitlines()
    assert [i for i, ln in enumerate(lines) if ln.endswith("<- kept")] == [
        kept]
    # epoch 0's kernels come back as calibrated (snapped again: within
    # rounding); a trained epoch's have moved
    moved = float((out["params"][STEM]["kernel"]
                   - v["params"][STEM]["kernel"]).abs().max())
    assert (moved < 1e-6) == (kept == 0), moved


def test_snap_to_grid_keeps_calibrated_kernels(calibrated):
    _, jq, fg = calibrated
    v = torch_io.from_jax_variables(jq, device="cpu")
    before = {n: dict(e) for n, e in v["params"].items()}
    snap_to_grid(fg, v)
    for node in fg.qconv_nodes():
        if node.attrs["qcfg"].q_weight:
            np.testing.assert_allclose(
                v["params"][node.name]["kernel"].numpy(),
                before[node.name]["kernel"].numpy(), atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(
                v["params"][node.name]["kernel"].numpy(),
                np.asarray(jfqw(before[node.name]["kernel"].numpy(),
                                before[node.name]["alpha_w"].numpy(),
                                node.attrs["qcfg"].qlvl_w)), atol=1e-6)
