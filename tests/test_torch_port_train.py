"""The port's FP training (``ops.batch_norm_train``, ``ops.dropout3d``,
``nnir.apply(train=True, remat=)``, ``train/losses.py``,
``train/schedule.py``, ``train/trainer.py`` and the random transforms of
``data/transforms.py``) against the JAX package, on the same NumPy inputs
and weights (carried over with ``torch_io.from_jax_variables``), on the
CPU.  Dropout is 0 wherever outputs are compared: the two packages draw
their masks from different generators by design.

Tolerances, each set from the error measured on this fixture:

- losses: rtol 1e-5 (measured at most 4.4e-7 relative);
- ``head_loss_weights`` and the schedule: equal to 1e-7 and 1e-6
  relative (the port's schedule is float64 arithmetic, JAX's float32);
- ``batch_norm_train``: output atol 1e-5, running stats rtol 1e-5
  (measured 7.2e-7 and 7.5e-8);
- one fp train step: loss rtol 1e-5, gradients atol 1e-5 + 1e-4 of each
  leaf's largest entry, new BN state rtol 1e-5 (measured: loss 1.8e-7
  relative, gradients 2.7e-6 of the leaf's largest entry, BN state
  2.6e-7);
- two ``Trainer.train_epoch`` steps: parameters and BN state within 5e-6
  (measured 1.8e-6), losses rtol 1e-5 (measured 3.3e-7);
- the ``--amp`` step (bfloat16 keeps 8 bits, and each package rounds its
  own float32 sums): the loss within 1e-3 relative (measured 6.2e-5);
  with every gradient leaf scaled by its float32 largest entry, the whole
  gradient within 0.1 relative of JAX's float32 one (measured 0.038;
  JAX's own amp gradient is 0.049 away) and each leaf within 0.25 of
  JAX's amp gradient (measured 0.18, as far as JAX's amp leaves lie from
  its float32 ones, 0.18);
- transforms: equal (the same generator calls in the same order);
- ``Tester.test_as_is``: JAX's metric file, text for text.

``Trainer.train`` writes JAX's sinks, snapshots and export and removes the
transient snapshots; ``EFFQ_PROFILE_DIR`` traces its second epoch.

In the port alone: ``remat`` equal to no remat bit for bit (output, loss,
gradients, BN state, dropout masks); dropout zeroes whole (sample,
channel) volumes and scales the survivors, the same seed giving the same
mask; ``relu`` and the quantizer's clips pass JAX's gradients at ties.
"""
import os.path as P

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientq_tpu import nnir as jnnir
from efficientq_tpu import ops as jops
from efficientq_tpu import quant as jquant
from efficientq_tpu.data import native as jnative
from efficientq_tpu.data import transforms as jT
from efficientq_tpu.data.datahub import DataHub as JHub
from efficientq_tpu.data.synthetic import make_synthetic_dataset
from efficientq_tpu.models import build_uresq as jbuild
from efficientq_tpu.train import Trainer as JTrainer
from efficientq_tpu.train import losses as jlosses
from efficientq_tpu.train import schedule as jschedule
from efficientq_tpu_torch import nnir, ops, quant
from efficientq_tpu_torch.data import transforms as T
from efficientq_tpu_torch.data.datahub import DataHub
from efficientq_tpu_torch.kernels import REFERENCES
from efficientq_tpu_torch.models import UResQConfig, build_uresq, torch_io
from efficientq_tpu_torch.train import Trainer, losses, schedule

TINY = dict(num_mod=1, num_classes=3, depth_config=[1, 1, 1],
            width_config=[4, 8, 4], dilation_config=[1, 1, 1],
            init_stride=(2, 2, 2), drop_rate=0.0, blk_type="mid",
            ds="simple", ds_depth_limit=3)


def _np(v):
    return jax.tree_util.tree_map(np.asarray, v)


def _weights(drop=0.0, seed=0):
    """The tiny net in both packages on JAX's initial weights, with BN
    scale, bias and running stats drawn from ``seed``."""
    jg = jbuild(UResQConfig(**dict(TINY, drop_rate=drop)))
    g = build_uresq(UResQConfig(**dict(TINY, drop_rate=drop)))
    jv = _np(jnnir.init(jg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(seed)
    for name, s in jv["state"].items():
        c = s["mean"].shape
        s["mean"] = (rng.randn(*c) * 0.1).astype(np.float32)
        s["var"] = (np.abs(rng.randn(*c)) * 0.2 + 0.9).astype(np.float32)
        jv["params"][name]["scale"] = (1 + 0.1 * rng.randn(*c)).astype(
            np.float32)
        jv["params"][name]["bias"] = (0.1 * rng.randn(*c)).astype(np.float32)
    return jg, g, jv


def _batch(seed=1, n=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8, 8, 8, 1).astype(np.float32)
    y = rs.randint(0, 3, (n, 8, 8, 8))
    return x, y


def _port_step(g, jv, x, y, loss="hybrid", compute_dtype=None, remat=0,
               seed=None):
    """(loss, {leaf: grad}, new state, heads) of one port forward and
    backward."""
    v = torch_io.from_jax_variables(jv, device="cpu")
    leaves = {f"{n}.{k}": t.requires_grad_()
              for n, e in v["params"].items() for k, t in e.items()}
    out, ns = nnir.apply(g, v, torch.from_numpy(x), train=True, seed=seed,
                         remat=remat, compute_dtype=compute_dtype)
    total, _ = losses.multi_output_loss(
        losses.get_loss(loss), losses.head_loss_weights(len(g.outputs)),
        out.movedim(-1, 2), torch.from_numpy(y))
    total.backward()
    grads = {k: t.grad.numpy().copy() for k, t in leaves.items()}
    state = {n: {k: s[k].numpy() for k in s} for n, s in ns.items()}
    return float(total.detach()), grads, state, out.detach()


@pytest.fixture(scope="module")
def jax_step():
    """JAX's value_and_grad over apply(train=True) + multi_output_loss,
    compiled once per (loss, compute dtype)."""
    jg, g, jv = _weights()
    cache = {}

    def run(x, y, loss="hybrid", compute_dtype=None):
        key = (loss, compute_dtype)
        if key not in cache:
            hw = jlosses.head_loss_weights(len(jg.outputs))
            fn = jlosses.get_loss(loss)

            def f(params, state, x, y):
                out, ns = jnnir.apply(jg, {"params": params, "state": state},
                                      x, train=True,
                                      rng=jax.random.PRNGKey(0),
                                      compute_dtype=compute_dtype)
                total, _ = jlosses.multi_output_loss(
                    fn, hw, jnp.moveaxis(out, -1, 2), y)
                return total, ns

            cache[key] = jax.jit(jax.value_and_grad(f, has_aux=True))
        (total, ns), grads = cache[key](jv["params"], jv["state"], x, y)
        flat = {f"{n}.{k}": np.asarray(a) for n, e in grads.items()
                for k, a in e.items()}
        return float(total), flat, _np(ns)

    return jg, g, jv, run


# ---------------------------------------------------------------------------
# losses and schedule


def _loss_inputs(name, seed=3):
    rs = np.random.RandomState(seed)
    logits = rs.randn(2, 3, 6, 5, 4).astype(np.float32) * 2
    if name in ("bce", "bdice", "bhybrid"):
        target = (rs.rand(2, 3, 6, 5, 4) > 0.6).astype(np.float32)
    else:
        target = rs.randint(0, 3, (2, 6, 5, 4))
    return logits, target


@pytest.mark.parametrize("name", sorted(losses.LOSS_REGISTRY))
def test_loss_matches_jax(name):
    logits, target = _loss_inputs(name)
    want = float(jlosses.get_loss(name)(jnp.asarray(logits),
                                        jnp.asarray(target)))
    got = float(losses.get_loss(name)(torch.from_numpy(logits),
                                      torch.from_numpy(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_adaptive_dice_and_unknown_loss():
    logits, target = _loss_inputs("dice")
    want = float(jlosses.general_dice_loss(jnp.asarray(logits),
                                           jnp.asarray(target), "adaptive"))
    got = float(losses.general_dice_loss(torch.from_numpy(logits),
                                         torch.from_numpy(target),
                                         "adaptive"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.get_loss("nope")


@pytest.mark.parametrize("num_mo", [1, 2, 3, 5])
def test_head_loss_weights_match_jax(num_mo):
    np.testing.assert_allclose(losses.head_loss_weights(num_mo).numpy(),
                               np.asarray(jlosses.head_loss_weights(num_mo)),
                               rtol=1e-7)


@pytest.mark.parametrize("warmup", ["linear", "exponential"])
def test_schedule_matches_jax(warmup):
    ours = schedule.poly_warmup_schedule(0.01, 100, 10, warmup=warmup)
    theirs = jschedule.poly_warmup_schedule(0.01, 100, 10, warmup=warmup)
    for step in (0, 9, 50, 100):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# ops


def test_batch_norm_train_matches_jax():
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 5, 6, 7, 3) * 2 + 0.5).astype(np.float32)
    scale, bias, rm, rv = (rs.rand(3).astype(np.float32) + 0.5
                           for _ in range(4))
    want = jops.batch_norm_train(*map(jnp.asarray, (x, scale, bias, rm, rv)))
    got = ops.batch_norm_train(*map(torch.from_numpy, (x, scale, bias, rm,
                                                       rv)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_dropout3d_zeroes_whole_channels_and_scales_survivors():
    x = torch.rand(3, 4, 5, 6, 16) + 0.5
    y = ops.dropout3d(x, 0.5, torch.Generator().manual_seed(11))
    flat = y.reshape(3, -1, 16)
    dropped = (flat == 0).all(dim=1)
    kept = (flat != 0).all(dim=1)
    assert bool((dropped | kept).all())
    assert 0 < int(dropped.sum()) < 48
    torch.testing.assert_close(flat[kept[:, None, :].expand_as(flat)],
                               (x.reshape(3, -1, 16) / 0.5)[
                                   kept[:, None, :].expand_as(flat)])
    again = ops.dropout3d(x, 0.5, torch.Generator().manual_seed(11))
    assert torch.equal(y, again)
    other = ops.dropout3d(x, 0.5, torch.Generator().manual_seed(12))
    assert not torch.equal(y, other)
    assert ops.dropout3d(x, 0.0, None) is x


def test_relu_gradient_at_ties_matches_jax():
    x = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jops.relu(v) * 3.0))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    (ops.relu(t) * 3.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert want[1] == 1.5  # the tie passes half


@pytest.mark.parametrize("which", ["weight", "act", "act_k_tensor"])
def test_quantizer_clip_gradients_at_bounds_match_jax(which):
    """Inputs exactly on the clip bounds (weights at +-alpha_w, activations
    at 0 and alpha_act): the gradients to the input and to alpha equal
    jax.grad's, which passes half at each tie."""
    a = np.float32(0.75)
    if which == "weight":
        x = np.array([-0.75, -0.3, 0.0, 0.75, 1.5], np.float32)
        jf = lambda v, al: jquant.fake_quant_weight(v, al, 4)
        tf = lambda v, al: quant.fake_quant_weight(v, al, 4)
    elif which == "act":
        x = np.array([-0.2, 0.0, 0.3, 0.75, 1.0], np.float32)
        jf = lambda v, al: jquant.fake_quant_act(v, al, 4)
        tf = lambda v, al: quant.fake_quant_act(v, al, 4)
    else:
        x = np.array([-0.25, 0.0, 0.3, 0.5, 1.0], np.float32)
        jf = lambda v, al: jquant.fake_quant_act_k(v, al, 4, jnp.int32(1))
        tf = lambda v, al: quant.fake_quant_act_k(
            v, al, 4, torch.tensor(1, dtype=torch.int32))
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    gx, ga = jax.grad(lambda v, al: jnp.sum(jf(v, al) * w), (0, 1))(
        jnp.asarray(x), jnp.asarray(a))
    tx = torch.from_numpy(x).requires_grad_()
    ta = torch.tensor(a).requires_grad_()
    out = tf(tx, ta)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jf(jnp.asarray(x),
                                                jnp.asarray(a))))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-6)
    np.testing.assert_allclose(float(ta.grad), float(ga), rtol=1e-5)


# ---------------------------------------------------------------------------
# one train step


def _assert_grads(got, want, rtol, atol=1e-5):
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=atol + rtol * scale, err_msg=k)


def test_fp_step_matches_jax(jax_step):
    jg, g, jv, run = jax_step
    x, y = _batch()
    want_loss, want_grads, want_state = run(x, y)
    loss, grads, state, _ = _port_step(g, jv, x, y)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads(grads, want_grads, rtol=1e-4)
    assert set(state) == set(want_state)
    for n in want_state:
        for k in ("mean", "var"):
            np.testing.assert_allclose(state[n][k], want_state[n][k],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{n}.{k}")


def test_amp_step_matches_jax(jax_step):
    jg, g, jv, run = jax_step
    x, y = _batch(seed=5)
    want_loss, want_grads, _ = run(x, y, compute_dtype=jnp.bfloat16)
    _, f32_grads, _ = run(x, y)
    loss, grads, state, out = _port_step(g, jv, x, y,
                                         compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3)
    _assert_grads(grads, want_grads, rtol=0.25)

    def flat(d):
        return np.concatenate([d[k].ravel() / np.abs(f32_grads[k]).max()
                               for k in sorted(f32_grads)])

    ref = flat(f32_grads)
    assert np.linalg.norm(flat(grads) - ref) / np.linalg.norm(ref) < 0.1
    # the running stats stay float32
    assert all(s["mean"].dtype == np.float32 for s in state.values())


def test_remat_equals_plain_with_dropout():
    """remat=4 against remat=0 at dropout 0.5: the heads, the loss, every
    gradient, the BN state, and so the dropout masks, bit for bit."""
    jg, g, jv = _weights(drop=0.5)
    assert any(n.op == "dropout" for n in g.nodes)
    x, y = _batch(seed=6)
    ref = _port_step(g, jv, x, y, seed=42)
    rem = _port_step(g, jv, x, y, seed=42, remat=4)
    assert ref[0] == rem[0]
    assert torch.equal(ref[3], rem[3])
    for k in ref[1]:
        np.testing.assert_array_equal(ref[1][k], rem[1][k], err_msg=k)
    for n in ref[2]:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(ref[2][n][k], rem[2][n][k])
    other = _port_step(g, jv, x, y, seed=43)
    assert not torch.equal(ref[3], other[3])


@pytest.mark.parametrize("n", [1, 5])
def test_remat_inference_exact(n):
    """The segmented forward without a backward gives the plain training
    forward's heads and running stats bit for bit.  remat is refused
    outside train mode, as are kernel hooks in it."""
    jg, g, jv = _weights()
    v = torch_io.from_jax_variables(jv, device="cpu")
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        ref, ref_state = nnir.apply(g, v, x, train=True)
        out, state = nnir.apply(g, v, x, train=True, remat=n)
    assert torch.equal(ref, out)
    assert ref_state.keys() == state.keys() and ref_state
    for name in ref_state:
        for k in ("mean", "var"):
            assert torch.equal(ref_state[name][k], state[name][k])
    with pytest.raises(ValueError, match="remat"):
        nnir.apply(g, v, x, remat=-1)
    with pytest.raises(ValueError, match="train=True"):
        nnir.apply(g, v, x, remat=n)
    with pytest.raises(ValueError, match="hooks"):
        nnir.apply(g, v, x, train=True, kernels=REFERENCES)
    with pytest.raises(ValueError, match="hooks"):
        nnir.apply(g, v, x, train=True, conv3x3_int8=lambda *a, **k: None)


def test_train_mode_needs_a_seed_for_dropout():
    jg, g, jv = _weights(drop=0.5)
    v = torch_io.from_jax_variables(jv, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        nnir.apply(g, v, torch.from_numpy(_batch()[0]), train=True)


# ---------------------------------------------------------------------------
# the Trainer


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


def test_trainer_two_steps_match_jax(tmp_path):
    """Two Trainer.train_epoch steps (3 train volumes at batch 2, random
    crops and flips from the same seed): the parameters after Adam, the BN
    state and the epoch's losses agree with JAX's Trainer."""
    jg, g, jv = _weights()
    hub, jhub = _hubs(tmp_path)
    kw = dict(loss_name="hybrid", num_mo=len(g.outputs), n_class=3,
              base_lr=0.01, max_epoch=2, test_interval=100)
    tr = Trainer(g, torch_io.from_jax_variables(jv, device="cpu"), hub,
                 snapshot_root=str(tmp_path / "p"), device="cpu", **kw)
    jtr = JTrainer(jg, jax.tree_util.tree_map(jnp.asarray, jv), jhub,
                   snapshot_root=str(tmp_path / "j"), **kw)
    got, want = tr.train_epoch(), jtr.train_epoch()
    assert tr.step_idx == jtr.step_idx == 2
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    jp = _np(jtr.variables)
    for group in ("params", "state"):
        for n, e in jp[group].items():
            for k, a in e.items():
                np.testing.assert_allclose(
                    tr.variables[group][n][k].detach().numpy(), a,
                    atol=5e-6, err_msg=f"{group} {n}.{k}")
    np.testing.assert_allclose(tr.current_lr(), jtr.current_lr(), rtol=1e-6)


def test_trainer_snapshot_resume_and_final_snap(tmp_path):
    """A snapshot holds JAX's keys; resume restores weights, Adam moments,
    step and epoch; the next step equals the uninterrupted run's."""
    jg, g, jv = _weights()
    hub, _ = _hubs(tmp_path)
    kw = dict(loss_name="ce", num_mo=len(g.outputs), n_class=3,
              base_lr=0.01, max_epoch=3, device="cpu")
    a = Trainer(g, torch_io.from_jax_variables(jv, device="cpu"), hub,
                snapshot_root=str(tmp_path / "a"), **kw)
    a.train_epoch()
    a.epoch = 1
    path = a.snapshot(1, "latest")
    import pickle

    payload = pickle.load(open(path, "rb"))
    assert set(payload) == {"epoch", "state_dict", "opt_state", "step_idx",
                            "max_metric"}
    assert all(type(v) is np.ndarray for v in payload["state_dict"].values())
    b = Trainer(g, torch_io.from_jax_variables(jv, device="cpu"), hub,
                snapshot_root=str(tmp_path / "b"), **kw)
    b.resume(path)
    assert (b.step_idx, b.start_epoch) == (a.step_idx, 2)
    x, y = _batch(seed=8)
    y = torch.from_numpy(y)
    x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))
    la, _ = a.train_step(x, y)
    lb, _ = b.train_step(x, y)
    assert float(la) == float(lb)
    for name, t in a._leaves.items():
        assert torch.equal(t, b._leaves[name]), name
    a.final_snap("FP")
    sd = np.load(str(tmp_path / "a" / "state_FP.npz"),
                 allow_pickle=True)["state_dict"].item()
    assert set(sd) == set(payload["state_dict"])


# ---------------------------------------------------------------------------
# the random transforms


def _volume(seed=0, c=2, shape=(20, 18, 16)):
    rs = np.random.RandomState(seed)
    img = rs.randn(c, *shape).astype(np.float32)
    label = np.zeros(shape, np.int64)
    label[5:9, 4:10, 6:9] = 1
    label[6:8, 5:7, 7:8] = 2
    return img, label


TRANSFORMS = {
    "center": lambda m, g: m.CenterCrop((8, 10, 12)),
    "random_crop": lambda m, g: m.RandomCrop((8, 10, 12), rng=g),
    "balance": lambda m, g: m.BalanceCrop(0.5, (8, 8, 8), None,
                                          lambda lab: lab == 2, rng=g),
    "flip": lambda m, g: m.RandomFlip((1, 1, 1), rng=g),
    "scale_crop": lambda m, g: m.RandomScaleCrop(0.8, 1.3, (8, 10, 12), 1,
                                                 0.7, rng=g),
    "scale_crop_order3": lambda m, g: m.RandomScaleCrop(0.8, 1.3, (8, 8, 8),
                                                        3, 0.7, rng=g),
    "noise": lambda m, g: m.RandomNoise(0.7, 0.3, rng=g),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_random_transform_matches_jax(name, monkeypatch):
    """Ten draws from equal generators give equal outputs.  JAX's
    BalanceCrop takes its NumPy sampler (its native library is switched
    off for the test; nothing in the JAX package changes)."""
    monkeypatch.setattr(jnative, "_LIB", False)
    ours = TRANSFORMS[name](T, np.random.default_rng(7))
    theirs = TRANSFORMS[name](jT, np.random.default_rng(7))
    for i in range(10):
        img, label = _volume(seed=i)
        a, b = ours(img, label), theirs(img, label)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


TRAIN_CROPS = {
    "balance": dict(crop_type="balance", balance_rate=0.5,
                    balance_mask_func=lambda lab: lab == 2),
    "scale": dict(crop_type="random", scale_bound=(0.8, 1.2), scale_order=1),
    "center": dict(crop_type="center"),
}


@pytest.mark.parametrize("crop", sorted(TRAIN_CROPS))
def test_datahub_train_loader_matches_jax(crop, tmp_path, monkeypatch):
    """The train loaders of both hubs, each crop the CLI reaches with
    noise and flips, give equal batches over two epochs."""
    monkeypatch.setattr(jnative, "_LIB", False)
    data_dir, split_dir = make_synthetic_dataset(
        str(tmp_path), task="lits", n_subjects=6, vol_shape=(16, 16, 16))
    kw = dict(train_split=f"{split_dir}/round1/train.txt",
              train_batchsize=2, access_type="npy", crop_size_img=(8, 8, 8),
              random_noise_prob=0.5, num_workers=2, **TRAIN_CROPS[crop])
    ours = DataHub(data_dir, ("seg", "ct"), **kw)
    theirs = JHub(data_dir, ("seg", "ct"), **kw)
    assert len(ours.trainloader) == len(theirs.trainloader) == 2
    for _ in range(2):
        for (a, la), (b, lb) in zip(ours.trainloader, theirs.trainloader):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
    # the calibration's fixed transform leaves the train loader cropping
    ours.trainseqloader.dataset.use_fix_transform()
    assert next(iter(ours.trainloader))[0].shape[-3:] == (8, 8, 8)


def test_trainer_train_writes_the_sinks(tmp_path, monkeypatch):
    """Trainer.train over 2 epochs with validation each epoch: JAX's sinks,
    the final snapshot and export, the transient snapshots removed, and an
    EFFQ_PROFILE_DIR trace of the second epoch."""
    jg, g, jv = _weights()
    hub, _ = _hubs(tmp_path)
    monkeypatch.setenv("EFFQ_PROFILE_DIR", str(tmp_path / "prof"))
    root = tmp_path / "run"
    tr = Trainer(g, torch_io.from_jax_variables(jv, device="cpu"), hub,
                 loss_name="ce", num_mo=len(g.outputs), n_class=3,
                 base_lr=0.01, max_epoch=2, snapshot_root=str(root),
                 test_interval=1, display_interval=1, device="cpu")
    tr.train()
    assert sorted(p.name for p in root.iterdir()) == [
        "description.txt", "loss.txt", "seg_metric.txt", "state_0002.pkl",
        "state_FP.npz"]
    assert [ln.split(",")[0] for ln in
            (root / "loss.txt").read_text().splitlines()] == ["1", "2"]
    assert [ln.split(",")[0] for ln in
            (root / "seg_metric.txt").read_text().splitlines()] == ["1", "2"]
    assert (tmp_path / "prof" / "train_epoch.json").is_file()
    assert tr.step_idx == 4 and set(tr.seconds) >= {
        "data", "steps", "validation", "snapshots"}


def test_tester_matches_jax(tmp_path):
    """Tester.test_as_is on the same weights writes JAX's per-split metric
    files (the val split here) with the same numbers; snapshot writes both
    formats."""
    from efficientq_tpu.train.tester import Tester as JTester
    from efficientq_tpu_torch.train import Tester

    jg, g, jv = _weights()
    hub, jhub = _hubs(tmp_path)
    ours = Tester(g, torch_io.from_jax_variables(jv, device="cpu"), hub, 2,
                  3, str(tmp_path / "p"), device="cpu")
    theirs = JTester(jg, jax.tree_util.tree_map(jnp.asarray, jv), jhub, 2,
                     3, str(tmp_path / "j"))
    ours.test_as_is()
    theirs.test_as_is()
    a, b = ((tmp_path / d / "test_as_is" / "val_seg.txt").read_text()
            for d in ("p", "j"))
    assert a == b
    for compress in (False, True):
        path = ours.snapshot("w", compress=compress)
        assert P.isfile(path if not compress else path + ".npz")
