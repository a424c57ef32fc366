"""The port's CLI (``python -m efficientq_tpu_torch
{train_fp,ptq,infer}``) against the JAX package's (``efficientq_tpu/cli``),
on the tiny model of tests/test_cli_e2e.py, on the CPU
(``EFFQ_PLATFORM=cpu``).

- Parsing: both parsers accept the same argv lists and give equal
  namespaces; the port's flat YAML reader (the only one it uses) equals
  ``yaml.safe_load`` on every ``config/*.yaml``
  (tests/test_torch_port_data.py).
- ``ptq`` in both packages on one random-weight pickle (BN state
  randomised): the artifact file sets are equal, ``class_voxel_nums.txt``
  is equal, weight codes are equal on >= 0.99 and layer losses within rtol
  1e-2 (tests/test_torch_port_ptq.py's tolerances for ``run_ptq``).  The
  calibration crop is the whole 32^3 volume: at a 16^3 crop the stage-2
  Grams are rank-deficient (128 voxels for 217 unknowns) and JAX's ADMM
  loss is NaN at every iteration of that layer, so JAX keeps its float
  kernel at alpha_w = 1 (ROADMAP queue 3); the port's behaviour there is
  held on its own below.
- The exports interchange: each package's ``infer --deploy int8`` on
  either package's ``state_in_int8.pkl`` agrees with the other package's
  on the same file at tests/test_torch_port_serving.py's level (hard
  predictions on >= 99.99 % of voxels, the metrics equal where the
  predictions are).
- The PTQ extension flags are held in
  tests/test_torch_port_cli_extensions.py.
- Without ``--lwq_patchsz`` a volume axis under 64 voxels raises a
  ``ValueError`` naming the axis, on both calibration paths.
- ``train_fp`` in both packages from one pretrain pickle, and ``ptq
  --qat_epochs 1`` in both on the port's training snapshot, within the
  tolerances their tests state; each package reads the other's training
  snapshot.
- Every unported flag (the multi-device ones) raises
  ``NotImplementedError`` naming its ROADMAP item (``--ckpt_backend
  orbax`` a ``ValueError``), and the CLI without a card and without
  ``EFFQ_PLATFORM=cpu`` raises.  The serving flags are held in
  tests/test_torch_port_serving_cli.py.
"""
import glob
import json
import os
import os.path as P
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from efficientq_tpu.cli import entrance as jentrance
from efficientq_tpu.data.synthetic import make_synthetic_dataset
from efficientq_tpu.models import torch_io as jtorch_io
from efficientq_tpu import nnir as jnnir
from efficientq_tpu_torch import nnir
from efficientq_tpu_torch.cli import definer, entrance
from efficientq_tpu_torch.models import build_uresq, torch_io
from efficientq_tpu_torch.ptq import PTQHyperParams, run_ptq
from efficientq_tpu_torch.utils.nifti import load_nifti

REPO = P.dirname(P.dirname(P.abspath(__file__)))

TINY_MODEL = [
    "--width", "4,8,4", "--depth", "1,1,1", "--dilation", "1,1,1",
    "--init_stride", "2,2,1", "--blk", "mid", "--ds", "simple",
    "--hetero_dim", "--drop_rate", "0.0", "--nMod", "1", "--nClass", "3",
]
QUANT = ["--qconv", "effq", "--qlvl_w", "4", "--qlvl_a", "4",
         "--q_first", "256,-1", "--q_last", "256,-1"]
VOL = (32, 32, 32)


def _data_args(data_dir, split_dir):
    return ["--task", "lits", "--data_dir", data_dir, "--split_dir",
            split_dir, "--round", "1", "--patch_size", "16,16,16",
            "--access_type", "npy", *QUANT, *TINY_MODEL]


def _random_pretrain(path):
    """The tiny model's weights from a seed with BN state randomised (as
    tests/test_ptq_e2e.py draws it), as a {'state_dict': ...} pickle."""
    args = jentrance.build_parser().parse_args(
        ["ptq", "--task", "lits", *QUANT, *TINY_MODEL])
    graph = build_uresq(definer.get_model_config(args)[0])
    v = nnir.init(graph, 0, device="cpu")
    rng = np.random.RandomState(0)
    for s in v["state"].values():
        s["mean"] = torch.from_numpy(
            rng.randn(*s["mean"].shape).astype(np.float32) * 0.1)
        s["var"] = torch.from_numpy(
            (np.abs(rng.randn(*s["var"].shape)) * 0.2 + 0.9)
            .astype(np.float32))
    with open(path, "wb") as f:
        pickle.dump({"state_dict": torch_io.to_torch_state_dict(graph, v)},
                    f)
    return graph, v


def _files(root):
    """The files of a snapshot but cmd.txt, and the port's toolchain.json
    (its toolchain fingerprint, which the JAX mission does not write)."""
    return sorted(P.relpath(P.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f not in ("cmd.txt", "toolchain.json"))


@pytest.fixture(scope="module")
def missions(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_cli"))
    data_dir, split_dir = make_synthetic_dataset(
        root, task="lits", n_subjects=4, vol_shape=VOL)
    ckpt = P.join(root, "pretrain.pkl")
    _random_pretrain(ckpt)
    cwd = os.getcwd()
    os.chdir(root)
    saved = os.environ.get("EFFQ_PLATFORM")
    os.environ["EFFQ_PLATFORM"] = "cpu"
    try:
        base = _data_args(data_dir, split_dir)
        ptq_args = ["ptq", *base, "--pretrain", ckpt, "--lwq_patchsz",
                    "32,32,32", "--lwq_iter", "40", "--true_test",
                    "--save_nii", "--is_cc"]
        out = {"port_ptq": entrance.main(ptq_args + ["--suffix", "port"])[0],
               "jax_ptq": jentrance.main(ptq_args + ["--suffix", "jax"])}
        infer = ["infer", *base, "--deploy", "int8", "--save_nii"]
        jexport = P.join(out["jax_ptq"], "state_in_int8.pkl")
        pexport = P.join(out["port_ptq"], "state_in_int8.pkl")
        out["port_infer"] = entrance.main(
            infer + ["--pretrain", jexport, "--suffix", "pj"])[0]
        out["jax_infer"] = jentrance.main(
            infer + ["--pretrain", jexport, "--suffix", "jj"])
        out["jax_infer_port_export"] = jentrance.main(
            infer + ["--pretrain", pexport, "--suffix", "jp"])
        out["port_infer_port_export"] = entrance.main(
            infer + ["--pretrain", pexport, "--suffix", "pp"])[0]
    finally:
        os.chdir(cwd)
        if saved is None:
            os.environ.pop("EFFQ_PLATFORM", None)
        else:
            os.environ["EFFQ_PLATFORM"] = saved
    return out


ARGVS = [
    ["ptq", "--qlvl_w", "4", "--qlvl_a", "4", "--round", "1",
     "--q_first", "256,-1"],
    ["ptq", "--qlvl_w", "4", "--qlvl_a", "4", "--round", "1", "--config",
     "config/brats_ptq.yaml", "--pretrain", "x.pkl", "--data_dir", "d",
     "--split_dir", "s", "--true_test", "--save_nii"],
    ["infer", "--deploy", "mixed", "--serve_stem", "s2d", "--serve_dtype",
     "bf16", "--pretrain", "e.pkl", "--patch_batch", "4", "--device", "1"],
    ["train_fp", "--lr", "0.01", "--max_epoch", "3", "--amp", "--remat", "2",
     "--mesh_shape", "2,4", "--fsdp", "--ckpt_backend", "orbax"],
    ["ptq", "--lwq_select", "4", "--mixed_frac", "0.25", "--mixed_tail",
     "off", "--act_offset", "1", "--act_offset_scope", "all",
     "--tail_alpha_sweep", "--tail_alpha_factors", "1,2", "--tune_act", "3",
     "--qat_epochs", "2", "--qat_lr", "1e-3", "--lwq_granularity", "block",
     "--channel_wise", "--bias_corr", "--is_cc", "--export_artifact",
     "--serve_grid", "column", "--export_column_depth", "155",
     "--tune_serving", "off", "--dp_devices", "-1", "--distributed",
     "--overlap", "8,8,8", "--da_scaling", "0.7,1.4", "--scal_order", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parser_matches_jax(argv):
    ours = entrance.build_parser().parse_args(argv)
    theirs = jentrance.build_parser().parse_args(argv)
    assert vars(ours) == vars(theirs)


def test_parser_defaults_match_jax():
    ours, theirs = entrance.build_parser(), jentrance.build_parser()
    assert [a.dest for a in ours._actions] == \
        [a.dest for a in theirs._actions]
    for a, b in zip(ours._actions, theirs._actions):
        assert (a.default, a.choices, a.type, a.option_strings) == \
            (b.default, b.choices, b.type, b.option_strings), a.dest


def test_merge_config_matches_jax():
    argv = ["ptq", "--task", "lits", "--batch_size", "2", "--config",
            P.join(REPO, "config", "brats_ptq.yaml")]
    ours = entrance.merge_config(argv[-1],
                                 entrance.build_parser().parse_args(argv))
    theirs = jentrance.merge_config(
        argv[-1], jentrance.build_parser().parse_args(argv))
    assert vars(ours) == vars(theirs)
    assert ours.task == "brats" and ours.batch_size == 4  # YAML wins


def test_ptq_artifact_files_match_jax(missions):
    port, jax_ = missions["port_ptq"], missions["jax_ptq"]
    assert _files(port) == _files(jax_)
    for name in ("cmd.txt", "time_cost.txt", "layer_loss.txt",
                 "layer_loss_curve.npz", "class_voxel_nums.txt",
                 "Qseg0.nii.gz", "FPseg0.nii.gz", "state_in_fp.pkl",
                 "state_in_int8.pkl", "state_in_int8_compress.npz",
                 "ptq/val_seg.txt", "ptq/test_seg.txt"):
        assert P.isfile(P.join(port, name)), name
    assert glob.glob(P.join(port, "ptq", "true_test", "*.nii.gz"))
    with open(P.join(port, "toolchain.json")) as f:
        assert json.load(f)["torch"] == torch.__version__
    with open(P.join(port, "class_voxel_nums.txt")) as a, \
            open(P.join(jax_, "class_voxel_nums.txt")) as b:
        assert a.read() == b.read()


def _losses(snap):
    with open(P.join(snap, "layer_loss.txt")) as f:
        return [(n.strip(), float(v)) for n, v in
                (line.rsplit(":", 1) for line in f.read().splitlines())]


def test_ptq_layer_losses_match_jax(missions):
    port, jax_ = (_losses(missions[k]) for k in ("port_ptq", "jax_ptq"))
    assert [n for n, _ in port] == [n for n, _ in jax_] and len(port) == 10
    for (name, lp), (_, lj) in zip(port, jax_):
        assert np.isfinite(lp)
        np.testing.assert_allclose(lp, lj, rtol=1e-2, err_msg=name)
    curves = np.load(P.join(missions["port_ptq"], "layer_loss_curve.npz"))
    jcurves = np.load(P.join(missions["jax_ptq"], "layer_loss_curve.npz"))
    assert sorted(curves.files) == sorted(jcurves.files)
    assert all(curves[k].shape == jcurves[k].shape for k in curves.files)


def _state(snap, name):
    with open(P.join(snap, name), "rb") as f:
        return pickle.load(f)["state_dict"]


def test_ptq_exports_match_jax(missions):
    """The same keys, NumPy arrays only (no torch tensors), the same
    ``__qlvl_overrides__``, and weight codes equal on >= 0.99."""
    for name in ("state_in_fp.pkl", "state_in_int8.pkl"):
        port = _state(missions["port_ptq"], name)
        jax_ = _state(missions["jax_ptq"], name)
        assert set(port) == set(jax_)
        assert port["__qlvl_overrides__"] == jax_["__qlvl_overrides__"]
        for k, v in port.items():
            if k != "__qlvl_overrides__":
                assert type(v) is np.ndarray, k
                assert v.dtype == np.asarray(jax_[k]).dtype, k
    port = _state(missions["port_ptq"], "state_in_int8.pkl")
    jax_ = _state(missions["jax_ptq"], "state_in_int8.pkl")
    npz = np.load(P.join(missions["port_ptq"], "state_in_int8_compress.npz"),
                  allow_pickle=True)["state_dict"].item()
    same = total = 0
    for k, v in port.items():
        if k.endswith(".weight") and v.dtype == np.uint8:
            same += int((v == jax_[k]).sum())
            total += v.size
            np.testing.assert_array_equal(npz[k], v)
    assert total and same / total >= 0.99, same / total


def _dsc_rows(path):
    """{subject: the final head's per-subject metric row} of a
    ``*_seg.txt``."""
    with open(path) as f:
        lines = f.read().splitlines()
    rows, head = {}, None
    for line in lines:
        if line.startswith("Output"):
            head = line
        elif line.startswith("|") and "SN" not in line and head == \
                "Output -1:":
            cells = [c.strip() for c in line.strip("|").split("|")]
            rows[cells[0]] = [float(c) for c in cells[1:]]
    return rows


def _serving_agrees(port, jax_):
    """Two infer snapshots of one export, the port's and JAX's: the hard
    predictions (NIfTI) agree on >= 99.99 % of voxels, and each subject's
    metrics are equal where its prediction is."""
    assert _files(port) == _files(jax_)
    for split in ("val", "test"):
        rows_p = _dsc_rows(P.join(port, "infer", f"{split}_seg.txt"))
        rows_j = _dsc_rows(P.join(jax_, "infer", f"{split}_seg.txt"))
        assert rows_p.keys() == rows_j.keys() and rows_p
        for sn in rows_p:
            a = load_nifti(P.join(port, "infer", split, f"{sn}.nii.gz"))
            b = load_nifti(P.join(jax_, "infer", split, f"{sn}.nii.gz"))
            pa, pb = np.asarray(a.dataobj), np.asarray(b.dataobj)
            assert pa.shape == pb.shape == VOL
            assert np.mean(pa == pb) >= 0.9999
            if np.array_equal(pa, pb):
                assert rows_p[sn] == rows_j[sn]
            assert all(np.isfinite(rows_p[sn]))
            assert all(np.isfinite(rows_j[sn]))


def test_infer_on_jax_export_matches_jax(missions):
    """The port's ``infer --deploy int8`` on JAX's export against JAX's
    own."""
    _serving_agrees(missions["port_infer"], missions["jax_infer"])


def test_jax_infer_serves_port_export(missions):
    """JAX's ``infer --deploy int8`` on the port's export against the
    port's own."""
    _serving_agrees(missions["port_infer_port_export"],
                    missions["jax_infer_port_export"])


def test_port_calibrates_rank_deficient_layers(tmp_path):
    """At a 16^3 calibration crop the tiny model's stage-2 Grams are
    rank-deficient; JAX's ADMM loss is NaN at every iteration there and it
    keeps the float kernel (ROADMAP queue 3).  The port's ADMM stays
    finite and every weight-quantized kernel lands on its grid."""
    graph, v = _random_pretrain(str(tmp_path / "w.pkl"))
    x = np.random.RandomState(3).rand(1, 16, 16, 16, 1).astype(np.float32)
    fg, qv, rep = run_ptq(graph, v, x, task="lits", init_stride=(2, 2, 1),
                          hp=PTQHyperParams(admm_iter=10), device="cpu")
    for name, hist in rep.layer_histories.items():
        assert torch.isfinite(hist["loss"]).all(), name
    for node in fg.qconv_nodes():
        q, p = node.attrs["qcfg"], qv["params"][node.name]
        if q.q_weight:
            a = float(p["alpha_w"])
            t = (p["kernel"].double() / a + 1) * (q.qlvl_w - 1) / 2
            assert a != 1.0 and float((t - t.round()).abs().max()) < 1e-4


def _lines(snap, name):
    with open(P.join(snap, name)) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("flags", [[], ["--lwq_select", "2"]],
                         ids=["batch", "per_volume"])
def test_calibration_crop_under_64_raises(flags, monkeypatch, tmp_path):
    """A 48-voxel axis without --lwq_patchsz: the crop rule would give it 0
    voxels (JAX calibrates the empty crop into NaN losses); the port
    raises a ValueError naming the axis and --lwq_patchsz, before any
    calibration, on the batch and the per-volume path."""
    monkeypatch.setenv("EFFQ_PLATFORM", "cpu")
    data_dir, split_dir = make_synthetic_dataset(
        str(tmp_path), task="lits", n_subjects=4, vol_shape=(64, 48, 64))
    _random_pretrain(str(tmp_path / "w.pkl"))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=r"axis 1 .*48 voxels.*--lwq_patchsz"):
        entrance.main(["ptq", *_data_args(data_dir, split_dir),
                       "--pretrain", str(tmp_path / "w.pkl"), *flags])
    assert not glob.glob(str(tmp_path / "exp_ptq" / "**" / "layer_loss.txt"),
                         recursive=True)


REFUSED = [
    ("ptq", ["--dp_devices", "2"], "item 9"),
    ("ptq", ["--mesh_shape", "1,2"], "item 9"),
    ("ptq", ["--distributed"], "item 9"),
    ("infer", ["--dp_devices", "2"], "item 9"),
    ("infer", ["--mesh_shape", "1,2"], "item 9"),
    ("infer", ["--distributed"], "item 9"),
    ("train_fp", ["--dp_devices", "2"], "item 9"),
    ("train_fp", ["--mesh_shape", "1,2"], "item 9"),
    ("train_fp", ["--fsdp"], "item 9"),
    ("train_fp", ["--distributed"], "item 9"),
]


@pytest.mark.parametrize("mission,flags,item", REFUSED,
                         ids=[f"{m}{''.join(f)}" for m, f, _ in REFUSED])
def test_unported_flags_raise(mission, flags, item, monkeypatch, tmp_path):
    monkeypatch.setenv("EFFQ_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        entrance.main([mission, "--task", "lits", "--pretrain", "x.pkl",
                       *QUANT, *TINY_MODEL, *flags])
    assert not os.listdir(tmp_path)  # refused before any work


def test_orbax_backend_raises(monkeypatch, tmp_path):
    """``--ckpt_backend orbax`` is the JAX package's format: train_fp
    refuses it with a ValueError before any work."""
    monkeypatch.setenv("EFFQ_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="pickle"):
        entrance.main(["train_fp", "--task", "lits", *TINY_MODEL,
                       "--ckpt_backend", "orbax"])
    assert not os.listdir(tmp_path)


def test_cli_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("EFFQ_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="EFFQ_PLATFORM=cpu"):
        entrance.main(["ptq", "--task", "lits", "--pretrain", "x.pkl",
                       *QUANT, *TINY_MODEL])
    assert not os.listdir(tmp_path)


def test_train_fp_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("EFFQ_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="EFFQ_PLATFORM=cpu"):
        entrance.main(["train_fp", "--task", "lits", *TINY_MODEL])
    assert not os.listdir(tmp_path)


def test_module_entry_point_refuses_without_a_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "EFFQ_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "efficientq_tpu_torch", "infer",
                        "--task", "lits", "--pretrain", "x.pkl"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "EFFQ_PLATFORM=cpu" in r.stderr
    assert not os.listdir(tmp_path)


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """A torch-serialized checkpoint and a plain pickle, with and without
    {'state_dict': ...}, load to the same weights in both packages."""
    args = jentrance.build_parser().parse_args(
        ["ptq", "--task", "lits", *QUANT, *TINY_MODEL])
    graph, v = _random_pretrain(str(tmp_path / "w.pkl"))
    sd = torch_io.to_torch_state_dict(graph, v)
    from efficientq_tpu.cli import definer as jdefiner
    from efficientq_tpu.models import build_uresq as jbuild

    jg = jbuild(jdefiner.get_model_config(args)[0])
    jv0 = jnnir.init(jg, jax.random.PRNGKey(1))
    for i, (wrap, save) in enumerate([
            (True, "pickle"), (False, "pickle"), (True, "torch"),
            (False, "torch")]):
        obj = {"state_dict": sd} if wrap else dict(sd)
        path = str(tmp_path / f"c{i}.pt")
        if save == "torch":
            torch.save({k: torch.from_numpy(np.asarray(a))
                        for k, a in sd.items()} if not wrap else
                       {"state_dict": {k: torch.from_numpy(np.asarray(a))
                                       for k, a in sd.items()}}, path)
        else:
            with open(path, "wb") as f:
                pickle.dump(obj, f)
        ours = torch_io.load_torch_checkpoint(
            graph, nnir.init(graph, 1, device="cpu"), path)
        theirs = jtorch_io.load_torch_checkpoint(jg, jv0, path)
        for group in ("params", "state"):
            for node, entries in ours[group].items():
                for k, t in entries.items():
                    np.testing.assert_array_equal(
                        t.numpy(), np.asarray(theirs[group][node][k]),
                        err_msg=f"{save} {wrap} {node}.{k}")
                    np.testing.assert_array_equal(
                        t.numpy(), v[group][node][k].numpy())


# ---------------------------------------------------------------------------
# train_fp and ptq --qat_epochs


def _fp_pretrain(path):
    """The tiny FP net's weights from a seed, BN state randomised, as a
    {'state_dict': ...} pickle."""
    args = jentrance.build_parser().parse_args(
        ["train_fp", "--task", "lits", *TINY_MODEL])
    graph = build_uresq(definer.get_model_config(args)[0])
    v = nnir.init(graph, 3, device="cpu")
    rng = np.random.RandomState(1)
    for s in v["state"].values():
        s["mean"] = torch.from_numpy(
            rng.randn(*s["mean"].shape).astype(np.float32) * 0.1)
        s["var"] = torch.from_numpy(
            (np.abs(rng.randn(*s["var"].shape)) * 0.2 + 0.9)
            .astype(np.float32))
    with open(path, "wb") as f:
        pickle.dump({"state_dict": torch_io.to_torch_state_dict(graph, v)},
                    f)


def _own_train_dataset(get_data_cube):
    """JAX's get_data_cube with the train loader reading its own shallow
    copy of the train-seq dataset, as the port's DataHub builds it: in the
    JAX package the calibration's use_fix_transform would otherwise switch
    the QAT train loader to whole, uncropped volumes (ROADMAP queue 3)."""
    import copy

    def wrapped(args):
        out = get_data_cube(args)
        loader = out[0].trainloader
        loader = getattr(loader, "loader", loader)  # inside PrefetchLoader
        loader.dataset = copy.copy(loader.dataset)
        return out

    return wrapped


@pytest.fixture(scope="module")
def training_missions(tmp_path_factory):
    """``train_fp`` in both packages from one pretrain pickle (2 epochs of
    one batch-2 step, online validation at both)."""
    root = str(tmp_path_factory.mktemp("port_cli_train"))
    data_dir, split_dir = make_synthetic_dataset(
        root, task="lits", n_subjects=4, vol_shape=VOL)
    ckpt = P.join(root, "fp_pretrain.pkl")
    _fp_pretrain(ckpt)
    cwd = os.getcwd()
    os.chdir(root)
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("EFFQ_PLATFORM", "cpu")
            train = ["train_fp", "--task", "lits", "--data_dir", data_dir,
                     "--split_dir", split_dir, "--round", "1",
                     "--patch_size", "16,16,16", "--access_type", "npy",
                     *TINY_MODEL, "--pretrain", ckpt, "--batch_size", "2",
                     "--crop_type", "random", "--loss", "hybrid", "--lr",
                     "0.01", "--max_epoch", "2", "--test_interval", "2",
                     "--disp_interval", "1"]
            out["port_train"] = entrance.main(train + ["--suffix", "p"])[0]
            out["jax_train"] = jentrance.main(train + ["--suffix", "j"])
    finally:
        os.chdir(cwd)
    out.update(root=root, data_dir=data_dir, split_dir=split_dir)
    return out


@pytest.fixture(scope="module")
def qat_missions(training_missions):
    """``ptq --qat_epochs 1`` in both packages on the port's
    ``state_0002.pkl`` (JAX's ptq reading the port's training snapshot)."""
    from efficientq_tpu.cli import definer as jdefiner

    t = training_missions
    cwd = os.getcwd()
    os.chdir(t["root"])
    out = {}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("EFFQ_PLATFORM", "cpu")
            mp.setattr(jdefiner, "get_data_cube",
                       _own_train_dataset(jdefiner.get_data_cube))
            qat = ["ptq", *_data_args(t["data_dir"], t["split_dir"]),
                   "--lwq_patchsz", "32,32,32", "--lwq_iter", "40",
                   "--qat_epochs", "1", "--qat_lr", "1e-3", "--batch_size",
                   "2", "--loss", "hybrid", "--no_test"]
            snapshot = P.join(t["port_train"], "state_0002.pkl")
            out["port_qat"] = entrance.main(qat + [
                "--pretrain", snapshot, "--suffix", "pq"])[0]
            out["jax_qat"] = jentrance.main(qat + [
                "--pretrain", snapshot, "--suffix", "jq"])
    finally:
        os.chdir(cwd)
    return out


def test_train_fp_matches_jax(training_missions):
    """The same files; loss.txt within rtol 1e-5 (measured 6.2e-7); the
    final snapshot's weights and BN state within 5e-6 (measured 9.5e-7);
    the final test's metrics within 1e-4 (measured equal)."""
    port, jax_ = training_missions["port_train"], training_missions["jax_train"]
    assert _files(port) == _files(jax_)
    assert {"description.txt", "loss.txt", "seg_metric.txt",
            "state_0002.pkl", "state_FP.npz", "seg_0002/val_seg.txt",
            "seg_0002/test_seg.txt"} <= set(_files(port))
    rows = [[ln.split(",") for ln in _lines(s, "loss.txt")]
            for s in (port, jax_)]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]] == ["1", "2"]
    np.testing.assert_allclose([float(r[1]) for r in rows[0]],
                               [float(r[1]) for r in rows[1]], rtol=1e-5)
    sd_p, sd_j = (_state(s, "state_0002.pkl") for s in (port, jax_))
    assert set(sd_p) == set(sd_j)
    for k in sd_j:
        np.testing.assert_allclose(sd_p[k], sd_j[k], atol=5e-6, err_msg=k)
    for split in ("val", "test"):
        a, b = (_dsc_rows(P.join(s, "seg_0002", f"{split}_seg.txt"))
                for s in (port, jax_))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4)


def test_ptq_qat_matches_jax(qat_missions):
    """Both packages' ``ptq --qat_epochs 1`` on the port's training
    snapshot: qat_loss.txt in JAX's format with one kept mark, both val
    dice within 0.03 and epoch 1's loss within rtol 2e-2, and exports
    whose kernels are on their grids with codes equal on at least 0.97.
    Measured: dice 0.0095 and 0.0102 apart, loss 5.4e-3, codes 0.9844.
    The gap is the calibration's, not the fine-tune's: on this tiny net
    the two packages' ADMM, chaotic at rounding level (ROADMAP queue 3),
    give codes equal on 0.9844 from the same weights; the fine-tune step
    itself is held tightly in tests/test_torch_port_qat.py.  This parity
    holds only against JAX with its train loader given its own dataset
    (``_own_train_dataset``): unpatched, JAX's QAT trains on whole volumes
    (test_qat_train_loader_departs_from_unpatched_jax)."""
    import re

    port, jax_ = qat_missions["port_qat"], qat_missions["jax_qat"]
    pat = re.compile(r"^epoch (0 \(pure PTQ\): val_dice|1: loss "
                     r"\S+ val_dice) (\d+\.\d{6})(  <- kept)?$")
    got = [[pat.match(ln) for ln in _lines(s, "qat/qat_loss.txt")]
           for s in (port, jax_)]
    for ms in got:
        assert len(ms) == 2 and all(ms)
        assert sum(bool(m.group(3)) for m in ms) == 1
    for i in (0, 1):
        np.testing.assert_allclose(float(got[0][i].group(2)),
                                   float(got[1][i].group(2)), atol=0.03)
    loss = [float(_lines(s, "qat/qat_loss.txt")[1].split()[3])
            for s in (port, jax_)]
    np.testing.assert_allclose(loss[0], loss[1], rtol=2e-2)
    sd_p, sd_j = (_state(s, "state_in_int8.pkl") for s in (port, jax_))
    grids = sd_p["__qlvl_overrides__"]
    agree = total = 0
    for name, (qlvl_w, _) in grids.items():
        key = f"{name}.weight"
        if qlvl_w <= 0 or sd_p[key].dtype != np.uint8:
            continue
        assert int(sd_p[key].max()) <= qlvl_w - 1
        agree += int((sd_p[key] == sd_j[key]).sum())
        total += sd_p[key].size
    assert total and agree / total >= 0.97, agree / total
    # the fp-valued export is the snapped grid itself
    fp = _state(port, "state_in_fp.pkl")
    for name, (qlvl_w, _) in grids.items():
        if qlvl_w > 0 and f"{name}.alpha_w" in fp:
            w = fp[f"{name}.weight"] / fp[f"{name}.alpha_w"]
            codes = (w + 1) * (qlvl_w - 1) / 2
            np.testing.assert_allclose(codes, np.round(codes), atol=1e-4)


def test_qat_train_loader_departs_from_unpatched_jax(training_missions):
    """The port's deliberate departure from the JAX package: after the
    calibration switches the train-seq dataset to its fixed transform,
    unpatched JAX's train loader gives whole volumes, while the port's,
    and JAX's under ``_own_train_dataset``, keep cropping patches."""
    from efficientq_tpu.cli import definer as jdefiner

    t = training_missions
    argv = ["ptq", *_data_args(t["data_dir"], t["split_dir"]),
            "--batch_size", "2"]
    shapes = {}
    for name, parse, cube in (
            ("port", entrance.build_parser, definer.get_data_cube),
            ("jax", jentrance.build_parser, jdefiner.get_data_cube),
            ("jax_own", jentrance.build_parser,
             _own_train_dataset(jdefiner.get_data_cube))):
        hub = cube(parse().parse_args(argv))[0]
        hub.trainseqloader.dataset.use_fix_transform()
        shapes[name] = tuple(next(iter(hub.trainloader))[0].shape[-3:])
    assert shapes == {"port": (16, 16, 16), "jax": VOL,
                      "jax_own": (16, 16, 16)}


def test_training_snapshots_interchange(training_missions, tmp_path):
    """Each package reads the other's training snapshot to the same
    weights as the writer's own reader; a snapshot whose optimizer state
    names classes that cannot be imported (JAX's optax state where optax
    is absent) still loads its state_dict."""
    from efficientq_tpu.cli import definer as jdefiner
    from efficientq_tpu.models import build_uresq as jbuild

    args = jentrance.build_parser().parse_args(
        ["train_fp", "--task", "lits", *TINY_MODEL])
    graph = build_uresq(definer.get_model_config(args)[0])
    jg = jbuild(jdefiner.get_model_config(args)[0])
    for snap in (training_missions["port_train"],
                 training_missions["jax_train"]):
        path = P.join(snap, "state_0002.pkl")
        ours = torch_io.load_torch_checkpoint(
            graph, nnir.init(graph, 1, device="cpu"), path)
        theirs = jtorch_io.load_torch_checkpoint(
            jg, jnnir.init(jg, jax.random.PRNGKey(1)), path)
        for group in ("params", "state"):
            for node, entries in ours[group].items():
                for k, t in entries.items():
                    np.testing.assert_array_equal(
                        t.numpy(), np.asarray(theirs[group][node][k]))
    with open(P.join(training_missions["port_train"], "state_0002.pkl"),
              "rb") as f:
        payload = pickle.load(f)
    # the optimizer state as an object of a module that is gone by the
    # time the snapshot is read
    import types

    mod = types.ModuleType("effq_absent_module")

    class Absent:
        pass

    Absent.__module__, Absent.__qualname__ = mod.__name__, "Absent"
    mod.Absent = Absent
    sys.modules[mod.__name__] = mod
    try:
        payload["opt_state"] = Absent()
        path = str(tmp_path / "foreign.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    finally:
        del sys.modules[mod.__name__]
    got = torch_io.load_torch_checkpoint(
        graph, nnir.init(graph, 1, device="cpu"), path)
    want = torch_io.load_torch_state_dict(
        graph, nnir.init(graph, 1, device="cpu"), payload["state_dict"])
    for node, entries in want["params"].items():
        for k, t in entries.items():
            assert torch.equal(got["params"][node][k], t)
