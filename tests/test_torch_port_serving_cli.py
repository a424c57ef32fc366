"""The serving flags of the port's CLI (``--export_artifact``,
``--export_column_depth``, ``--artifact``, ``--serve_grid column``,
``--tune_serving``) against the JAX package's CLI, on the tiny model and
the synthetic LiTS set of tests/test_torch_port_cli.py, on the CPU
(``EFFQ_PLATFORM=cpu``).

- ``infer --export_artifact`` then ``infer --artifact`` (the direct, the
  column and the s2d artifact): the artifact run's metric files equal the
  run that exported it, text for text (the s2d artifact emits a float32
  head where the s2d run keeps bfloat16 through the stitch: its
  predictions agree on >= 99.9 % of voxels, the JAX package's level for
  bf16 reduction order).
- ``ptq --export_artifact`` in both packages: the manifests are equal but
  for ``format`` and ``platforms``.
- ``infer --serve_grid column`` in both packages: the predictions agree
  and the metrics are equal where they do (tests/test_torch_port_cli.py's
  level: >= 99.99 % of voxels).
- ``--tune_serving force`` runs (on the CPU the autotuner returns JAX's
  default, 2 patches a forward, without measuring).
- ``infer --artifact`` refuses a patch, task, modality or class count
  other than the manifest's, and an artifact of another platform.
"""
import json
import os
import os.path as P
import zipfile

import numpy as np
import pytest

from efficientq_tpu.cli import entrance as jentrance
from efficientq_tpu.data.synthetic import make_synthetic_dataset
from efficientq_tpu_torch import export
from efficientq_tpu_torch.cli import entrance
from efficientq_tpu_torch.utils.nifti import load_nifti
from test_torch_port_cli import (_data_args, _dsc_rows, _random_pretrain,
                                 _serving_agrees)

VOL = (32, 32, 32)


def _run(main, argv):
    out = main(argv)
    return out[0] if isinstance(out, tuple) else out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serving_cli"))
    data_dir, split_dir = make_synthetic_dataset(
        root, task="lits", n_subjects=4, vol_shape=VOL)
    ckpt = P.join(root, "pretrain.pkl")
    _random_pretrain(ckpt)
    cwd = os.getcwd()
    os.chdir(root)
    saved = {k: os.environ.get(k) for k in ("EFFQ_PLATFORM",
                                            "EFFQ_TUNE_CACHE")}
    os.environ["EFFQ_PLATFORM"] = "cpu"
    os.environ["EFFQ_TUNE_CACHE"] = P.join(root, "tune.json")
    try:
        base = _data_args(data_dir, split_dir)
        ptq = ["ptq", *base, "--pretrain", ckpt, "--lwq_patchsz", "32,32,32",
               "--lwq_iter", "20", "--export_artifact", "--no_test"]
        out = {"port_ptq": _run(entrance.main, ptq + ["--suffix", "port"]),
               "jax_ptq": _run(jentrance.main, ptq + ["--suffix", "jax"]),
               "base": base, "root": root}
        infer = ["infer", *base, "--deploy", "int8", "--save_nii",
                 "--pretrain", P.join(out["jax_ptq"], "state_in_int8.pkl")]
        for name, flags in (
                ("exported", ["--export_artifact"]),
                ("column", ["--serve_grid", "column", "--export_artifact",
                            "--export_column_depth", "32"]),
                # the s2d stem needs a 3^3 stride-2 init conv: the same
                # weights at init stride 2,2,2
                ("s2d", ["--serve_stem", "s2d", "--export_artifact",
                         "--init_stride", "2,2,2"]),
                ("column_plain", ["--serve_grid", "column"]),
                ("force", ["--tune_serving", "force"])):
            out[name] = _run(entrance.main, infer + flags + ["--suffix",
                                                             name])
        out["jax_column"] = _run(jentrance.main, infer + [
            "--serve_grid", "column", "--suffix", "jax_column"])
        for name, zipname in (("exported", "serving_artifact.zip"),
                              ("column", "serving_artifact.zip"),
                              ("s2d", "serving_artifact_s2d.zip")):
            out[f"{name}_artifact"] = _run(entrance.main, [
                "infer", *base, "--save_nii", "--init_stride",
                "2,2,2" if name == "s2d" else "2,2,1", "--artifact",
                P.join(out[name], zipname), "--suffix", f"{name}_art"])
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def _text(snap, split):
    """A metric file's final-head section (an artifact emits only it)."""
    with open(P.join(snap, "infer", f"{split}_seg.txt")) as f:
        return f.read().split("Output -2:")[0]


@pytest.mark.parametrize("name", ["exported", "column"])
def test_artifact_serves_what_its_run_served(runs, name):
    for split in ("val", "test"):
        assert _text(runs[f"{name}_artifact"], split) == \
            _text(runs[name], split)
        assert _dsc_rows(P.join(runs[name], "infer", f"{split}_seg.txt"))
    assert _text(runs["column_plain"], "val") == _text(runs["column"], "val")


def test_s2d_artifact_agrees_with_the_s2d_run(runs):
    with zipfile.ZipFile(P.join(runs["s2d"],
                                "serving_artifact_s2d.zip")) as z:
        m = json.loads(z.read("manifest.json"))
    assert (m["serve_stem"], m["channels_first"], m["serve_dtype"]) == \
        ("s2d", True, "bf16")
    assert m["stem_geometry"]["stride"] == [2, 2, 2]
    assert P.isfile(P.join(runs["s2d"], "serving_artifact.zip"))
    for split in ("val", "test"):
        rows = _dsc_rows(P.join(runs["s2d_artifact"], "infer",
                                f"{split}_seg.txt"))
        assert rows and all(np.isfinite(v) for r in rows.values() for v in r)
        for sn in rows:
            a, b = (np.asarray(load_nifti(P.join(
                runs[k], "infer", split, f"{sn}.nii.gz")).dataobj)
                for k in ("s2d_artifact", "s2d"))
            assert a.shape == b.shape == VOL
            assert np.mean(a == b) >= 0.999


def test_ptq_manifests_match_jax(runs):
    def manifest(snap):
        with zipfile.ZipFile(P.join(snap, "serving_artifact.zip")) as z:
            return json.loads(z.read("manifest.json"))

    port, jax_ = manifest(runs["port_ptq"]), manifest(runs["jax_ptq"])
    assert port.pop("format") == export.FORMAT
    assert jax_.pop("format") == export.JAX_FORMAT
    assert port.pop("platforms") == ["cpu"]
    jax_.pop("platforms")
    assert port == jax_
    assert port["batch"] == "symbolic" and port["task"] == "lits"


def test_column_metric_files_match_jax(runs):
    _serving_agrees(runs["column_plain"], runs["jax_column"])
    with zipfile.ZipFile(P.join(runs["column"],
                                "serving_artifact.zip")) as z:
        m = json.loads(z.read("manifest.json"))
    assert (m["serve_grid"], m["column_depth"]) == ("column", 32)
    assert m["patch_size"][0] == 32 and m["overlap"][0] == 0


def test_tune_serving_force_runs(runs):
    for split in ("val", "test"):
        assert _text(runs["force"], split) == _text(runs["exported"], split)
    assert not P.exists(P.join(runs["root"], "tune.json"))  # no sweep


def _rewrite(src, dst, **changes):
    with zipfile.ZipFile(src) as z:
        manifest = json.loads(z.read(export.MANIFEST_NAME))
        module = z.read(export.MODULE_NAME)
    manifest.update(changes)
    with zipfile.ZipFile(dst, "w") as z:
        z.writestr(export.MANIFEST_NAME, json.dumps(manifest))
        z.writestr(export.MODULE_NAME, module)
    return dst


@pytest.mark.parametrize("flags,changes,error,match", [
    (["--patch_size", "8,8,8"], {}, ValueError, "does not match"),
    (["--nClass", "4"], {}, ValueError, "n_class=3"),
    (["--nMod", "2"], {}, ValueError, "n_mod=1"),
    ([], {"task": "brats"}, ValueError, "task='brats'"),
    ([], {"platforms": ["cuda"]}, RuntimeError, "exported for"),
], ids=["patch", "n_class", "n_mod", "task", "platform"])
def test_artifact_gates(runs, flags, changes, error, match, monkeypatch,
                        tmp_path):
    monkeypatch.setenv("EFFQ_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    path = _rewrite(P.join(runs["exported"], "serving_artifact.zip"),
                    str(tmp_path / "a.zip"), **changes)
    argv = ["infer", *runs["base"], "--artifact", path, *flags]
    with pytest.raises(error, match=match):
        entrance.main(argv)
    assert not os.path.exists(tmp_path / "exp_infer")


def test_column_export_needs_a_depth(runs, monkeypatch, tmp_path):
    monkeypatch.setenv("EFFQ_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="--export_column_depth"):
        entrance.main(["infer", *runs["base"], "--deploy", "int8",
                       "--serve_grid", "column", "--export_artifact",
                       "--pretrain", P.join(runs["jax_ptq"],
                                            "state_in_int8.pkl")])
