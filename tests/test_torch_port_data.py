"""The port's data layer against the JAX package's: transforms (the 3-D
fixed part; the random ones are in tests/test_torch_port_train.py),
splits, datasets and loaders, ``DataHub``'s loaders, ``device_feed`` and
``PrefetchLoader`` on the CPU, the NIfTI reader and writer, and the flat
YAML reader of the CLI.

Everything here is host-side NumPy in both packages, so the comparisons
are exact: the same files give the same batches bit for bit, and each
package reads the other's NIfTI files.
"""
import glob
import os.path as P
import pickle

import numpy as np
import pytest
import torch
import yaml

from efficientq_tpu.data import datahub as jdatahub
from efficientq_tpu.data import datasets as jdatasets
from efficientq_tpu.data import splits as jsplits
from efficientq_tpu.data import synthetic as jsynth
from efficientq_tpu.data import transforms as JT
from efficientq_tpu.utils import nifti as jnifti
from efficientq_tpu_torch.cli import entrance
from efficientq_tpu_torch.data import datahub, datasets, prefetch, splits
from efficientq_tpu_torch.data import labels
from efficientq_tpu_torch.data import transforms as T
from efficientq_tpu_torch.utils import nifti

REPO = P.dirname(P.dirname(P.abspath(__file__)))


def _pair(seed, c=2, shape=(12, 14, 10), multilabel=False):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((c, *shape)).astype(np.float32)
    label = rng.integers(0, 3, size=shape).astype(np.uint8)
    if multilabel:
        label = labels.split_label_lits(label).astype(np.float32)
    return img, label


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


FIXED = [
    ("ToArray", lambda M: M.ToArray()),
    ("Normalize-list", lambda M: M.Normalize([0.5, -1.0], [2.0, 0.25])),
    ("Normalize-scalar", lambda M: M.Normalize(0.5, 2.0)),
    ("Normalize-none", lambda M: M.Normalize()),
    ("Lambda", lambda M: M.Lambda(lambda i, l: (i * 2, l + 1))),
    ("Compose", lambda M: M.Compose([M.ToArray(), M.Normalize(0.5, 2.0),
                                     M.Lambda(lambda i, l: (i[::-1], l))])),
]


@pytest.mark.parametrize("multilabel", [False, True])
@pytest.mark.parametrize("name,make", FIXED, ids=[n for n, _ in FIXED])
def test_fixed_transforms_match_jax(name, make, multilabel):
    img, label = _pair(1, multilabel=multilabel)
    _equal(make(T)(img.copy(), label.copy()), make(JT)(img, label))


@pytest.mark.parametrize("size", [(4, 4, 4), (20, 9, 11), 6])
def test_crop_helpers_match_jax(size):
    img, _ = _pair(2)
    _equal([T.center_crop(img, size)], [JT.center_crop(img, size)])
    for loc in [(0, 0, 0, 4, 4, 4), (-3, 2, 8, 5, 9, 12),
                (9, 10, 1, 14, 16, 7)]:
        _equal([T.crop(img, loc)], [JT.crop(img, loc)])
    for sp, ep, n in [(-3, 5, 10), (6, 12, 10), (2, 7, 10)]:
        assert T.crop_size_correct(sp, ep, n) == \
            JT.crop_size_correct(sp, ep, n)


def test_splits_match_jax(tmp_path):
    files = [f"s{i:03d}" for i in range(23)]
    for nums in ([0.5, 0.25, 0.25], [3, 1], [1, 1, 1, 1]):
        assert splits.random_split(files, nums, seed=4) == \
            jsplits.random_split(files, nums, seed=4)
    for rounds, n in ((5, 3), (4, 2)):
        assert splits.cross_validation_random_split(files, rounds, n, 1) == \
            jsplits.cross_validation_random_split(files, rounds, n, 1)
    sp = splits.random_split(files, [2, 1, 1], seed=0)
    splits.write_split_files(str(tmp_path / "a"), 2, sp)
    jsplits.write_split_files(str(tmp_path / "b"), 2, sp)
    for name in ("train", "val", "test"):
        a = (tmp_path / "a" / "round2" / f"{name}.txt").read_text()
        assert a == (tmp_path / "b" / "round2" / f"{name}.txt").read_text()
    assert splits.list_join(["a"], ["b", "c"]) == ["a", "b", "c"]


@pytest.fixture(scope="module")
def brats_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    data_dir, split_dir = jsynth.make_synthetic_dataset(
        root, task="brats", n_subjects=5, vol_shape=(12, 16, 16),
        access_type="npz")
    with open(P.join(data_dir, "meanstd.txt"), "w") as f:
        f.write("mean 0.1 0.2 0.3 0.4\nstd 1.0 2.0 0.5 1.5\n")
    return data_dir, split_dir


def _hub(module, data_dir, split_dir, **kw):
    r = P.join(split_dir, "round1")
    return module.DataHub(
        data_dir, ("seg", "flair", "t1", "t1ce", "t2"),
        train_split=P.join(r, "train.txt"), val_split=P.join(r, "val.txt"),
        test_split=P.join(r, "test.txt"),
        true_test_split=P.join(r, "true_test.txt"), test_batchsize=1,
        access_type="npz", sn_fn_file="sn_fn.txt",
        slide_patch_size=(8, 8, 8), slide_overlap=(2, 2, 2),
        tfm_lambda=lambda img, label: (img, labels.split_label_brats(label)),
        **kw)


@pytest.mark.parametrize("on_disk", [False, True])
def test_datahub_matches_jax(brats_set, on_disk):
    """The same files give the same batches bit for bit from every loader
    the missions read (the shuffled train loader with its random flips,
    from the same seed; train-seq with the fixed transform, the
    calibration's; val, test, true-test), and the same subject lists and
    sn -> file map."""
    ours = _hub(datahub, *brats_set, on_disk=on_disk)
    theirs = _hub(jdatahub, *brats_set, on_disk=on_disk, num_workers=0)
    for attr in ("train_sn", "val_sn", "test_sn", "true_test_sn",
                 "sn_to_fn_map", "slide_patch_size", "slide_overlap"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    for _ in range(2):
        for (a, la), (b, lb) in zip(ours.trainloader, theirs.trainloader,
                                    strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
    ours.trainseqloader.dataset.use_fix_transform()
    theirs.trainseqloader.dataset.use_fix_transform()
    for name in ("valloader", "testloader", "true_test_image_loader",
                 "trainseqloader"):
        a = list(getattr(ours, name))
        b = list(getattr(theirs, name))
        assert len(a) == len(b) > 0, name
        for x, y in zip(a, b):
            _equal(x, y)


@pytest.mark.parametrize("access", ["npy", "npz", "memmap"])
def test_accessors_and_datasets_match_jax(access, tmp_path):
    rng = np.random.default_rng(0)
    shapes = {}
    for sn in ("b", "a", "c"):
        for mod, dt in (("seg", np.uint8), ("ct", np.float32)):
            arr = (rng.integers(0, 3, (4, 5, 6)) if mod == "seg"
                   else rng.standard_normal((4, 5, 6))).astype(dt)
            d = tmp_path / mod
            d.mkdir(exist_ok=True)
            if access == "npy":
                np.save(d / f"{sn}.npy", arr)
            elif access == "npz":
                np.savez_compressed(d / f"{sn}.npz", arr)
            else:
                arr.tofile(d / f"{sn}.dat")
            shapes[sn] = arr.shape
    with open(tmp_path / "shapes.pickle", "wb") as f:
        pickle.dump(shapes, f)
    (tmp_path / "split.txt").write_text("b\na\nc\n")
    split = str(tmp_path / "split.txt")
    assert datasets.read_split(split) == jdatasets.read_split(split)
    for DS, JDS in ((datasets.SegDataset, jdatasets.SegDataset),
                    (datasets.SegDatasetOnDisk, jdatasets.SegDatasetOnDisk)):
        mods = ("seg", "ct")
        ours, theirs = (DS(str(tmp_path), split, mods, access),
                        JDS(str(tmp_path), split, mods, access))
        assert ours.sn_list == theirs.sn_list and len(ours) == len(theirs)
        for i in range(len(ours)):
            _equal(ours[i], theirs[i])
        for shuffle, drop in ((False, False), (True, False), (True, True)):
            a = datasets.Loader(ours, 2, shuffle, drop, seed=3)
            b = jdatasets.Loader(theirs, 2, shuffle, drop, seed=3)
            assert len(a) == len(b)
            for epoch in range(2):
                ba, bb = list(a), list(b)
                assert len(ba) == len(bb)
                for x, y in zip(ba, bb):
                    _equal(x, y)
    with pytest.raises(ValueError):
        datasets.get_accessor("zip", str(tmp_path))


def test_device_feed_on_cpu_gives_host_batches_in_order():
    batches = [np.random.rand(2, 3, 4).astype(np.float32) if i % 2 else
               np.arange(i, i + 3, dtype=np.uint8) for i in range(4)]
    got = list(prefetch.device_feed(batches, device="cpu"))
    assert len(got) == 4
    for x, a in zip(got, batches):
        assert isinstance(x, torch.Tensor)
        assert x.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(x.numpy(), a)
    assert list(prefetch.device_feed([], device="cpu")) == []
    with pytest.raises(NotImplementedError, match="item 9"):
        next(prefetch.device_feed(batches, mesh=object()))


def test_device_feed_and_prefetch_carry_tuples():
    """The train loader's (image, label) items: device_feed gives them back
    as tuples of tensors, in order, behind a PrefetchLoader as well; the
    queue re-raises a loader's error in the consumer."""
    items = [(np.full((2, 1, 3), i, np.float32), np.arange(i, i + 2))
             for i in range(5)]
    feed = prefetch.device_feed(prefetch.PrefetchLoader(items, depth=2),
                                device="cpu")
    got = list(feed)
    assert len(got) == 5
    for (x, y), (a, b) in zip(got, items):
        np.testing.assert_array_equal(x.numpy(), a)
        np.testing.assert_array_equal(y.numpy(), b)

    def broken():
        yield items[0]
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(prefetch.PrefetchLoader(broken()))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.int32,
                                   np.float32, np.float64])
def test_nifti_round_trip_both_ways(dtype, tmp_path):
    rng = np.random.default_rng(1)
    vol = (rng.random((5, 6, 7)) * 100).astype(dtype)
    affine = np.diag([1.5, 2.0, 0.5, 1.0])
    affine[:3, 3] = [3.0, -1.0, 2.0]
    for gz in (".nii.gz", ".nii"):
        mine, theirs = str(tmp_path / f"p{gz}"), str(tmp_path / f"j{gz}")
        nifti.save_nifti(mine, vol, affine)
        jnifti.save_nifti(theirs, vol, affine)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            if gz == ".nii":
                assert a.read() == b.read()
        for reader in (nifti.load_nifti, jnifti.load_nifti):
            for path in (mine, theirs):
                img = reader(path)
                assert np.asarray(img.dataobj).dtype == dtype
                np.testing.assert_array_equal(np.asarray(img.dataobj), vol)
                np.testing.assert_allclose(img.affine, affine)


def test_nifti_default_affine_and_float_fallback(tmp_path):
    vol = np.arange(24, dtype=np.int64).reshape(2, 3, 4)
    nifti.save_nifti(str(tmp_path / "a.nii.gz"), vol)
    img = jnifti.load_nifti(str(tmp_path / "a.nii.gz"))
    assert np.asarray(img.dataobj).dtype == np.float32
    np.testing.assert_array_equal(img.get_fdata(), vol)
    np.testing.assert_array_equal(img.affine, np.eye(4))


@pytest.mark.parametrize("path", sorted(glob.glob(P.join(REPO, "config",
                                                         "*.yaml"))),
                         ids=P.basename)
def test_flat_yaml_reader_matches_safe_load(path):
    with open(path) as f:
        assert entrance.read_flat_yaml(path) == yaml.safe_load(f)


def test_flat_yaml_reader_scalars_match_safe_load(tmp_path):
    lines = ["a: 1", "b: -0.5", "c: 1e3", "d: 1.5e-3", "e: true",
             "f: Off", "g: ~", "h:", "l: 128,128,64",
             "m: 'quoted # not a comment'",
             "n: plain  # comment", "o: .inf", "p: -.5", "q: yes",
             "r: \"x\"", "s: 0", "t: +3"]
    p = tmp_path / "c.yaml"
    p.write_text("# head\n\n" + "\n".join(lines) + "\n")
    assert entrance.read_flat_yaml(str(p)) == yaml.safe_load(p.read_text())
    # YAML 1.1's binary, octal, hex and grouped ints stay strings
    p.write_text("i: 0x1F\nj: 010\nk: 1_000\nm: 0b11\n")
    assert entrance.read_flat_yaml(str(p)) == \
        {"i": "0x1F", "j": "010", "k": "1_000", "m": "0b11"}
    (tmp_path / "bad.yaml").write_text("nested:\n  key: 1\n")
    with pytest.raises(ValueError, match="flat"):
        entrance.read_flat_yaml(str(tmp_path / "bad.yaml"))


def test_merge_config_without_pyyaml(monkeypatch, tmp_path):
    import builtins

    real = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError(name)
        return real(name, *a, **k)

    cfg = tmp_path / "c.yaml"
    cfg.write_text("task: lits\nbatch_size: 7\nunset_key:\nhetero_dim: true\n")
    args = entrance.build_parser().parse_args(
        ["ptq", "--task", "brats", "--batch_size", "2"])
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    args = entrance.merge_config(str(cfg), args)
    assert (args.task, args.batch_size, args.hetero_dim) == ("lits", 7, True)
    assert not hasattr(args, "unset_key")
