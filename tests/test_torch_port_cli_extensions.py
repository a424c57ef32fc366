"""The port's PTQ extension flags (``--lwq_select``, ``--mixed_frac``,
``--tail_alpha_sweep``, ``--tune_act``, ``--act_offset``,
``--lwq_granularity block``, and the sub-4-bit recipe's flags together)
against the JAX package's, on the tiny model of tests/test_cli_e2e.py, on
the CPU (``EFFQ_PLATFORM=cpu``): each runs in both packages on an
8-subject set, with the same artifact files, JAX's line formats, the same
lifted layers, ``act_k`` entries and scored iterations; ``infer --deploy
int8`` serves the mixed export.  The rest of the CLI is held in
tests/test_torch_port_cli.py, whose helpers this file shares.
"""
import os
import os.path as P
import re

import numpy as np
import pytest

from efficientq_tpu.cli import entrance as jentrance
from efficientq_tpu.data.synthetic import make_synthetic_dataset
from efficientq_tpu_torch.cli import definer, entrance
from efficientq_tpu_torch.models import build_uresq
from efficientq_tpu_torch.ptq import engine
from test_torch_port_cli import (QUANT, TINY_MODEL, VOL, _data_args,
                                 _dsc_rows, _files, _lines, _losses,
                                 _random_pretrain, _state)

EXTENSIONS = {
    "lwq_select": ["--lwq_select", "2"],
    "mixed_frac": ["--mixed_frac", "0.25"],
    "tail_alpha_sweep": ["--tail_alpha_sweep", "--tail_alpha_factors",
                         "1.0,1.7"],
    "tune_act": ["--tune_act", "3"],
    "act_offset": ["--act_offset", "1", "--act_offset_scope", "all"],
    "lwq_granularity_block": ["--lwq_granularity", "block"],
    # config/lits_ptq_sub4.yaml's knobs at the tiny width
    "recipe": ["--mixed_frac", "0.25", "--mixed_qlvl", "16",
               "--lwq_select", "4"],
}
# the files each extension adds to the snapshot, named as the JAX mission
# names them
EXTENSION_FILES = {
    "lwq_select": {"calib_select.txt"},
    "mixed_frac": {"mixed_upgraded.txt"},
    "tail_alpha_sweep": {"tail_alpha_sweep.txt"},
    "tune_act": {"tune_act_loss.txt", "tune_act_score.txt"},
    "act_offset": set(),
    "lwq_granularity_block": set(),
    "recipe": {"calib_select.txt", "mixed_upgraded.txt"},
}


@pytest.fixture(scope="module")
def extension_missions(tmp_path_factory):
    """``ptq`` with each extension in both packages (calibration at 10
    ADMM iterations a layer, no final test), on 8 subjects (train 4, val 2,
    test 2: the recipe's --lwq_select 4 takes 4 train volumes), then the
    port's ``infer --deploy int8`` on the recipe's export."""
    root = str(tmp_path_factory.mktemp("port_cli_ext"))
    data_dir, split_dir = make_synthetic_dataset(
        root, task="lits", n_subjects=8, vol_shape=VOL)
    ckpt = P.join(root, "pretrain.pkl")
    _random_pretrain(ckpt)
    cwd = os.getcwd()
    os.chdir(root)
    saved = os.environ.get("EFFQ_PLATFORM")
    os.environ["EFFQ_PLATFORM"] = "cpu"
    out = {}
    try:
        base = ["ptq", *_data_args(data_dir, split_dir), "--pretrain", ckpt,
                "--lwq_patchsz", "32,32,32", "--lwq_iter", "10", "--no_test"]
        for name, flags in EXTENSIONS.items():
            out[name] = (
                entrance.main(base + flags + ["--suffix", f"p_{name}"])[0],
                jentrance.main(base + flags + ["--suffix", f"j_{name}"]))
        out["infer"] = entrance.main(
            ["infer", *_data_args(data_dir, split_dir), "--deploy", "int8",
             "--pretrain", P.join(out["recipe"][0], "state_in_int8.pkl"),
             "--suffix", "recipe"])[0]
    finally:
        os.chdir(cwd)
        if saved is None:
            os.environ.pop("EFFQ_PLATFORM", None)
        else:
            os.environ["EFFQ_PLATFORM"] = saved
    return out


@pytest.mark.parametrize("name", sorted(EXTENSIONS))
def test_ptq_extension_runs_like_jax(extension_missions, name):
    """The port runs each extension where it refused it before: the same
    artifact files as the JAX mission's run of the same command, the
    extension's own files in JAX's line formats, finite layer losses."""
    port, jax_ = extension_missions[name]
    assert _files(port) == _files(jax_)
    base = set(_files(extension_missions["lwq_granularity_block"][1]))
    assert set(_files(port)) - base == EXTENSION_FILES[name]
    losses = _losses(port)
    assert [n for n, _ in losses] == [n for n, _ in _losses(jax_)]
    assert all(np.isfinite(v) for _, v in losses)
    if "calib_select.txt" in EXTENSION_FILES[name]:
        pat = re.compile(r"^candidate (\d+): train-volume dice "
                         r"(\d+\.\d{6})(  <- picked)?$")
        lines = _lines(port, "calib_select.txt")
        assert len(lines) == len(_lines(jax_, "calib_select.txt")) == \
            int(EXTENSIONS[name][EXTENSIONS[name].index("--lwq_select") + 1])
        assert all(pat.match(ln) for ln in lines)
        assert [int(pat.match(ln).group(1)) for ln in lines] == \
            list(range(len(lines)))
        assert sum(ln.endswith("<- picked") for ln in lines) == 1
    if "mixed_upgraded.txt" in EXTENSION_FILES[name]:
        # 10 weight-quantized layers at 0.25: the two tail convs
        lifted = _lines(port, "mixed_upgraded.txt")
        assert lifted == _lines(jax_, "mixed_upgraded.txt")
        assert lifted == engine.tail_sensitive_convs(
            build_uresq(definer.get_model_config(
                entrance.build_parser().parse_args(
                    ["ptq", "--task", "lits", *QUANT, *TINY_MODEL]))[0]))
        sd = _state(port, "state_in_int8.pkl")
        for layer in lifted:
            assert tuple(sd["__qlvl_overrides__"][layer]) == (16, 16)
            assert int(sd[f"{layer}.weight"].max()) <= 15
    if name == "tail_alpha_sweep":
        lines = _lines(port, "tail_alpha_sweep.txt")
        pat = re.compile(r"^x(\d+\.\d+): dice (\d+\.\d{6})(  <- kept)?$")
        assert [pat.match(ln).group(1) for ln in lines] == \
            [pat.match(ln).group(1)
             for ln in _lines(jax_, "tail_alpha_sweep.txt")] == ["1.0", "1.7"]
        assert sum(ln.endswith("<- kept") for ln in lines) == 1
    if name == "tune_act":
        assert len(_lines(port, "tune_act_loss.txt")) == 3
        assert all(np.isfinite(float(v))
                   for v in _lines(port, "tune_act_loss.txt"))
        pat = re.compile(r"^iter (\d+): dice (\d+\.\d{6})(  <- kept)?$")
        its = [pat.match(ln).group(1)
               for ln in _lines(port, "tune_act_score.txt")]
        assert its == [pat.match(ln).group(1) for ln in
                       _lines(jax_, "tune_act_score.txt")] == ["0", "3"]
    if name == "act_offset":
        sd_p, sd_j = (_state(s, "state_in_fp.pkl") for s in (port, jax_))
        keys = sorted(k for k in sd_p if k.endswith(".act_k"))
        assert keys and keys == sorted(k for k in sd_j if k.endswith(".act_k"))
        assert all(sd_p[k].dtype == np.int32 for k in keys)


def test_infer_serves_the_mixed_export(extension_missions):
    """``infer --deploy int8`` on the recipe's export (16-level lifted
    layers beside 4-level ones): its metric files, finite."""
    snap = extension_missions["infer"]
    for split in ("val", "test"):
        rows = _dsc_rows(P.join(snap, "infer", f"{split}_seg.txt"))
        assert rows and all(np.isfinite(v) for r in rows.values() for v in r)
