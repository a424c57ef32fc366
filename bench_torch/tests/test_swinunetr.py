"""The SwinUNETR cell at CPU sizes: its two reference copies agree, its
driver serves end to end with the keys the shared span readers read, its
cell resolves by name through ``run.Cell``, and the counts of its new
metrics (``window_heads``, K3's calls and bytes, the InstanceNorms'
elements) equal what the port's served graph does.  The test writes its
own CPU sizes into its copy of the benchmark (feature_size 12, heads 1, 2,
4, 8, 32^3 patches)."""
import importlib.util
import json
import os.path as P
import sys

import torch

from bench_torch import run as harness, swinunetr_model, traffic

from . import tiny
from .test_harness import run_line

CELL = "brats_swinunetr_w4a4.serve"
SMALL = dict(feature_size=12, num_heads=[1, 2, 4, 8], patch=[32, 32, 32],
             overlap=[8, 8, 8])
NEW = {"window_attention_roofline", "k3_roofline.swinunetr",
       "k1_roofline.swinunetr", "groupnorm_roofline.swinunetr",
       "serve_mfu.swinunetr"}


def _cfg():
    with open(P.join(tiny.BENCH, "configs",
                     "brats_swinunetr_w4a4.json")) as f:
        return dict(json.load(f), **SMALL)


def _small_copy(tmp_path):
    root, bench = tiny.make(tmp_path)
    with open(P.join(bench, "configs", "brats_swinunetr_w4a4.json"),
              "w") as f:
        json.dump(_cfg(), f)
    path = P.join(bench, "traffic", "stream_brats_study_swinunetr.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(volume=[40, 40, 40], pool=2, check_every=2)
    with open(path, "w") as f:
        json.dump(mix, f)
    return root, bench


def test_the_two_reference_copies_give_equal_logits():
    spec = importlib.util.spec_from_file_location(
        "swinunetr_reference",
        P.join(tiny.ROOT, "tests", "swinunetr_reference.py"))
    tests_copy = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = tests_copy  # its dataclass looks itself up
    try:
        spec.loader.exec_module(tests_copy)
    finally:
        del sys.modules[spec.name]
    cfg = _cfg()
    dev = torch.device("cpu")
    sd = swinunetr_model.make_weights(cfg, 2 ** 31 + 3, dev)
    x = traffic.make_volume(4, (32, 32, 32), 7, dev)[None]
    want = swinunetr_model.Reference(cfg, sd).forward(x)[0]
    assert torch.equal(tests_copy.Reference(cfg, sd).forward(x)[0], want)
    low = tests_copy.Reference(cfg, sd, tf32=True).forward(x)[0]
    assert torch.equal(
        swinunetr_model.Reference(cfg, sd, tf32=True).forward(x)[0], low)
    assert not torch.equal(low, want)


def test_the_cell_resolves_by_name(tmp_path):
    cell = harness.Cell(CELL, tiny.ROOT)
    assert cell.driver_path.endswith(P.join("drivers",
                                            "serve_swinunetr.py"))
    assert cell.cfg["model"] == "SwinUNETR"
    per_layer = {m["name"] for m in cell.metrics("per_layer")}
    assert NEW <= per_layer
    for name in per_layer:
        assert callable(cell.reader(name).read)
    assert {m["name"] for m in cell.metrics("end_to_end")} == {
        "volumes_per_s", "volume_p95_ms", "setup_s"}


def test_serve_swinunetr_runs_end_to_end(tmp_path):
    root, bench = _small_copy(tmp_path)
    line = run_line(root, bench, CELL)
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"volumes_per_s", "volume_p95_ms",
                                    "setup_s"}
    assert line["checks"]["max_gap"]["value"] <= 1e-5
    traced = run_line(root, bench, CELL, trace=1)
    assert traced["correct"] is True
    # on the CPU the port's spans are read; the readers of the device
    # trace and of the captured chunks (eager serving here) find nothing
    assert set(traced["metrics"]) == {"eager_patch_share.serve",
                                      "pipeline_stall_share.serve",
                                      "tail_device_share.serve"}


def test_counts_equal_what_the_served_chunk_does():
    from bench_torch import swinunetr_program
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.kernels import WRAPPERS, groupnorm
    from efficientq_tpu_torch.kernels import window_attention as wa
    from efficientq_tpu_torch.kernels.qmatmul import (
        fused_int8_matmul_reference)
    from efficientq_tpu_torch.ptq.deploy import serving_graph

    cfg = _cfg()
    dev = torch.device("cpu")
    sd = swinunetr_model.make_weights(cfg, 11, dev)
    dgraph, dvars = swinunetr_program.build(cfg, sd, dev)
    calls = []

    def k3(x, w, bias, *args, **kw):
        calls.append(swinunetr_model.k3_call_bytes(
            x.shape[0], x.shape[1], w.shape[1], bias is not None))
        return fused_int8_matmul_reference(x, w, bias, *args[:3], **kw)

    x = torch.stack([traffic.make_volume(4, (32, 32, 32), s, dev)
                     for s in (1, 2)]).permute(0, 2, 3, 4, 1)
    gn, heads = groupnorm.group_norm.elements, wa.window_attention.window_heads
    nnir.apply(serving_graph(dgraph), dvars, x.contiguous(),
               mode="quantized", heads=slice(-1, None),
               kernels=WRAPPERS._replace(int8_matmul=k3))
    assert wa.window_attention.window_heads - heads == (
        2 * swinunetr_model.window_heads(cfg))
    assert groupnorm.group_norm.elements - gn == 2 * sum(
        n for n, _ in swinunetr_model.instance_norm_elements(cfg))
    layers = [c for c in swinunetr_model.served_layers(cfg)
              if c["kernel"] == "k3"]
    assert len(calls) == len(layers) == 46
    assert sum(calls) == sum(swinunetr_model.k3_call_bytes(
        2 * c["rows"], c["cin"], c["cout"], c["bias"]) for c in layers)
    flags = swinunetr_program.k1_flags(dgraph)
    assert sorted(flags) == sorted(
        c["name"] for c in swinunetr_model.served_layers(cfg)
        if c["kernel"] == "k1")
    assert len(flags) == 19
