"""The SegResNet cell at CPU sizes: its two reference copies agree, its
driver serves end to end, and ``groupnorm_roofline``'s bytes count what
the port's GroupNorm nodes normalize.  The test writes its own CPU sizes
into its copy of the benchmark (init_filters 8, 32^3 patches)."""
import importlib.util
import json
import os.path as P
import sys

import torch

from bench_torch import run as harness, segresnet_model, traffic

from . import tiny
from .test_harness import run_line

CELL = "brats_segresnet_w4a4.serve"
SMALL = dict(init_filters=8, patch=[32, 32, 32], overlap=[8, 8, 8])


def _cfg():
    with open(P.join(tiny.BENCH, "configs", "brats_segresnet_w4a4.json")) as f:
        return dict(json.load(f), **SMALL)


def _small_copy(tmp_path):
    root, bench = tiny.make(tmp_path)
    with open(P.join(bench, "configs", "brats_segresnet_w4a4.json"),
              "w") as f:
        json.dump(_cfg(), f)
    path = P.join(bench, "traffic", "stream_brats_study.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(volume=[40, 40, 40], pool=2, check_every=2)
    with open(path, "w") as f:
        json.dump(mix, f)
    return root, bench


def test_the_two_reference_copies_give_equal_logits():
    spec = importlib.util.spec_from_file_location(
        "segresnet_reference",
        P.join(tiny.ROOT, "tests", "segresnet_reference.py"))
    tests_copy = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = tests_copy  # its dataclass looks itself up
    try:
        spec.loader.exec_module(tests_copy)
    finally:
        del sys.modules[spec.name]
    cfg = _cfg()
    dev = torch.device("cpu")
    sd = segresnet_model.make_weights(cfg, 2 ** 31 + 3, dev)
    x = traffic.make_volume(4, (32, 32, 32), 7, dev)[None]
    want = segresnet_model.Reference(cfg, sd).forward(x)[0]
    assert torch.equal(tests_copy.Reference(cfg, sd).forward(x)[0], want)
    low = tests_copy.Reference(cfg, sd, tf32=True).forward(x)[0]
    assert torch.equal(
        segresnet_model.Reference(cfg, sd, tf32=True).forward(x)[0], low)
    assert not torch.equal(low, want)


def test_serve_segresnet_runs_end_to_end(tmp_path):
    root, bench = _small_copy(tmp_path)
    line = run_line(root, bench, CELL)
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"volumes_per_s", "volume_p95_ms",
                                    "setup_s"}
    assert line["checks"]["max_gap"]["value"] == 0.0
    traced = run_line(root, bench, CELL, trace=1)
    assert traced["correct"] is True
    # on the CPU the port's spans are read; the readers of the device
    # trace and of the captured chunks (eager serving here) find nothing
    assert set(traced["metrics"]) == {"eager_patch_share.serve",
                                      "pipeline_stall_share.serve",
                                      "tail_device_share.serve"}
    cell = harness.Cell(CELL, root, bench)
    assert {m["name"] for m in cell.metrics("per_layer")} >= {
        "serve_mfu.segresnet", "groupnorm_roofline",
        "k1_roofline.segresnet", "upsample_roofline.segresnet",
        "device_idle_share.serve"}


def test_groupnorm_bytes_count_what_the_nodes_normalize():
    from bench_torch import segresnet_program
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.kernels import groupnorm
    from efficientq_tpu_torch.ptq.deploy import serving_graph

    cfg = _cfg()
    dev = torch.device("cpu")
    sd = segresnet_model.make_weights(cfg, 11, dev)
    dgraph, dvars = segresnet_program.build(cfg, sd, dev)
    served = serving_graph(dgraph)
    x = torch.stack([traffic.make_volume(4, (32, 32, 32), s, dev)
                     for s in (1, 2, 3)]).permute(0, 2, 3, 4, 1)
    before = groupnorm.group_norm.elements
    nnir.apply(served, dvars, x.contiguous(), mode="quantized",
               heads=slice(-1, None))
    counted = groupnorm.group_norm.elements - before
    elements = segresnet_model.group_norm_elements(cfg)
    assert counted == 3 * sum(n for n, _ in elements)
    # the output bytes an element of each GroupNorm as the graph serves it
    k6 = [n for n in served.nodes if n.op == "group_norm_k6"]
    assert [n.name for n in k6] == [name for name, _, _ in
                                    segresnet_model.group_norms(cfg)]
    assert [1 if n.attrs.get("quant_for") else 4 for n in k6] == \
        [out for _, out in elements]
    assert segresnet_model.group_norm_bytes(cfg) == sum(
        n * (4 + out) for n, out in elements)


def _served(seed):
    from bench_torch import segresnet_program

    cfg = _cfg()
    dev = torch.device("cpu")
    sd = segresnet_model.make_weights(cfg, seed, dev)
    return cfg, segresnet_program.build(cfg, sd, dev)


def test_k1_flags_are_the_served_graphs_and_k1_reads_codes():
    from bench_torch import segresnet_program

    cfg, (dgraph, _) = _served(13)
    flags = segresnet_program.k1_flags(dgraph)
    names = [c["name"] for c in segresnet_model.served_convs(cfg)
             if c["k1"]]
    assert sorted(flags) == sorted(names) and len(names) == 24
    # K6 hands every ResBlock conv its codes; conv2 adds the block's input
    assert all(f["input_quantized"] for f in flags.values())
    assert all(bool(f["residual"]) == n.endswith("conv2.conv")
               for n, f in flags.items())
    assert not any(f["epilogue_quant_for"] or f["epilogue_pool"]
                   for f in flags.values())
    # by hand, over 3 patches of 32^3: int8 codes in, int8 weights,
    # float32 scale and bias, float32 out, float32 residual of conv2
    patches, want = 3, 0.0
    for n in names:
        group, i = n.split(".")[:2]
        level = int(i) if group == "down_layers" else 2 - int(i)
        ch, vox = 8 * 2 ** level, patches * (32 >> level) ** 3
        nbytes = vox * ch + 27 * ch * ch + 8 * ch + vox * ch * 4
        if n.endswith("conv2.conv"):
            nbytes += vox * ch * 4
        want += max(nbytes / 3.35e12, 2 * vox * 27 * ch * ch / 1979e12)
    got = segresnet_model.k1_least_s(cfg, flags, patches)
    assert abs(got - want) <= 1e-12 * want


def test_upsample_elements_count_what_the_served_upsamples_move():
    from efficientq_tpu_torch import nnir
    from efficientq_tpu_torch.kernels.upsample import (
        upsample_trilinear3d_reference)
    from efficientq_tpu_torch.ptq.deploy import serving_graph

    cfg, (dgraph, dvars) = _served(17)
    moved = []

    def counted(x, scale_factor, skip=None, channels_first=False):
        y = upsample_trilinear3d_reference(x, scale_factor, skip,
                                           channels_first)
        moved.append(x.numel() + y.numel())
        return y

    x = torch.stack([traffic.make_volume(4, (32, 32, 32), s, torch.device(
        "cpu")) for s in (4, 5)]).permute(0, 2, 3, 4, 1)
    nnir.apply(serving_graph(dgraph), dvars, x.contiguous(),
               mode="quantized", heads=slice(-1, None), upsample=counted)
    assert len(moved) == 3
    assert sum(moved) == 2 * segresnet_model.upsample_elements(cfg)
