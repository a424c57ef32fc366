"""The count arithmetic and the reading of a trace."""
import json
import os.path as P

import pytest

from bench_torch import costs
from bench_torch.trace import Trace, union

BENCH = P.dirname(P.dirname(P.abspath(__file__)))


def config(name):
    with open(P.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


# the BraTS preset's network at its patch (no cell serves it yet: PERF.md)
BRATS = dict(config("lits_uresq_w4a4"), name="brats_uresq_w4a4",
             num_mod=4, widths=[32, 64, 128, 256, 128, 64, 32],
             depths=[1] * 7, init_stride=[2, 2, 2], patch=[128, 128, 128])


def test_k1_operations_of_one_brats_patch():
    cfg = BRATS
    k1 = [c for c in costs.served_convs(cfg) if c["k1"]]
    assert len(k1) == 14
    assert costs.k1_ops(cfg) == 105_092_481_024


def test_k1_operations_of_one_lits_patch():
    cfg = config("lits_uresq_w4a4")
    k1 = [c for c in costs.served_convs(cfg) if c["k1"]]
    assert len(k1) == 18
    assert costs.k1_ops(cfg) == 110_528_299_008


def test_served_convs_run_types():
    cfg = BRATS
    convs = costs.served_convs(cfg)
    kinds = {c["name"]: c["type"] for c in convs}
    assert kinds["conv0.conv"] == "float32"  # 256-level weights, float input
    assert kinds["final_cls.cls"] == "float32"
    assert kinds["trans_downs.TransDown1.block.conv"] == "float32"
    assert sum(t == "int8" for t in kinds.values()) == 14
    # the aux heads' classifiers run only when every head is served
    assert len(costs.served_convs(cfg, all_heads=True)) == len(convs) + 2
    stem = next(c for c in convs if c["name"] == "conv0.conv")
    assert stem["vox"] == 64 ** 3 and stem["ops"] == 2 * 64 ** 3 * 27 * 4 * 32


def test_k1_call_bytes_and_bound():
    # codes in, weights, scale and bias, codes out: each byte once
    flags = {"input_quantized": True, "epilogue_quant_for": "next"}
    assert costs.k1_call_bytes(10, 32, 32, flags) == (
        10 * 32 + 27 * 32 * 32 + 8 * 32 + 10 * 32)
    # float input, float output, a float residual and a pooled output
    flags = {"residual": True, "epilogue_pool": True}
    assert costs.k1_call_bytes(16, 8, 8, flags) == (
        16 * 8 * 4 + 27 * 64 + 64 + 16 * 8 * 4 + 16 * 8 * 4 + 2 * 8 * 4)
    t, by = costs.bound_s(3.35e12, 1.0, costs.INT8_OPS)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = costs.bound_s(1.0, 1979e12, costs.INT8_OPS)
    assert by == "operations" and t == pytest.approx(1.0)


def test_peak_seconds_are_linear_in_patches():
    cfg = config("lits_uresq_w4a4")
    one = costs.peak_s(cfg, 1)
    assert costs.peak_s(cfg, 8) == pytest.approx(8 * one)
    assert one == pytest.approx(
        sum(c["ops"] / costs.PEAK[c["type"]]
            for c in costs.served_convs(cfg)))


def test_idle_share_from_overlapping_kernel_and_copy_intervals():
    # a kernel 0-4 ms, a copy 2-6 ms under it, a memset 10-11 ms, a kernel
    # 10.5-12 ms: busy 6 + 2 = 8 ms of a 20 ms window
    ms = 1_000_000
    dev = [("kernel_a", 0, 4 * ms), ("Memcpy HtoD", 2 * ms, 6 * ms),
           ("Memset", 10 * ms, 11 * ms), ("kernel_b", 10.5 * ms, 12 * ms)]
    spans = [("bench.upload", 5 * ms, 9 * ms), ("bench.loader", 12 * ms,
                                                20 * ms)]
    tr = Trace(dev, spans, 0.020)
    assert union([(a, b) for _, a, b in dev]) == [[0, 6 * ms],
                                                   [10 * ms, 12 * ms]]
    assert tr.busy_s == pytest.approx(0.008)
    assert 100 * (1 - tr.busy_s / tr.window_s) == pytest.approx(60.0)
    assert tr.kernel_s("kernel_") == pytest.approx(0.0055)
    # the one gap inside the window (6-10 ms) lies under the upload span
    assert tr.idle_gaps() == [["bench.upload", pytest.approx(0.004)]]
    assert tr.top_ops()[0] == ["kernel_a", pytest.approx(0.004)]
