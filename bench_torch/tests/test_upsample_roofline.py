"""``upsample_roofline``: the bytes of a LiTS patch's served upsamples, and
the same reading whichever kernel, aten's or K5, did the work."""
import json
import os.path as P

import pytest

from bench_torch import costs, run as harness
from bench_torch.trace import Trace

BENCH = P.dirname(P.dirname(P.abspath(__file__)))


def _metric():
    return harness.load_module(P.join(BENCH, "metrics",
                                      "upsample_roofline.py"),
                               "metric_upsample_roofline")


def _lits():
    with open(P.join(BENCH, "configs", "lits_uresq_w4a4.json")) as f:
        return json.load(f)


def test_lits_patch_upsample_elements():
    """TransUp5-8 read 256, 128, 64 and 32 channels at 4^3-32^3 and write
    them at 8^3-64^3; the head reads 3 classes at 64^3 and writes them at
    128 x 128 x 64: 2,179,072 elements read and 14,286,848 written."""
    m = _metric()
    assert m.patch_elements(_lits()) == 2_179_072 + 14_286_848


@pytest.mark.parametrize("name", [
    "void at::native::(anonymous namespace)::upsample_trilinear3d_out_frame"
    "<float, float>(int, float, float, float, bool, "
    "at::GenericPackedTensorAccessor<float const, 5ul>)",
    "void (anonymous namespace)::effq_upsample_trilinear3d_ndhwc<float, "
    "float, float, 4>(float const*, float const*, float*, K5Call)"])
def test_reads_the_same_for_aten_and_k5(name):
    m = _metric()
    cfg = _lits()
    chunks = [8, 8, 8, 3]
    least = 4 * m.patch_elements(cfg) * sum(chunks) / costs.HBM_BPS
    # the kernel took 4x its least time, split over two launches, beside
    # another kernel the metric must not count
    device = [(name, 0, int(2e9 * least)),
              (name, int(3e9 * least), int(5e9 * least)),
              ("qconv3d_int8_kernel", 0, int(1e9))]
    out = {"trace": Trace(device, [], 1.0), "chunks": chunks, "cfg": cfg}
    assert m.read(out) == pytest.approx(25.0, rel=1e-6)
    out["trace"] = Trace(device[2:], [], 1.0)
    assert m.read(out) is None
