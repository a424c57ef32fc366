"""What the exact check rests on: the stem's float32 sums over the
12-bit intensities are exact in any order, and the intensities have more
significant bits than TF32 keeps, so the TF32 control moves the stem."""
import json
import os.path as P

import pytest
import torch

from bench_torch import model, traffic

from . import tiny


def lits_cfg():
    with open(P.join(tiny.BENCH, "configs", "lits_uresq_w4a4.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 987654321])
def test_stem_sums_are_exact_in_float32(seed):
    cfg = lits_cfg()
    sd = model.make_weights(cfg, seed, torch.device("cpu"))
    w, b = sd["conv0.conv.weight"].double(), sd["conv0.conv.bias"].double()
    unit = float(sd["conv0.conv.alpha_w"]) / 255  # the kernel's grid step
    assert torch.equal(torch.round(w / unit) * unit, w)
    # every partial sum of 27 taps over |x| <= 2, and the bias, in units
    # of the products' grid, stays below 2^24: exact in float32
    step = unit / traffic.GRID
    most = (w.abs().sum(dim=(1, 2, 3, 4)) * 2 + b.abs()).max() / step
    assert float(most) < 2 ** 24
    assert torch.equal(torch.round(b / step) * step, b)


def test_intensities_have_more_bits_than_tf32_keeps():
    img = traffic.make_volume(1, (64, 64, 32), 2 ** 31 + 3,
                              torch.device("cpu"))
    ints = (img * traffic.GRID).to(torch.int64).flatten().tolist()
    assert all(-2 * traffic.GRID <= v < 2 * traffic.GRID for v in ints)

    def bits(v):
        v = abs(v)
        return 0 if v == 0 else v.bit_length() - (v & -v).bit_length() + 1

    # a share of the organ's voxels (|x| >= 1/2), where the stem's
    # outputs gather 27 of them each
    organ = [v for v in ints if abs(v) >= traffic.GRID // 2]
    assert sum(bits(v) > 11 for v in organ) > 0.02 * len(organ)


def test_tf32_rounding_keeps_11_significant_bits():
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, -(1 + 3 * 2 ** -11),
                      4095 / 2048, 2047 / 1024, 0.0, -3.0])
    want = torch.tensor([1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 * 2 ** -10),
                         2.0, 2047 / 1024, 0.0, -3.0])
    assert torch.equal(model.to_tf32(x), want)
