"""The control fails the check: the plain reference with TF32 allowed,
put in the program's place, reads over a limit on every seed.  At the
cells' own sizes this is ``python3 -m bench_torch.control``; here on
smaller volumes of the same network, on the card."""
import pytest
import torch

from bench_torch import check, control, run as harness

from . import tiny

SMALLER = {"lits_w4a4.serve_fixed_depth": dict(volume=[160, 160, 64], pool=2),
           "lits_w4a4.serve_varied_depth": dict(base=[160, 160],
                                                depths=[96, 64])}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALLER))
def test_tf32_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.Cell(cell, tiny.ROOT)
    mix = dict(c.mix, check_every=2, **SMALLER[cell])
    limits = {**c.cfg["limits"], **c.mix.get("limits", {})}
    for seed in (101, 102, 103):
        worst = control.control_readings(c.cfg, mix, seed,
                                         torch.device("cuda"), served=2)
        correct, checks = check.judge(worst, limits)
        assert not correct, (seed, checks)
